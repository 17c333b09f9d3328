"""The port's chunked multi-round engine (``repro_torch.core.rounds``).

On the CPU every chunk runs eagerly, the code a captured chunk records on
the card.  Against the port's own per-round loop (``chunk=0``) the chunked
runner is bitwise equal wherever no client is flagged: the rounds run the
same operations in the same order and the boundary repair is a no-op.
With flagged clients the deferred contract differs from the loop (flags
persist to the chunk's end instead of one round), and the runs are held to
the reference's own scan-vs-loop bounds (tests/test_rounds.py
``_assert_bounded``) with exact queries.  Against the reference's scan
(``simulate(..., chunk=2)``) on its injected draws the bounds are those of
tests/test_torch_algorithms.py (F 1e-3, x 1e-2; FD 1e-5).

The card-only tests hold a captured chunk against the eager chunk on the
same draws (bit for bit, and every generator left in the same state,
where no client is flagged) and run one eager deferred chunk under
``torch.cuda.set_sync_debug_mode("error")``; they skip without a card.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as ralg
from repro.core import objectives as robj
from repro.core import rounds as rrounds
from repro_torch import convert
from repro_torch import faults
from repro_torch.checkpoint import io
from repro_torch.core import algorithms as alg
from repro_torch.core import gp_surrogate as gp
from repro_torch.core import graphs
from repro_torch.core import objectives as obj
from repro_torch.core import rounds

ROUNDS = 20
N_ = lambda a: np.asarray(a)


def _port_algorithms_tests():
    """tests/test_torch_algorithms.py, for its recorder of the reference's draws."""
    path = Path(__file__).resolve().parent / "test_torch_algorithms.py"
    spec = importlib.util.spec_from_file_location("_torch_algorithms_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TA = _port_algorithms_tests()
port64 = TA.port64  # the port in float64, the witness of TA.assert_tracks


def _fzoos_cfg(**kw):
    """tests/test_rounds.py's configuration."""
    base = dict(name="fzoos", dim=8, n_clients=4, local_steps=3, n_features=32,
                traj_capacity=32, active_per_iter=1, active_candidates=8, active_round_end=1,
                lengthscale=0.5)
    return alg.AlgoConfig(**dict(base, **kw))


FEDZO = dict(name="fedzo", dim=8, n_clients=4, q=2)


@pytest.fixture(scope="module")
def quad():
    return obj.make_quadratic(0, 4, 8, 2.0, 0.001, device="cpu")


def _sim(cfg, quad, rounds=ROUNDS, seed=5, **kw):
    return alg.simulate(cfg, seed, quad, obj.quadratic_query, obj.quadratic_global_value, rounds,
                        device="cpu", **kw)


def _assert_bitwise(a, b):
    """Every field of two histories bit for bit (NaN rows included)."""
    for field, x, y in zip(alg.SimResult._fields, a, b):
        assert x.dtype == y.dtype == torch.float32, field
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), field


def _assert_bounded(ref, new):
    """tests/test_rounds.py's scan-vs-loop bounds."""
    np.testing.assert_allclose(ref.xs[1].numpy(), new.xs[1].numpy(), atol=5e-2)
    np.testing.assert_allclose(ref.xs.numpy(), new.xs.numpy(), atol=0.1)
    np.testing.assert_allclose(ref.f_values.numpy(), new.f_values.numpy(), atol=5e-2)
    np.testing.assert_array_equal(ref.queries.numpy(), new.queries.numpy())
    assert np.isfinite(new.f_values.numpy()).all()


def record_chunk_starts(monkeypatch) -> list:
    """Every eager chunk that the round drivers run from now on records
    ``(its first round, its draw source's state())`` as it starts: the
    generator states its draws come from."""
    starts, real = [], rounds.chunk_fn

    def spy(cfg, rff, query_fn, cobjs, draws, *args, **kwargs):
        chunk = real(cfg, rff, query_fn, cobjs, draws, *args, **kwargs)

        def run(states, sx, offset):
            starts.append((int(offset), [s.clone() for s in draws.state()]))
            return chunk(states, sx, offset)

        return run

    monkeypatch.setattr(rounds, "chunk_fn", spy)
    return starts


def restarted_chunks(starts) -> list:
    """The rounds at which a chunk started twice: a rollback's re-runs."""
    seen = [r for r, _ in starts]
    return sorted({r for r in seen if seen.count(r) > 1})


def same_states(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("chunk", [8, 1])
def test_chunked_matches_loop_bitwise(quad, chunk):
    """Chunks of 8 (not dividing 20) and of 1 against the loop: no client
    is flagged, so the runs are the same operations, bit for bit."""
    cfg = _fzoos_cfg()
    loop = _sim(cfg, quad, chunk=0)
    assert loop.repair_rate.abs().max().item() == 0.0
    _assert_bitwise(loop, _sim(cfg, quad, chunk=chunk))


def _forced_flags(monkeypatch, events=(10, 40, 41, 90)):
    """Raise client 1's ``needs_repair`` at the given append events."""
    real = gp.factor_update_deferred
    calls = [0]

    def forced(*args, **kwargs):
        out = real(*args, **kwargs)
        calls[0] += 1
        if calls[0] in events:
            flag = torch.zeros_like(out.needs_repair)
            flag[1] = True
            out = out._replace(needs_repair=out.needs_repair | flag)
        return out

    monkeypatch.setattr(gp, "factor_update_deferred", forced)
    return calls


def test_flags_persist_to_the_chunk_boundary(quad, monkeypatch):
    """With client 1 flagged in rounds 2, 6 and 13, the loop repairs after
    each of those rounds, chunks of 8 at their ends (rounds 8 and 16), as
    the reference's scan does; the runs stay within the scan-vs-loop
    bounds with exact queries, and chunks of 1 are the loop bit for bit."""
    cfg = _fzoos_cfg()
    runs = {}
    for chunk in (0, 8, 1):
        calls = _forced_flags(monkeypatch)
        runs[chunk] = _sim(cfg, quad, chunk=chunk)
        assert calls[0] == ROUNDS * 7
    flagged = lambda res: [r + 1 for r, v in enumerate(res.repair_rate.tolist()) if v]
    assert flagged(runs[0]) == [2, 6, 13]
    assert flagged(runs[8]) == [2, 3, 4, 5, 6, 7, 8, 13, 14, 15, 16]
    _assert_bounded(runs[0], runs[8])
    _assert_bitwise(runs[0], runs[1])


def test_fedzo_chunked_matches_loop(quad):
    """The FD baseline in chunks of 7 against the loop, within the
    reference's bound for it (tests/test_rounds.py, 1e-5)."""
    cfg = alg.AlgoConfig(**dict(FEDZO, local_steps=3, q=8))
    loop, chunked = _sim(cfg, quad, chunk=0), _sim(cfg, quad, chunk=7)
    np.testing.assert_allclose(loop.xs.numpy(), chunked.xs.numpy(), atol=1e-5)
    np.testing.assert_allclose(loop.f_values.numpy(), chunked.f_values.numpy(), atol=1e-5)
    np.testing.assert_array_equal(loop.queries.numpy(), chunked.queries.numpy())


@pytest.fixture(scope="module")
def ref_quad():
    rq = robj.make_quadratic(jax.random.PRNGKey(0), TA.N, TA.D, 5.0, 0.001)
    return rq, convert.quadratic(jax.tree_util.tree_map(np.asarray, rq), "cpu")


@pytest.mark.parametrize("kw,f_tol,x_tol", [
    (TA.KW, TA.F_TOL, TA.X_TOL),
    (dict(TA.FD_KW, name="fedzo"), 1e-5, 1e-5),
], ids=["fzoos", "fedzo"])
def test_chunked_matches_reference_scan(ref_quad, port64, kw, f_tol, x_tol):
    """Five rounds in chunks of 2 (2, 2, 1), the port against the
    reference's scan on the reference's draws: the ring wraps, the
    boundary repairs run after rounds 2, 4 and 5 on both sides.  F and x
    are held with ``TA.assert_tracks``'s float64 witness: the float64
    port's run in the same chunks on the same draws."""
    rq, q = ref_quad
    rcfg, cfg = ralg.AlgoConfig(**kw), alg.AlgoConfig(**kw)
    key, n_rounds = jax.random.PRNGKey(3), 5
    want = ralg.simulate(rcfg, key, rq, robj.quadratic_query, robj.quadratic_global_value,
                         n_rounds, chunk=2)
    rec = TA._recorded_simulate_draws(cfg, key, n_rounds)
    rec64 = rec.widened()
    got = alg.simulate(cfg, 0, q, obj.quadratic_query, obj.quadratic_global_value, n_rounds,
                       draws=rec, chunk=2, device="cpu")
    assert rec.exhausted()

    @functools.cache
    def truth():
        o64 = port64.obj
        out = port64.alg.simulate(
            port64.alg.AlgoConfig(**kw), 0, port64.convert.quadratic(TA.wide(rq), "cpu"),
            o64.quadratic_query, o64.quadratic_global_value, n_rounds, draws=rec64, chunk=2,
            device="cpu")
        assert rec64.exhausted()
        return out

    np.testing.assert_array_equal(got.queries.numpy(), N_(want.queries))
    assert got.queries[-1].item() == n_rounds * cfg.queries_per_round()
    assert np.isfinite(got.f_values.numpy()).all()
    TA.assert_tracks(got.f_values, want.f_values, lambda: truth().f_values, f_tol, "F")
    TA.assert_tracks(got.xs, want.xs, lambda: truth().xs, x_tol, "x")


@pytest.mark.parametrize("key", [3, 4])
@pytest.mark.parametrize("chunk", [0, 2])
def test_twelve_rounds_against_float64(ref_quad, port64, key, chunk):
    """Twelve rounds of ``TA.KW`` on the reference's draws, in the loop and
    in chunks of 2, where the two packages were seen to part beyond x 1e-2
    (ROADMAP Queue C): each side's largest distance from the float64 port
    on the same draws is printed (``-s``), and the port is held to the
    reference by ``TA.assert_tracks`` with the bounds of the 5-round tests
    (F 1e-3, x 1e-2), the queries exactly."""
    rq, q = ref_quad
    rcfg, cfg = ralg.AlgoConfig(**TA.KW), alg.AlgoConfig(**TA.KW)
    n_rounds = 12
    want = ralg.simulate(rcfg, jax.random.PRNGKey(key), rq, robj.quadratic_query,
                         robj.quadratic_global_value, n_rounds, chunk=chunk)
    rec = TA._recorded_simulate_draws(cfg, jax.random.PRNGKey(key), n_rounds)
    rec64 = rec.widened()
    got = alg.simulate(cfg, 0, q, obj.quadratic_query, obj.quadratic_global_value, n_rounds,
                       draws=rec, chunk=chunk, device="cpu")
    truth = port64.alg.simulate(
        port64.alg.AlgoConfig(**TA.KW), 0, port64.convert.quadratic(TA.wide(rq), "cpu"),
        port64.obj.quadratic_query, port64.obj.quadratic_global_value, n_rounds, draws=rec64,
        chunk=chunk, device="cpu")
    assert rec.exhausted() and rec64.exhausted()
    for f in ("xs", "f_values"):
        t = getattr(truth, f).numpy()
        e_port = np.abs(getattr(got, f).numpy().astype(np.float64) - t).max()
        e_ref = np.abs(N_(getattr(want, f)).astype(np.float64) - t).max()
        print(f"key {key}, chunk {chunk}, {f}: from float64 port {e_port:.3e}, "
              f"reference {e_ref:.3e}")
    np.testing.assert_array_equal(got.queries.numpy(), N_(want.queries))
    TA.assert_tracks(got.f_values, want.f_values, lambda: truth.f_values, TA.F_TOL, "F")
    TA.assert_tracks(got.xs, want.xs, lambda: truth.xs, TA.X_TOL, "x")


def test_eval_every_nan_contract(quad):
    """eval_every=3 over 7 rounds in chunks of 3: F at rounds 0, 3, 6 and
    the last, NaN elsewhere; the evaluated rows, x and the queries are
    those of eval_every=1 bit for bit (tests/test_rounds.py's contract)."""
    cfg = alg.AlgoConfig(**dict(FEDZO, local_steps=1))
    every = _sim(cfg, quad, 7, seed=3, chunk=3)
    skip = _sim(cfg, quad, 7, seed=3, chunk=3, eval_every=3)
    f = skip.f_values.numpy()
    for r in range(8):
        if r in (0, 3, 6, 7):
            assert f[r] == every.f_values[r].item(), r
        else:
            assert np.isnan(f[r]), r
    assert torch.equal(every.xs, skip.xs) and torch.equal(every.queries, skip.queries)


def test_eval_every_matches_loop(quad):
    """The chunked runner's NaN rows and values are the loop's."""
    cfg = alg.AlgoConfig(**dict(FEDZO, local_steps=1))
    loop = _sim(cfg, quad, 5, seed=3, chunk=0, eval_every=2)
    chunked = _sim(cfg, quad, 5, seed=3, chunk=2, eval_every=2)
    np.testing.assert_array_equal(np.isnan(loop.f_values.numpy()),
                                  np.isnan(chunked.f_values.numpy()))
    _assert_bitwise(loop, chunked)


def test_history_shapes_and_initial_row(quad):
    """Row 0 holds x0 and F(x0); the per-round rows line up; the query
    counter rises by ``queries_per_round`` every round."""
    cfg = alg.AlgoConfig(**dict(FEDZO, local_steps=2, q=4))
    x0 = torch.full((8,), 0.25)
    res = _sim(cfg, quad, 5, seed=3, x0=x0, chunk=2)
    assert res.xs.shape == (6, 8) and res.f_values.shape == (6,)
    for field in alg.SimResult._fields[2:]:
        assert getattr(res, field).shape == (5,), field
    assert torch.equal(res.xs[0], x0)
    assert res.f_values[0].item() == obj.quadratic_global_value(quad, x0).item()
    np.testing.assert_array_equal(res.queries.numpy(),
                                  cfg.queries_per_round() * np.arange(1, 6, dtype=np.float32))
    empty = _sim(cfg, quad, 0, seed=3, x0=x0)
    assert empty.xs.shape == (1, 8) and empty.queries.shape == (0,)


@pytest.mark.parametrize("n_rounds,chunk,lengths", [
    (20, None, [16, 4]), (40, None, [16, 16, 8]), (3, 5, [3]), (7, 3, [3, 3, 1]),
])
def test_chunk_lengths(quad, monkeypatch, n_rounds, chunk, lengths):
    """``chunk=None`` runs chunks of ``DEFAULT_CHUNK`` = 16; a chunk longer
    than the run is clamped to it; the last chunk takes what is left."""
    made = []
    real = rounds.chunk_fn

    def spy(*args, **kwargs):
        made.append(args[7])
        return real(*args, **kwargs)

    monkeypatch.setattr(rounds, "chunk_fn", spy)
    cfg = alg.AlgoConfig(**dict(FEDZO, local_steps=1))
    res = _sim(cfg, quad, n_rounds, seed=3, chunk=chunk)
    assert rounds.DEFAULT_CHUNK == 16
    assert made == lengths
    assert res.queries.shape == (n_rounds,)
    assert res.queries[-1].item() == n_rounds * cfg.queries_per_round()


@pytest.mark.parametrize("call,match", [
    (dict(runner=True, chunk=0), "chunk"),
    (dict(runner=True, chunk=-1), "chunk"),
    (dict(runner=True, n_rounds=-1), "rounds"),
    (dict(runner=True, eval_every=0), "eval_every"),
    (dict(chunk=-8), "chunk"),
    (dict(eval_every=0), "eval_every"),
])
def test_bad_arguments_rejected(quad, call, match):
    """The reference's validations: ``run_rounds`` takes chunk >= 1,
    rounds >= 0 and eval_every >= 1; ``simulate`` rejects a negative
    chunk (it must not fall through to the loop) and eval_every < 1."""
    cfg = alg.AlgoConfig(**dict(FEDZO, local_steps=1))
    call = dict(call)
    runner, n_rounds = call.pop("runner", False), call.pop("n_rounds", 4)
    with pytest.raises(ValueError, match=match):
        if runner:
            x0 = torch.full((8,), 0.5)
            rounds.run_rounds(cfg, None, obj.quadratic_query, quad, alg.init_states(cfg, x0), x0,
                              obj.quadratic_global_value, n_rounds,
                              call.pop("chunk", 2), draws=alg.ClientDraws(0, range(4), "cpu"),
                              **call)
        else:
            _sim(cfg, quad, n_rounds, **call)


def test_boundary_repair_matches_reference(ref_quad):
    """The boundary's repair of clients 0 and 2, flagged on the reference's
    state after two rounds: the same flags, exactness and repair counts as
    the reference's host-read and device-gated boundaries, the repaired
    clients' clamped eigenvalues within 1e-5 and their clamped Gram within
    1e-4 of the reference's (f32 eigh of a Gram of scale 1), the other
    client's factor untouched."""
    rq, _ = ref_quad
    rcfg = ralg.AlgoConfig(**TA.KW)
    mean_fn = lambda tree: jax.tree_util.tree_map(lambda a: jnp.mean(a, axis=0), tree)
    x0 = jnp.full((TA.D,), 0.5, jnp.float32)
    bank = ralg.rfflib.make_rff(jax.random.PRNGKey(4), rcfg.n_features, TA.D, rcfg.lengthscale)
    rnd = jax.jit(lambda st, sx: ralg.run_round(rcfg, bank, robj.quadratic_query, rq, st, sx,
                                                mean_fn))
    st, stats = rnd(ralg.init_states(rcfg, jax.random.PRNGKey(5), x0), x0)
    st, _ = rnd(st, stats.server_x)
    flags = jnp.asarray([True, False, True])
    st = st._replace(factor=st.factor._replace(needs_repair=flags))
    host, n_ref = rrounds.repair_flagged_clients(st, rcfg)
    device = rrounds.boundary_repair_on_device(
        jax.tree_util.tree_map(jnp.copy, st), rcfg)
    pst = convert.client_state(jax.tree_util.tree_map(np.asarray, st), "cpu")
    got, n = rounds.repair_flagged_clients(pst, alg.AlgoConfig(**TA.KW))
    assert n == n_ref == 2
    for f in ("exact", "n_refactors", "needs_repair"):
        for want in (host, device):
            np.testing.assert_array_equal(getattr(got.factor, f).numpy(),
                                          N_(getattr(want.factor, f)), err_msg=f)
    for f in gp.GramFactor._fields:
        assert torch.equal(getattr(got.factor, f)[1], getattr(pst.factor, f)[1]), f
    for i in (0, 2):  # eigenvalues, and the clamped factors' Gram V diag(w) V^T
        recon = lambda v, w: (v * w[None, :]) @ v.T
        want_v, want_w = N_(host.factor.eigvecs[i]), N_(host.factor.eigvals[i])
        np.testing.assert_allclose(got.factor.eigvals[i].numpy(), want_w, atol=1e-5)
        np.testing.assert_allclose(recon(got.factor.eigvecs[i], got.factor.eigvals[i]).numpy(),
                                   recon(want_v, want_w), atol=1e-4)


def test_chol_solve_against_float64():
    """``gp.chol_solve``, two triangular solves, against the float64 solve
    of a padded trajectory Gram at the deferred engine's conditioning (a
    16-slot ring of points 1e-2 apart at l=0.5, jitter 1e-4): within the
    error of ``torch.cholesky_solve`` on the same f32 factor, plus 1e-6 of
    the solution's scale."""
    g = torch.Generator().manual_seed(0)
    xs = 0.5 + 0.01 * torch.randn(3, 16, 8, generator=g).cumsum(1) / 4
    tr = gp.Trajectory(xs, torch.randn(3, 16, generator=g), torch.tensor([16, 12, 5]))
    gram, _ = gp._padded_gram(tr, gp.GPHyper(0.5, 1e-4))
    chol = torch.linalg.cholesky(gram)
    b = torch.randn(3, 16, 4, generator=g)
    truth = torch.linalg.solve(gram.double(), b.double())
    ours = gp.chol_solve(chol, b)
    lib = torch.cholesky_solve(b, chol, upper=False)
    scale = truth.abs().max().item()
    err, lib_err = ((t - truth).abs().max().item() for t in (ours.double(), lib.double()))
    assert err <= lib_err + 1e-6 * scale, (err, lib_err, scale)
    eye = torch.eye(16).expand(3, 16, 16)
    inv = gp.chol_solve(chol, eye).double()
    inv_err = (inv - torch.linalg.inv(gram.double())).abs().max().item()
    lib_inv = torch.cholesky_solve(eye, chol, upper=False).double()
    lib_inv_err = (lib_inv - torch.linalg.inv(gram.double())).abs().max().item()
    assert inv_err <= lib_inv_err + 1e-6 * inv.abs().max().item(), (inv_err, lib_inv_err)


def test_copy_into_keeps_aliased_sources():
    """A source that is its destination is skipped; a source sharing
    storage with another destination is read before any copy."""
    a, b, c = torch.arange(3.0), torch.arange(3.0) + 10, torch.arange(3.0) + 20
    graphs.copy_into((a, b, c), (b, a, c))  # swap a and b, keep c
    assert a.tolist() == [10.0, 11.0, 12.0] and b.tolist() == [0.0, 1.0, 2.0]
    assert c.tolist() == [20.0, 21.0, 22.0]
    nested = (a, (b, None))
    graphs.copy_into(nested, (torch.zeros(3), (torch.ones(3), None)))
    assert a.tolist() == [0.0] * 3 and b.tolist() == [1.0] * 3


@pytest.mark.parametrize("engine", [
    dict(), dict(score_block_cap=8, grad_block_cap=8), dict(name="fedzo", q=2), "faulted",
], ids=["fzoos", "fzoos_tiled", "fedzo", "fzoos_faulted"])
def test_state_layout_is_kept_by_a_chunk(quad, engine):
    """Every leaf of ``init_states`` (the Cholesky factor's above all) has
    the strides that one eager chunk and its boundary leave it in, and so
    has a quarantined client's restart: a captured chunk's static buffers
    keep the initial layout while eager chunks chain the updated one, and
    an eager round's arithmetic follows its inputs' strides, so the two
    meet the same bits only where the layouts agree."""
    faulted = engine == "faulted"
    cfg = _fzoos_cfg(**({} if faulted else engine))
    schedule = (faults.FaultSchedule(faults.FaultConfig(seed=3, nan_rate=0.5), 4, 4)
                if faulted else None)
    x0 = torch.full((8,), 0.5)
    draws = alg.ClientDraws(5, range(4), "cpu")
    rff = alg.rfflib.make_rff(draws, cfg.n_features, cfg.dim, cfg.lengthscale)
    init = alg.init_states(cfg, x0)
    chunk = rounds.chunk_fn(cfg, rff, obj.quadratic_query, quad, draws,
                            obj.quadratic_global_value, None, 2, 1, 4, faults=schedule)
    states, sx, _ = chunk(init, x0, torch.zeros((), dtype=torch.int64))
    states, _ = rounds.repair_flagged_clients(states, cfg)
    outs = [states]
    if faulted:
        assert bool(states.quarantined.any())
        outs.append(alg.make_quarantine_reset(cfg, "cpu")(states, sx))
    want = [t.stride() for t in io.tree_flatten(init)[0]]
    if cfg.name == "fzoos":  # row-major, as every update leaves it
        assert init.factor.chol.stride() == (32 * 32, 32, 1)
    for out in outs:
        assert [t.stride() for t in io.tree_flatten(out)[0]] == want


@pytest.mark.parametrize("engine,device,captured", [
    (dict(), "cuda", True),
    (dict(rff_fit_exact=True), "cuda", True),
    (dict(name="fedzo"), "cuda", True),
    (dict(name="scaffold1"), "cuda", True),
    (dict(defer_repair=False), "cuda", False),
    (dict(use_factor_cache=False), "cuda", False),
    (dict(), "cpu", False),
    (dict(name="fedzo"), "cpu", False),
])
def test_capture_rule(engine, device, captured):
    """Which chunks capture: the deferred engine and the FD baselines on a
    CUDA device drawing from ``ClientDraws``; never another draw source
    (recorded, or replayed from another device), never the CPU."""
    cfg = _fzoos_cfg(**engine)
    draws = alg.ClientDraws.__new__(alg.ClientDraws)  # no generator: only the type is read
    assert graphs.captures(cfg, draws, torch.device(device)) is captured
    assert graphs.captures(cfg, TA.RecordedDraws(), torch.device(device)) is False

    class Subclass(alg.ClientDraws):
        pass

    assert graphs.captures(cfg, Subclass.__new__(Subclass), torch.device(device)) is False


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: chunks are captured only on the card")
    return torch.device("cuda")


class _EagerDraws(alg.ClientDraws):
    """``ClientDraws`` under another type: the same generators and numbers,
    and by the capture rule an eager chunk."""


def _gen_states(draws) -> list:
    return [g.get_state() for g in (*draws.gens, draws.bank_gen)]


def assert_captured_matches_eager(eager, captured, eager_draws, captured_draws):
    """A captured run against the eager run on the same draws.  Where no
    client was flagged in either run, the two are the same operations on
    the same numbers: bit for bit, and every generator of the draw source
    left in the same state (the replays drew what the eager chunks drew).
    With flagged clients, the scan-vs-loop bounds."""
    same = all(torch.equal(a, b) for a, b in zip(captured, eager))
    print(f"bitwise equal {same}, max|dF| "
          f"{(captured.f_values - eager.f_values).abs().max().item():.3e}")
    for a, b in zip(_gen_states(eager_draws), _gen_states(captured_draws)):
        assert torch.equal(a, b)
    if eager.repair_rate.abs().max().item() == 0 == captured.repair_rate.abs().max().item():
        assert same
    else:
        _assert_bounded(_to_cpu(eager), _to_cpu(captured))


@pytest.mark.parametrize("name", ["fzoos", "fzoos_tiled", "fedzo", "fedprox", "scaffold1",
                                  "scaffold2"])
def test_cuda_captured_chunk_matches_eager(quad, name):
    """Five rounds in chunks of 2 (two captures, three replays) against the
    eager chunks on the same draws (``assert_captured_matches_eager``).
    ``fzoos_tiled`` pins cap tiles of 8, so the cap-tiled scoring (with its
    f64 work buffer) and gradient run inside the graph; the FD baselines
    capture their control variates (scaffold1, scaffold2) and scaffold2's
    direction bank."""
    dev = _cuda()
    cfg = (_fzoos_cfg(score_block_cap=8, grad_block_cap=8) if name == "fzoos_tiled"
           else _fzoos_cfg() if name == "fzoos"
           else alg.AlgoConfig(**dict(FEDZO, name=name, local_steps=3)))
    q = obj.make_quadratic(0, 4, 8, 2.0, 0.001, device=dev)
    sim = lambda draws: alg.simulate(cfg, 5, q, obj.quadratic_query, obj.quadratic_global_value,
                                     5, draws=draws, chunk=2, device=dev)
    graphs.COUNTS.update(captures=0, replays=0)
    captured_draws, eager_draws = alg.ClientDraws(5, range(4), dev), _EagerDraws(5, range(4), dev)
    captured = sim(captured_draws)
    assert graphs.COUNTS == {"captures": 2, "replays": 3}
    eager = sim(eager_draws)
    assert graphs.COUNTS == {"captures": 2, "replays": 3}
    print(f"captured vs eager ({name}): ", end="")
    assert_captured_matches_eager(eager, captured, eager_draws, captured_draws)


def _to_cpu(res):
    return alg.SimResult(*(t.cpu() for t in res))


def test_cuda_eager_deferred_chunk_has_no_host_sync():
    """One eager chunk of two rounds of the deferred engine at the small
    size issues no synchronizing call: what capture needs of its body."""
    dev = _cuda()
    cfg = _fzoos_cfg()
    q = obj.make_quadratic(0, 4, 8, 2.0, 0.001, device=dev)
    draws = alg.ClientDraws(5, range(4), dev)
    x0 = torch.full((8,), 0.5, device=dev)
    rff = alg.rfflib.make_rff(draws, cfg.n_features, cfg.dim, cfg.lengthscale)
    states = alg.init_states(cfg, x0)
    chunk = rounds.chunk_fn(cfg, rff, obj.quadratic_query, q, draws,
                            obj.quadratic_global_value, None, 2, 3, 10)
    offset = torch.zeros((), dtype=torch.int64, device=dev)
    chunk(states, x0, offset)  # first use: the library's handles and the kernels' build
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        states, sx, ys = chunk(states, x0, offset)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ys[0].shape == (2, 8) and torch.isfinite(sx).all()
