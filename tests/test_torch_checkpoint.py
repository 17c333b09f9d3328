"""The port's checkpoints (``repro_torch.checkpoint``) and the round
engine's resume (``repro_torch.core.rounds``).

The file format is the reference's (``repro.checkpoint.io``): a plain tree
of float32, int32, bool and bfloat16 arrays written by either package is
read by the other with the same bits, and both record the same per-leaf
checksums.  The integrity checks mirror the reference's tests
(tests/test_faults.py, tests/test_substrate.py,
tests/test_checkpoint_shard.py).

Resume: a run stopped after a checkpoint and resumed is bit for bit the
run that was not stopped (every history row, the final state in the last
step's file, and every generator's state), for the deferred FZooS engine,
the per-client engine and fedzo, in the reference's scenario
(tests/test_rounds.py: 12 rounds in chunks of 4, steps above 8 removed).
On the reference's own injected draws the port's resumed run tracks the
reference's resumed run within the engine bounds of
tests/test_torch_algorithms.py (F 1e-3, x 1e-2, exact queries).  The
card-only cases (skipped without a card) resume in captured chunks, and
load a generator state that a captured graph then replays.
"""

import functools
import importlib.util
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as rio
from repro.core import algorithms as ralg
from repro.core import objectives as robj
from repro.faults import corrupt as rcorrupt
from repro_torch import convert
from repro_torch.checkpoint import io
from repro_torch.core import algorithms as alg
from repro_torch.core import graphs
from repro_torch.core import objectives as obj
from repro_torch.core import rounds
from repro_torch.faults import corrupt

ROUNDS, CHUNK = 12, 4


def _port_tests(name):
    """Another test file of the port, for its helpers."""
    path = Path(__file__).resolve().parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_{name}_helpers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TA = _port_tests("test_torch_algorithms")
port64 = TA.port64  # the port in float64, the witness of TA.assert_tracks
TR = _port_tests("test_torch_rounds")


# ---------------------------------------------------------------------------
# The file format, against the reference
# ---------------------------------------------------------------------------


def _plain_tree():
    """Numpy arrays of every dtype a round state holds, plus bf16 bits, in
    dicts whose keys are not in sorted order and a list."""
    rng = np.random.default_rng(7)
    return {
        "w": rng.standard_normal((3, 5)).astype(np.float32),
        "b": {"step": np.int32(11) * np.ones((), np.int32),
              "count": rng.integers(-9, 9, (4,)).astype(np.int32),
              "flags": rng.random(6) > 0.5},
        "a": [rng.integers(0, 2**16, (2, 3)).astype(np.uint16),  # bf16 bits
              rng.standard_normal(7).astype(np.float32)],
    }


def _as_jax(tree):
    return {"w": jnp.asarray(tree["w"]),
            "b": {k: jnp.asarray(v) for k, v in tree["b"].items()},
            "a": [jnp.asarray(tree["a"][0].view(jnp.bfloat16)), jnp.asarray(tree["a"][1])]}


def _as_torch(tree):
    return {"w": torch.from_numpy(tree["w"]),
            "b": {k: torch.from_numpy(np.array(v)) for k, v in tree["b"].items()},
            "a": [torch.from_numpy(tree["a"][0].view(np.int16)).view(torch.bfloat16),
                  torch.from_numpy(tree["a"][1])]}


def _bits(leaf) -> tuple:
    """(dtype name, shape, raw bytes) of a JAX array or a tensor."""
    if torch.is_tensor(leaf):
        t = leaf.view(torch.int16) if leaf.dtype == torch.bfloat16 else leaf
        name = str(leaf.dtype).removeprefix("torch.")
        return name, tuple(leaf.shape), t.contiguous().numpy().tobytes()
    arr = np.asarray(leaf)
    return str(arr.dtype), arr.shape, np.ascontiguousarray(arr).tobytes()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_side_reads_the_others_file(tmp_path, writer):
    """A plain tree of float32, int32, bool and bf16 leaves written by one
    package is read by the other with the same dtypes, shapes and bits, and
    both write the same treedef-independent meta: leaf count, dtype tags
    and checksums."""
    tree = _plain_tree()
    if writer == "reference":
        rio.save(str(tmp_path), _as_jax(tree), step=3)
        got = io.restore(str(tmp_path), _as_torch(tree), step=3)
        want = _as_jax(tree)
    else:
        io.save(str(tmp_path), _as_torch(tree), step=3)
        got = rio.restore(str(tmp_path), _as_jax(tree), step=3)
        want = _as_torch(tree)
    got_leaves, want_leaves = io.tree_flatten(got)[0], jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves) == 6
    assert [_bits(g) for g in got_leaves] == [_bits(w) for w in want_leaves]
    assert io.latest_step(str(tmp_path)) == rio.latest_step(str(tmp_path)) == 3


def test_both_sides_record_the_same_checksums(tmp_path):
    tree = _plain_tree()
    rio.save(str(tmp_path / "ref"), _as_jax(tree), step=1, extra_meta={"k": 1})
    io.save(str(tmp_path / "port"), _as_torch(tree), step=1, extra_meta={"k": 1})
    ref, port = rio.load_meta(str(tmp_path / "ref"), 1), io.load_meta(str(tmp_path / "port"), 1)
    for key in ("n_leaves", "dtypes", "checksums", "step", "extra"):
        assert ref[key] == port[key], key
    assert port["dtypes"] == ["bfloat16", "float32", "int32", "bool", "int32", "float32"]


def _two_leaves():
    return {"a": torch.arange(512, dtype=torch.float32), "b": torch.ones((3, 2))}


def _truncated(root):
    corrupt.truncate_npz(root, 1)


def _flipped(root):
    corrupt.flip_bytes(root, 1, n_bytes=16)


def _missing_member(root):
    path = os.path.join(root, "step_00000001", "arrays.npz")
    data = dict(np.load(path))
    del data["leaf_1"]
    np.savez(path, **data)


def _bad_checksum(root):
    path = os.path.join(root, "step_00000001", "arrays.npz")
    data = dict(np.load(path))
    data["leaf_0"] = data["leaf_0"] + 1.0
    np.savez(path, **data)


@pytest.mark.parametrize("damage", [_truncated, _flipped, _missing_member, _bad_checksum],
                         ids=lambda f: f.__name__.strip("_"))
def test_corrupt_step_raises(tmp_path, damage):
    """A truncated ``arrays.npz``, flipped payload bytes, a missing member
    or a member whose content no longer matches its checksum raises
    ``CorruptCheckpointError`` (tests/test_faults.py:371-385)."""
    root = str(tmp_path)
    io.save(root, _two_leaves(), step=1)
    damage(root)
    with pytest.raises(io.CorruptCheckpointError):
        io.restore(root, _two_leaves(), step=1)


@pytest.mark.parametrize("template, match", [
    ({"a": torch.zeros(511), "b": torch.ones((3, 2))}, "shape mismatch"),
    ({"a": torch.zeros(512, dtype=torch.float64), "b": torch.ones((3, 2))}, "dtype mismatch"),
    ({"a": torch.zeros(512, dtype=torch.bfloat16), "b": torch.ones((3, 2))}, "dtype mismatch"),
    ({"a": torch.zeros(512)}, "leaves"),
])
def test_template_mismatch_raises(tmp_path, template, match):
    """Shape, dtype and leaf count are checked against the template
    (tests/test_substrate.py:152-170, tests/test_checkpoint_shard.py:69)."""
    io.save(str(tmp_path), _two_leaves(), step=1)
    with pytest.raises(ValueError, match=match):
        io.restore(str(tmp_path), template, step=1)


def test_tmp_step_is_never_listed_and_none_is_an_empty_node(tmp_path):
    """A torn write's ``step_N.tmp`` is never a step; the next save of that
    step clears it.  ``None`` (the SGD optimizer's state) holds no leaf, and
    restored tensors take the template's strides."""
    root = str(tmp_path)
    chol = torch.linalg.cholesky(torch.eye(4).expand(2, 4, 4) * 2.0)  # column-major
    tree = {"opt": None, "chol": chol, "step": torch.tensor(3, dtype=torch.int32)}
    io.save(root, tree, step=4)
    os.makedirs(os.path.join(root, "step_00000008.tmp"))
    assert io.list_steps(root) == [4] and io.latest_step(root) == 4
    assert io.load_meta(root, 4)["n_leaves"] == 2
    back = io.restore(root, tree, step=4)
    assert back["opt"] is None and back["chol"].stride() == chol.stride()
    assert torch.equal(back["chol"], chol) and back["step"].item() == 3
    io.save(root, tree, step=8)
    assert io.list_steps(root) == [4, 8]
    assert not os.path.exists(os.path.join(root, "step_00000008.tmp"))


def test_train_state_round_trip(tmp_path):
    """``save_train_state`` / ``restore_train_state``: the newest step by
    default, its metrics in ``extra``; an empty directory raises."""
    root = str(tmp_path)
    with pytest.raises(FileNotFoundError):
        io.restore_train_state(root, torch.zeros(3), None)
    params = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    adam = (torch.ones(2, 3), torch.zeros(2, 3), torch.tensor(7, dtype=torch.int32))
    io.save_train_state(root, 1, params * 0, adam)
    io.save_train_state(root, 2, params, adam, metrics={"loss": 0.5})
    got, opt, step = io.restore_train_state(root, torch.zeros(2, 3),
                                            tuple(torch.zeros_like(t) for t in adam))
    assert step == 2 and torch.equal(got, params) and io.load_meta(root, 2)["extra"] == {
        "loss": 0.5}
    assert all(torch.equal(a, b) for a, b in zip(opt, adam))


def test_async_writer_reraises_background_error():
    """A failing background write fails the run at the next submit, and the
    writer is usable again after (tests/test_checkpoint_shard.py:194)."""
    w = io.AsyncCheckpointWriter(backoff_s=0.001)
    hits = []
    w.submit(lambda: hits.append(1))
    w.wait()
    assert hits == [1]

    def boom():
        raise OSError("disk full")

    w.submit(boom)
    with pytest.raises(OSError, match="disk full"):
        w.submit(lambda: hits.append(2))
    w.submit(lambda: hits.append(3))
    w.wait()
    assert hits == [1, 3]
    w.submit(boom)
    with pytest.raises(OSError, match="disk full"):
        w.wait()


def test_unported_layouts_raise(tmp_path):
    """A step in the sharded layout names its item (A11); a client-pool
    step (ported with the pool) is refused by the round-state restore and
    names ``restore_pool_state``."""
    for layout, err, match in (("sharded-v1", NotImplementedError, "A11"),
                               ("pool-v1", ValueError, "restore_pool_state")):
        step = os.path.join(str(tmp_path), layout, "step_00000002")
        os.makedirs(step)
        with open(os.path.join(step, "meta.json"), "w") as f:
            f.write(f'{{"layout": "{layout}"}}')
        with pytest.raises(err, match=match):
            io.restore_round_state(os.path.dirname(step), {}, {})


@pytest.mark.parametrize("damage", ["truncate_npz", "flip_bytes"])
@pytest.mark.parametrize("layout", ["single", "pool"])
def test_corrupt_helpers_damage_like_the_reference(tmp_path, damage, layout):
    """The port's ``faults.corrupt`` and the reference's damage copies of
    one step alike, byte for byte (the same bytes cut or flipped), in the
    single-file layout and in the pool's per-shard one; the damaged step
    no longer restores."""
    src = str(tmp_path / "src")
    if layout == "single":
        io.save(src, _two_leaves(), step=1)
    else:
        hist = alg.SimResult(*(torch.arange(3.0) for _ in alg.SimResult._fields))
        leaves = [torch.arange(4096, dtype=torch.float32).reshape(8, 512)]
        io.write_round_state(src, 1, io.prepare_pool_state(leaves, "*", 0, 8, hist))
    roots = []
    for mod, name in ((corrupt, "port"), (rcorrupt, "ref")):
        root = str(tmp_path / name)
        shutil.copytree(src, root)
        paths = getattr(mod, damage)(root, 1)
        assert len(paths) == 1
        roots.append(paths[0])
    with open(roots[0], "rb") as a, open(roots[1], "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(io.CorruptCheckpointError):
        if layout == "single":
            io.restore(str(tmp_path / "port"), _two_leaves(), step=1)
        else:
            io.restore_pool_state(str(tmp_path / "port"), leaves, hist, step=1)


# ---------------------------------------------------------------------------
# Resume within the port
# ---------------------------------------------------------------------------


ENGINES = {
    "deferred": dict(),
    "per_client": dict(defer_repair=False),
    "fedzo": dict(name="fedzo", q=2),
}


@pytest.fixture(scope="module")
def quad():
    return obj.make_quadratic(0, 4, 8, 2.0, 0.001, device="cpu")


def _cfg(engine, **kw):
    return TR._fzoos_cfg(local_steps=2, **dict(ENGINES[engine], **kw))


def _run(cfg, quad, rounds=ROUNDS, seed=5, **kw):
    """``simulate`` on a fresh ``ClientDraws``; returns (result, draws)."""
    draws = alg.ClientDraws(seed, range(cfg.n_clients), "cpu")
    res = alg.simulate(cfg, seed, quad, obj.quadratic_query, obj.quadratic_global_value, rounds,
                       draws=draws, device="cpu", **kw)
    return res, draws


def _step_arrays(root, step):
    with np.load(os.path.join(root, f"step_{step:08d}", "arrays.npz")) as data:
        return {k: data[k].copy() for k in data.files}


def _assert_same_arrays(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert (a[k].dtype, a[k].shape, a[k].tobytes()) == (b[k].dtype, b[k].shape,
                                                              b[k].tobytes()), k


def _drop_steps_after(root, last):
    for step in io.list_steps(root):
        if step > last:
            shutil.rmtree(os.path.join(root, f"step_{step:08d}"))


@pytest.mark.parametrize("engine", list(ENGINES))
def test_resume_is_bitwise(quad, tmp_path, engine):
    """tests/test_rounds.py's scenario: 12 rounds in chunks of 4 write steps
    4, 8 and 12; with the steps after 8 removed the resumed run is bit for
    bit the run without checkpoints (every history row, every generator's
    state), and its step 12 holds the first run's final state, history and
    draw state bit for bit."""
    cfg, root = _cfg(engine), str(tmp_path / "ck")
    straight, straight_draws = _run(cfg, quad, chunk=CHUNK)
    first, _ = _run(cfg, quad, chunk=CHUNK, checkpoint_dir=root)
    TR._assert_bitwise(straight, first)
    assert io.list_steps(root) == [4, 8, 12]
    final = _step_arrays(root, 12)
    _drop_steps_after(root, 8)
    resumed, resumed_draws = _run(cfg, quad, chunk=CHUNK, checkpoint_dir=root)
    TR._assert_bitwise(straight, resumed)
    for a, b in zip(straight_draws.state(), resumed_draws.state()):
        assert torch.equal(a, b)
    _assert_same_arrays(final, _step_arrays(root, 12))
    meta = io.load_meta(root, 12)
    assert meta["extra"] == {"rounds": ROUNDS, "chunk": CHUNK, "cfg": repr(cfg),
                             "eval_every": 1, "faults": "None"}
    assert meta["treedef"].startswith("PyTreeDef({'draws': [*, *, *, *, *], 'hist': SimResult(")


def test_resume_at_the_last_round_runs_nothing(quad, tmp_path, monkeypatch):
    """With the last step present nothing is left: no chunk and no initial
    evaluation run, and the stored history comes back."""
    cfg, root = _cfg("deferred"), str(tmp_path / "ck")
    first, _ = _run(cfg, quad, rounds=4, chunk=CHUNK, checkpoint_dir=root)
    monkeypatch.setattr(rounds, "chunk_fn", lambda *a, **k: pytest.fail("a chunk ran"))
    again, _ = _run(cfg, quad, rounds=4, chunk=CHUNK, checkpoint_dir=root)
    TR._assert_bitwise(first, again)


def test_sync_and_async_writes_give_the_same_files(quad, tmp_path):
    """``async_checkpoint=False`` writes the same steps, arrays and meta as
    the background writer (tests/test_rounds.py:165), with ``--ckpt-every``
    2: steps 8 and 12 (the last round always)."""
    cfg = _cfg("fedzo")
    a, s = str(tmp_path / "a"), str(tmp_path / "s")
    r_a, _ = _run(cfg, quad, chunk=CHUNK, checkpoint_dir=a, checkpoint_every=2)
    r_s, _ = _run(cfg, quad, chunk=CHUNK, checkpoint_dir=s, checkpoint_every=2,
                  async_checkpoint=False)
    TR._assert_bitwise(r_a, r_s)
    assert io.list_steps(a) == io.list_steps(s) == [8, 12]
    for step in (8, 12):
        _assert_same_arrays(_step_arrays(a, step), _step_arrays(s, step))
        ma, ms = io.load_meta(a, step), io.load_meta(s, step)
        for key in ("extra", "dtypes", "checksums", "treedef", "step"):
            assert ma[key] == ms[key], key


def test_resume_identity_is_checked(quad, tmp_path):
    """Another ``rounds`` or ``eval_every`` raises; another ``chunk`` is a
    legitimate resume (its boundaries move), held to tests/test_torch_
    rounds.py's bounds against the run without checkpoints."""
    cfg, root = _cfg("deferred"), str(tmp_path / "ck")
    straight, _ = _run(cfg, quad, chunk=CHUNK, eval_every=2)
    _run(cfg, quad, chunk=CHUNK, eval_every=2, checkpoint_dir=root)
    with pytest.raises(ValueError, match="rounds=12"):
        _run(cfg, quad, rounds=10, chunk=CHUNK, eval_every=2, checkpoint_dir=root)
    with pytest.raises(ValueError, match="eval_every=2"):
        _run(cfg, quad, chunk=CHUNK, eval_every=3, checkpoint_dir=root)
    _drop_steps_after(root, 4)
    other, _ = _run(cfg, quad, chunk=3, eval_every=2, checkpoint_dir=root)
    assert io.list_steps(root) == [4, 7, 10, 12]
    assert np.isfinite(other.f_values.numpy()[[0, 2, 4, 6, 8, 10, 12]]).all()
    assert np.isnan(other.f_values.numpy()[[1, 3, 5, 7, 9, 11]]).all()
    nan0 = lambda r: alg.SimResult(*(torch.nan_to_num(t) for t in r))
    TR._assert_bounded(nan0(straight), nan0(other))


def test_resume_falls_back_past_corrupt_steps(quad, tmp_path, capsys):
    """A torn newest step and a bit-flipped second newest: the resume
    restores step 4 and ends bit for bit where the full run did
    (tests/test_faults.py:387)."""
    cfg, root = _cfg("deferred"), str(tmp_path / "ck")
    full, _ = _run(cfg, quad, chunk=CHUNK, checkpoint_dir=root)
    corrupt.truncate_npz(root, 12)
    corrupt.flip_bytes(root, 8)
    resumed, _ = _run(cfg, quad, chunk=CHUNK, checkpoint_dir=root)
    TR._assert_bitwise(full, resumed)
    out = capsys.readouterr().out
    assert "step 12: corrupt" in out and "step 8: corrupt" in out


class _NoState:
    """A draw source without ``state()``."""

    def __init__(self, base):
        self.base = base

    def __getattr__(self, name):
        if name in ("state", "load_state"):
            raise AttributeError(name)
        return getattr(self.base, name)


def test_checkpoint_arguments_rejected(quad, tmp_path):
    """``chunk=0`` with a checkpoint directory raises, as in the reference,
    and so does a draw source without ``state()``, before any round runs."""
    cfg, root = _cfg("deferred"), str(tmp_path / "ck")
    with pytest.raises(ValueError, match="chunk != 0"):
        _run(cfg, quad, chunk=0, checkpoint_dir=root)
    with pytest.raises(TypeError, match="state"):
        alg.simulate(cfg, 5, quad, obj.quadratic_query, obj.quadratic_global_value, ROUNDS,
                     draws=_NoState(alg.ClientDraws(5, range(4), "cpu")), chunk=CHUNK,
                     checkpoint_dir=root, device="cpu")
    assert not os.path.exists(root)


def test_draw_state_round_trip():
    """``ClientDraws.state()`` is the bank generator's state, then each
    client's; ``load_state`` puts a source back where another one was."""
    a, b = alg.ClientDraws(3, range(2), "cpu"), alg.ClientDraws(3, range(2), "cpu")
    a.noise(4)
    a.bank(8, 3)
    saved = a.state()
    assert len(saved) == 3 and all(s.dtype == torch.uint8 for s in saved)
    b.load_state(saved)
    assert torch.equal(a.noise(5), b.noise(5)) and torch.equal(a.bank(2, 2)[0], b.bank(2, 2)[0])
    with pytest.raises(ValueError, match="client generators"):
        alg.ClientDraws(3, range(3), "cpu").load_state(saved)


# ---------------------------------------------------------------------------
# Against the reference's resume, on its own draws
# ---------------------------------------------------------------------------


def test_resume_tracks_the_reference_on_its_draws(tmp_path, port64):
    """Both packages run 5 rounds in chunks of 2 (steps 2, 4 and 5), lose
    the steps after 2 and resume, on the reference's draws: the port's
    resumed run tracks the reference's within F 1e-3 and x 1e-2 with exact
    queries, and its recorded draws are used up exactly.  The horizon is
    tests/test_torch_rounds.py's scan comparison (5 rounds, key 3): over 12
    rounds the two packages' runs part beyond x 1e-2 by round 6 without any
    resume (f32 near-ties of the active picks; 1.6e-2 on key 3).  F and x
    are held with ``TA.assert_tracks``'s float64 witness: the float64
    port's run in the same chunks on the same draws, without a resume."""
    rcfg, cfg = ralg.AlgoConfig(**TA.KW), alg.AlgoConfig(**TA.KW)
    rq = robj.make_quadratic(jax.random.PRNGKey(0), TA.N, TA.D, 5.0, 0.001)
    q = convert.quadratic(jax.tree_util.tree_map(np.asarray, rq), "cpu")
    key, n_rounds, chunk = jax.random.PRNGKey(3), 5, 2
    rroot, root = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_sim = lambda: ralg.simulate(rcfg, key, rq, robj.quadratic_query,
                                    robj.quadratic_global_value, n_rounds, chunk=chunk,
                                    checkpoint_dir=rroot)

    def port_sim():
        rec = TA._recorded_simulate_draws(cfg, key, n_rounds)
        res = alg.simulate(cfg, 0, q, obj.quadratic_query, obj.quadratic_global_value,
                           n_rounds, draws=rec, chunk=chunk, checkpoint_dir=root, device="cpu")
        assert rec.exhausted()
        return res

    ref_sim()
    port_sim()
    assert io.list_steps(root) == rio.list_steps(rroot) == [2, 4, 5]
    _drop_steps_after(rroot, 2)
    _drop_steps_after(root, 2)
    ref, port = ref_sim(), port_sim()

    @functools.cache
    def truth():
        rec64, o64 = TA._recorded_simulate_draws(cfg, key, n_rounds).widened(), port64.obj
        out = port64.alg.simulate(
            port64.alg.AlgoConfig(**TA.KW), 0, port64.convert.quadratic(TA.wide(rq), "cpu"),
            o64.quadratic_query, o64.quadratic_global_value, n_rounds, draws=rec64,
            chunk=chunk, device="cpu")
        assert rec64.exhausted()
        return out

    np.testing.assert_array_equal(port.queries.numpy(), np.asarray(ref.queries))
    TA.assert_tracks(port.f_values, ref.f_values, lambda: truth().f_values, TA.F_TOL, "F")
    TA.assert_tracks(port.xs, ref.xs, lambda: truth().xs, TA.X_TOL, "x")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def test_cuda_resume_in_captured_chunks_is_bitwise(tmp_path):
    """The bitwise resume in captured chunks: the resumed run captures its
    chunk of 4 once and replays it once, and equals the captured run
    without checkpoints bit for bit, generators included."""
    dev = TR._cuda()
    cfg, root = _cfg("deferred"), str(tmp_path / "ck")
    q = obj.make_quadratic(0, 4, 8, 2.0, 0.001, device=dev)

    def sim(**kw):
        draws = alg.ClientDraws(5, range(4), dev)
        res = alg.simulate(cfg, 5, q, obj.quadratic_query, obj.quadratic_global_value, ROUNDS,
                           draws=draws, chunk=CHUNK, device=dev, **kw)
        return res, draws

    straight, straight_draws = sim()
    sim(checkpoint_dir=root)
    _drop_steps_after(root, 8)
    graphs.COUNTS.update(captures=0, replays=0)
    resumed, resumed_draws = sim(checkpoint_dir=root)
    assert graphs.COUNTS == {"captures": 1, "replays": 1}
    assert all(torch.equal(a, b) for a, b in zip(straight, resumed))
    for a, b in zip(straight_draws.state(), resumed_draws.state()):
        assert torch.equal(a, b)


def test_cuda_loaded_state_reaches_a_registered_graph():
    """``load_state`` on generators a captured graph has registered: the
    next replay draws from the loaded state (``Generator.set_state``
    suffices, no graph-safe state call is needed)."""
    dev = TR._cuda()
    cfg = _cfg("deferred")
    q = obj.make_quadratic(0, 4, 8, 2.0, 0.001, device=dev)
    draws = alg.ClientDraws(5, range(4), dev)
    x0 = torch.full((8,), 0.5, device=dev)
    rff = alg.rfflib.make_rff(draws, cfg.n_features, cfg.dim, cfg.lengthscale)
    states = alg.init_states(cfg, x0)
    make = lambda k, d: rounds.chunk_fn(cfg, rff, obj.quadratic_query, q, d,
                                        obj.quadratic_global_value, None, k, 1, 4)
    cc = graphs.CapturedChunks(make, draws, states, x0)
    saved = draws.state()
    first = [t.clone() for t in cc.run(2, 0)]
    second = [t.clone() for t in cc.run(2, 2)]
    cc.load(states)
    cc.sx.copy_(x0)
    draws.load_state(saved)
    again = cc.run(2, 0)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert not torch.equal(first[0], second[0])
