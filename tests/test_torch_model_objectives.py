"""The port's model-backed objectives (``repro_torch.core.model_objectives``,
``repro_torch.data.partition``) against the reference's.

Torch cannot replay the reference's threefry keys, so the trained
objectives are carried across (``convert.attack_objective``,
``convert.metric_objective``) and both packages compute on the same
victims and data; the MLP training is held against the reference's from
the same initial parameters and data.  The engines run on draws recorded
from the reference (``tests/test_torch_algorithms.py``'s ``RecordedDraws``).

Tolerances, each stated where it is used: the partitions are the same
index arrays; logits, margins and F of the attack within 1e-5 (f32 sums in
other orders on O(10) logits); the training's loss within 1e-4 per step
for 50 steps and its logits within 1e-2 after 300 steps; the metric (an
argmax count) within 1e-6 wherever no evaluation row has its two top
logits within 1e-4; the engines within the engine bound of
``test_torch_algorithms.py`` (F 1e-3, x 1e-2, exact queries).
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as ralg
from repro.core import model_objectives as rmobj
from repro.data import partition as rpart
from repro.optim import adam_init as radam_init
from repro.optim import adam_update as radam_update
from repro_torch import convert
from repro_torch.core import algorithms as alg
from repro_torch.core import model_objectives as mobj
from repro_torch.data import partition

N_ = lambda a: np.asarray(a)
T = lambda a: torch.from_numpy(np.array(a))
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)


def _port_algorithms_tests():
    """tests/test_torch_algorithms.py, for its recorder of the reference's draws."""
    path = Path(__file__).resolve().parent / "test_torch_algorithms.py"
    spec = importlib.util.spec_from_file_location("_torch_algorithms_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TA = _port_algorithms_tests()
port64 = TA.port64  # the port in float64, the witness of TA.assert_tracks


# -- partitions ---------------------------------------------------------------


@pytest.mark.parametrize("p_shared", [0.4, 0.5, 0.6, 0.7, 0.8, 1.0])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_label_subset_partition_matches_reference(seed, p_shared):
    """The P of every figure and launcher default (fig2 0.4/0.8, fig3
    0.6/1.0, the launcher 0.5, the metric maker 0.7): the same index
    arrays, exactly; also a degenerate draw that pads from the complement."""
    labels = np.random.default_rng(seed).integers(0, 10, size=700)
    want = rpart.label_subset_partition(labels, 6, p_shared, seed=seed)
    got = partition.label_subset_partition(labels, 6, p_shared, seed=seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    sparse = np.repeat(np.arange(10), [1, 1, 1, 1, 1, 50, 50, 50, 50, 50])
    for g, w in zip(partition.label_subset_partition(sparse, 4, 0.1, seed=seed),
                    rpart.label_subset_partition(sparse, 4, 0.1, seed=seed)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("alpha", [0.1, 1.0, 10.0])
def test_dirichlet_partition_matches_reference(alpha):
    labels = np.random.default_rng(5).integers(0, 7, size=500)
    for g, w in zip(partition.dirichlet_partition(labels, 5, alpha, seed=2),
                    rpart.dirichlet_partition(labels, 5, alpha, seed=2)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("call", [
    lambda mod: mod.label_subset_partition(np.arange(20) % 4, 3, 1.5),
    lambda mod: mod.label_subset_partition(np.arange(20) % 4, 3, 0.0),
    lambda mod: mod.label_subset_partition(np.arange(20) % 4, 0, 0.5),
    lambda mod: mod.dirichlet_partition(np.arange(20) % 4, 3, -1.0),
    lambda mod: mod.dirichlet_partition(np.arange(20) % 4, 2.5, 1.0),
], ids=["p_above_1", "p_zero", "no_clients", "alpha_negative", "clients_not_int"])
def test_partition_validation_matches_reference(call):
    """The same inputs are refused with the same message."""
    with pytest.raises(ValueError) as want:
        call(rpart)
    with pytest.raises(ValueError) as got:
        call(partition)
    assert str(got.value) == str(want.value)


# -- the MLP ------------------------------------------------------------------


def test_mlp_logits_matches_reference():
    """One MLP on a batch of points, and a stack of three on a batch each:
    atol 1e-5."""
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    ps = [rmobj.mlp_init(k, 64, 64, 10) for k in keys]
    x = jax.random.uniform(jax.random.PRNGKey(1), (3, 20, 64))
    want = rmobj.mlp_logits(ps[0], x[0])
    got = mobj.mlp_logits(convert.mlp_params(to_np(ps[0]), "cpu"), T(x[0]))
    np.testing.assert_allclose(got.numpy(), N_(want), atol=1e-5)
    stacked = jax.tree_util.tree_map(lambda *v: jnp.stack(v), *ps)
    want = jax.vmap(rmobj.mlp_logits)(stacked, x)
    got = mobj.mlp_logits(convert.mlp_params(to_np(stacked), "cpu"), T(x))
    np.testing.assert_allclose(got.numpy(), N_(want), atol=1e-5)


def _reference_training(p, xs, ys, steps, lr=5e-3):
    """The reference's ``_train_mlp`` loop (its loss, ``adam_update`` and
    lr), keeping each step's loss before its update."""
    def loss_fn(p):
        lg = rmobj.mlp_logits(p, xs)
        return -jnp.mean(jax.nn.log_softmax(lg)[jnp.arange(xs.shape[0]), ys])

    @jax.jit
    def step(p, opt):
        loss, g = jax.value_and_grad(loss_fn)(p)
        p, opt = radam_update(opt, g, p, lr)
        return p, opt, loss

    opt, losses = radam_init(p), []
    for _ in range(steps):
        p, opt, loss = step(p, opt)
        losses.append(float(loss))
    return p, np.array(losses)


TRAIN_MLP = """
import sys, torch
from repro_torch.core import model_objectives as mobj
p0, tx, ty, hx = torch.load(sys.argv[1])
p, losses = mobj._train_mlp(mobj.MLPParams(*p0), tx, ty)
torch.save((losses, mobj.mlp_logits(p, hx), [t.requires_grad for t in p]), sys.argv[2])
"""


def test_train_mlp_matches_reference(tmp_path):
    """300 Adam steps at lr 5e-3 from the reference's initial params on 256
    of the reference's blob images: the loss within 1e-4 at each of the
    first 50 steps, the trained logits on 256 held-out images within 1e-2.
    The port trains on the CPU by ``one_thread``."""
    p0 = rmobj.mlp_init(jax.random.PRNGKey(2), 64, 64, 10)
    xs, ys = rmobj.blob_images(jax.random.PRNGKey(3), 512, side=8)
    tx, ty, hx = xs[:256], ys[:256], xs[256:]
    torch.save((tuple(convert.mlp_params(to_np(p0), "cpu")), T(tx), T(ty).long(), T(hx)),
               tmp_path / "in.pt")
    one_thread(TRAIN_MLP, str(tmp_path / "in.pt"), str(tmp_path / "out.pt"))
    want_p, want_losses = _reference_training(p0, tx, ty, 50)
    # the loop above is the reference's own training
    np.testing.assert_allclose(
        N_(rmobj.mlp_logits(want_p, hx)),
        N_(rmobj.mlp_logits(rmobj._train_mlp(jax.random.PRNGKey(0), p0, tx, ty, steps=50), hx)),
        atol=1e-5)
    ref_p = rmobj._train_mlp(jax.random.PRNGKey(0), p0, tx, ty)

    got_losses, got_logits, needs_grad = torch.load(tmp_path / "out.pt")
    assert got_losses.shape == (300,)
    assert not any(needs_grad)
    np.testing.assert_allclose(got_losses[:50].numpy(), want_losses, atol=1e-4)
    np.testing.assert_allclose(got_logits.numpy(), N_(rmobj.mlp_logits(ref_p, hx)), atol=1e-2)


def test_stacked_training_trains_each_mlp_on_its_own_batch():
    """Three MLPs trained in one batched loop are each the MLP trained
    alone (atol 1e-5 on the logits after 10 steps); a batch padded with
    rows of weight 0 trains as the batch without them."""
    gens = [torch.Generator().manual_seed(i) for i in range(3)]
    ps = [mobj.mlp_init(g, 16, 8, 4) for g in gens]
    g = torch.Generator().manual_seed(9)
    xs, ys = torch.randn(3, 40, 16, generator=g), torch.randint(0, 4, (3, 40), generator=g)
    stacked, losses = mobj._train_mlp(mobj.stack(ps), xs, ys, steps=10)
    assert losses.shape == (10, 3)
    for i, p in enumerate(ps):
        alone, _ = mobj._train_mlp(p, xs[i], ys[i], steps=10)
        np.testing.assert_allclose(mobj.mlp_logits(stacked, xs)[i].numpy(),
                                   mobj.mlp_logits(alone, xs[i]).numpy(), atol=1e-5)
    weights = torch.zeros(3, 40)
    weights[:, :30] = 1.0 / 30
    padded, _ = mobj._train_mlp(mobj.stack(ps), xs, ys, steps=10, weights=weights)
    short, _ = mobj._train_mlp(mobj.stack(ps), xs[:, :30], ys[:, :30], steps=10)
    np.testing.assert_allclose(mobj.mlp_logits(padded, xs).numpy(),
                               mobj.mlp_logits(short, xs).numpy(), atol=1e-5)


# -- the attack ---------------------------------------------------------------


@pytest.fixture(scope="module")
def attack():
    """The reference's attack objective (tests/test_objectives.py's size:
    side 8, N=4, 128 training images a victim) and its port."""
    robj, img = rmobj.make_attack_objective(jax.random.PRNGKey(3), n_clients=4, p_shared=0.6,
                                            side=8, train_per_client=128)
    return robj, convert.attack_objective(to_np(robj), "cpu"), img


def test_attack_matches_reference(attack):
    """Margins at per-client points, F and success at shared points, and
    the noisy query's noise term: atol 1e-5."""
    robj, cps, img = attack
    d = img.shape[-1]
    x = jax.random.uniform(jax.random.PRNGKey(4), (4, 9, d))
    want = jax.vmap(lambda cp, xi: jax.vmap(lambda v: rmobj.attack_margin(cp, v))(xi))(robj, x)
    np.testing.assert_allclose(mobj.attack_margin(cps, T(x)).numpy(), N_(want), atol=1e-5)
    for xp in (jnp.full((d,), 0.5), x[0, 0], x[1, 3], jnp.zeros((d,)), jnp.ones((d,))):
        np.testing.assert_allclose(float(mobj.attack_global_value(cps, T(xp))),
                                   float(rmobj.attack_global_value(robj, xp)), atol=1e-5)
        assert float(mobj.attack_success(cps, T(xp))) == float(rmobj.attack_success(robj, xp))
    z = torch.randn(4, 9, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(mobj.attack_query(cps, T(x), z).numpy(),
                               N_(want) + 0.001 * z.numpy(), atol=1e-5)
    assert float(mobj.attack_global_value(cps, torch.full((d,), 0.5))) > 0


def one_thread(code: str, *args: str) -> str:
    """Runs ``code`` in a child Python whose torch uses one CPU thread
    (``OMP_NUM_THREADS=1`` in the child's environment only) and returns
    its output.  Under the test runner's parallel workers, torch's OpenMP
    regions (a batched product, a log-softmax, even on small tensors)
    oversubscribe the cores, and a loop of a few hundred such steps, as a
    victim's training, slows by tens of times; on one thread it costs what
    it costs alone."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [src, os.environ.get("PYTHONPATH")])))
    res = subprocess.run([sys.executable, "-c", code, *args], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


PORT_ATTACK = """
import sys, torch
from repro_torch.core import algorithms as alg, model_objectives as mobj
cps, img = mobj.make_attack_objective(1, n_clients=4, p_shared=0.6, side=8,
                                      train_per_client=128, device="cpu")
cfg = alg.AlgoConfig(name="fzoos", dim=img.shape[-1], n_clients=4, local_steps=5, eta=0.02,
                     n_features=128, traj_capacity=96, active_per_iter=3,
                     active_candidates=30, active_round_end=3, lengthscale=0.5, noise=1e-5)
res = alg.simulate(cfg, 2, cps, mobj.attack_query, mobj.attack_global_value, 8, device="cpu")
torch.save((cps, img, res.f_values), sys.argv[1])
"""


@pytest.fixture(scope="module")
def port_attack(tmp_path_factory):
    """The port's own attack objective at tests/test_system.py's size (side
    8, N=4, P=0.6, 128 training images a victim) and F over 8 rounds of
    FZooS on it, built and run on the CPU by ``one_thread``."""
    out = tmp_path_factory.mktemp("port_attack") / "run.pt"
    one_thread(PORT_ATTACK, str(out))
    return torch.load(out, weights_only=False)


def test_attack_objective_of_the_port(port_attack):
    """The port's maker: d = side^2, the target correctly classified on
    average, no tensor requiring a gradient, no query with an autograd
    graph (two builds of a seed on the card: tests/test_torch_launch.py)."""
    cps, img, _ = port_attack
    d = img.shape[-1]
    assert d == 64 and cps.z.shape == (4, d) and cps.label.dtype == torch.int64
    assert all(not t.requires_grad for t in (*cps.victims, *cps[1:]))
    x0 = torch.full((d,), 0.5)
    assert float(mobj.attack_global_value(cps, x0)) > 0
    assert float(mobj.attack_success(cps, x0)) == 0.0
    y = mobj.attack_query(cps, torch.rand(4, 5, d), torch.randn(4, 5))
    assert y.shape == (4, 5) and y.grad_fn is None
    assert mobj.attack_global_value(cps, x0).grad_fn is None


# -- the metric ---------------------------------------------------------------


@pytest.fixture(scope="module")
def metric():
    """The reference's metric objective (tests/test_objectives.py's size:
    N=3, P=0.8, 128 evaluation rows a client) and its port."""
    robj, d = rmobj.make_metric_objective(jax.random.PRNGKey(4), n_clients=3, p_shared=0.8,
                                          n_eval=128)
    return robj, convert.metric_objective(to_np(robj), "cpu"), d


def _near_ties(robj, x, gap=1e-4):
    """Per (client, point): whether any evaluation row's two top logits of
    the perturbed model lie within ``gap`` (float64)."""
    base = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), robj.base)
    xs, scale = np.asarray(robj.xs, np.float64), np.asarray(robj.scale, np.float64)
    x = np.asarray(x, np.float64)
    nw = base.w2[0].size
    out = np.zeros(x.shape[:2], bool)
    for i in range(x.shape[0]):
        h = np.tanh(xs[i] @ base.w1[i] + base.b1[i])
        for k in range(x.shape[1]):
            delta = (2 * x[i, k] - 1) * scale[i]
            lg = h @ (base.w2[i] + delta[:nw].reshape(base.w2[i].shape)) + base.b2[i] + delta[nw:]
            top = np.sort(lg, axis=-1)
            out[i, k] = bool((top[:, -1] - top[:, -2] < gap).any())
    return out


def test_metric_matches_reference(metric):
    """1 - precision at per-client points within 1e-6 wherever no
    evaluation row's two top logits lie within 1e-4 (the skipped points
    are reported); F at shared points likewise; the query records no
    autograd graph."""
    robj, cps, d = metric
    assert d == 119 and cps.base.w2.shape[1:] == (16, 7)
    x = jax.random.uniform(jax.random.PRNGKey(6), (3, 12, d))
    x = x.at[:, 0].set(0.5)  # theta* itself
    want = N_(jax.vmap(lambda cp, xi: jax.vmap(lambda v: rmobj.metric_value(cp, v))(xi))(robj, x))
    got = mobj.metric_value(cps, T(x)).numpy()
    ties = _near_ties(robj, x)
    print(f"metric_value: {int(ties.sum())} of {ties.size} (client, point) pairs skipped as "
          "near ties")
    assert ties.sum() < ties.size // 2
    np.testing.assert_allclose(got[~ties], want[~ties], atol=1e-6)
    for k in range(4):
        xp = x[0, k]
        if not _near_ties(robj, jnp.broadcast_to(xp, (3, 1, d))).any():
            np.testing.assert_allclose(float(mobj.metric_global_value(cps, T(xp))),
                                       float(rmobj.metric_global_value(robj, xp)), atol=1e-6)
    z = torch.randn(3, 12, generator=torch.Generator().manual_seed(1))
    y = mobj.metric_query(cps, T(x), z)
    assert y.shape == (3, 12) and y.grad_fn is None
    np.testing.assert_allclose(y.numpy()[~ties], (want + 0.001 * z.numpy())[~ties], atol=1e-6)


def test_metric_eval_rows_match_reference():
    """The metric's evaluation rows: the port's draw from each client's
    partition (``_client_subsets``) picks the rows the reference's maker
    holds, exactly, with n_eval 3530 above two clients' row counts (3522,
    drawn with replacement) and below the third's (3537)."""
    key, n_eval = jax.random.PRNGKey(4), 3530
    robj, _ = rmobj.make_metric_objective(key, n_clients=3, p_shared=0.8, n_eval=n_eval)
    kd, _, kp = jax.random.split(key, 3)
    xs, ys = (N_(a)[4096:] for a in rmobj.tabular_covertype_like(kd, 8192))
    parts = partition.label_subset_partition(ys, 3, 0.8, seed=int(kp[0]))
    assert [len(p) < n_eval for p in parts] == [True, False, True]
    rows = np.stack(mobj._client_subsets(parts, n_eval, upto=False))
    np.testing.assert_array_equal(N_(robj.ys), ys[rows])
    np.testing.assert_array_equal(N_(robj.xs), xs[rows])


def test_soft_precision_on_tied_rows():
    """Rows whose top logits tie exactly: both packages' argmax takes the
    first index, so the precisions agree exactly."""
    logits = np.array([[1.0, 1.0, 0.0], [0.0, 2.0, 2.0], [3.0, 3.0, 3.0], [0.5, 0.0, 0.5],
                       [0.0, 1.0, 0.0]], np.float32)
    labels = np.array([1, 2, 0, 2, 1])
    assert torch.argmax(T(logits), -1).tolist() == [0, 1, 0, 0, 1]
    want = float(rmobj.soft_precision(jnp.asarray(logits), jnp.asarray(labels), 3))
    got = float(mobj.soft_precision(T(logits), T(labels), 3))
    assert got == want


# -- the engines on the objectives ---------------------------------------------


def _engine_kw(d):
    return dict(TA.KW, dim=d)


def _engine_pair(robj, cps, query, rquery, value, rvalue, d, rounds=3):
    """The deferred engine, ``chunk=0``, on both sides with the reference's
    draws: (port result, reference result)."""
    rcfg, cfg = ralg.AlgoConfig(**_engine_kw(d)), alg.AlgoConfig(**_engine_kw(d))
    key = jax.random.PRNGKey(1)
    want = ralg.simulate(rcfg, key, robj, rquery, rvalue, rounds, chunk=0)
    rec = TA._recorded_simulate_draws(cfg, key, rounds)
    got = alg.simulate(cfg, 0, cps, query, value, rounds, draws=rec, chunk=0, device="cpu")
    assert rec.exhausted()
    print(f"d={d}: max|dF| {np.abs(got.f_values.numpy() - N_(want.f_values)).max():.3e}, "
          f"max|dx| {np.abs(got.xs.numpy() - N_(want.xs)).max():.3e}")
    return got, want


def test_attack_engine_matches_reference():
    """Three rounds of the deferred engine on the attack at side 4 (d=16),
    N=3, cap=16, M=32: F within 1e-3, x within 1e-2, exact queries."""
    robj, img = rmobj.make_attack_objective(jax.random.PRNGKey(7), n_clients=TA.N,
                                            p_shared=0.6, side=4, train_per_client=64)
    cps = convert.attack_objective(to_np(robj), "cpu")
    got, want = _engine_pair(robj, cps, mobj.attack_query, rmobj.attack_query,
                             mobj.attack_global_value, rmobj.attack_global_value,
                             img.shape[-1])
    np.testing.assert_array_equal(got.queries.numpy(), N_(want.queries))
    assert np.isfinite(got.f_values.numpy()).all()
    np.testing.assert_allclose(got.f_values.numpy(), N_(want.f_values), atol=TA.F_TOL)
    np.testing.assert_allclose(got.xs.numpy(), N_(want.xs), atol=TA.X_TOL)


def test_metric_engine_matches_reference(metric, port64):
    """Three rounds of the deferred engine on the metric (d=119), N=3,
    cap=16, M=32: x within 1e-2 (with ``TA.assert_tracks``'s float64
    witness: the float64 port on the same objective and draws), exact
    queries; F is a step function of x, so each side's F is held to the
    reference's ``metric_global_value`` at that side's own x (1e-6)."""
    robj, cps, d = metric
    rec64 = TA._recorded_simulate_draws(alg.AlgoConfig(**_engine_kw(d)), jax.random.PRNGKey(1),
                                        3).widened()
    got, want = _engine_pair(robj, cps, mobj.metric_query, rmobj.metric_query,
                             mobj.metric_global_value, rmobj.metric_global_value, d)

    def truth():
        m64 = port64.mobj
        out = port64.alg.simulate(
            port64.alg.AlgoConfig(**_engine_kw(d)), 0,
            port64.convert.metric_objective(TA.wide(to_np(robj)), "cpu"), m64.metric_query,
            m64.metric_global_value, 3, draws=rec64, chunk=0, device="cpu")
        assert rec64.exhausted()
        return out.xs

    np.testing.assert_array_equal(got.queries.numpy(), N_(want.queries))
    TA.assert_tracks(got.xs, want.xs, truth, TA.X_TOL, "x")
    for res in (got, want):
        xs, f = N_(res.xs), N_(res.f_values)
        ref_f = [float(rmobj.metric_global_value(robj, jnp.asarray(x))) for x in xs]
        np.testing.assert_allclose(f, ref_f, atol=1e-6)


def test_port_attack_lowers_the_margin(port_attack):
    """tests/test_system.py's attack run on the port's own objective (side
    8, N=4, 8 rounds; ``port_attack``'s run, T=5, eta 0.02, M=128, cap 96,
    30 candidates, 3+3 active): FZooS pushes the averaged margin down by
    more than 1e-3."""
    f = port_attack[2].numpy()
    assert f.shape == (9,) and np.isfinite(f).all()
    assert f.min() < f[0] - 1e-3
