"""The port's LM objective (``repro_torch.core.model_objectives``' third
part) and ``--objective lm`` against the reference's.

Torch cannot replay the reference's threefry keys, so the reference's
parameters and token batches are carried across (``convert.lm_params``,
``convert.lm_objective``) and both packages compute on the same numbers.
The engines run on draws recorded from the reference
(``tests/test_torch_algorithms.py``'s ``RecordedDraws``).

Tolerances, each stated where it is used: the float32 variant of a model
(``dataclasses.replace(cfg, dtype="float32")``) within 1e-4 of the
largest magnitude (DESIGN.md Sec. 2.4); the published bf16 model by the
rule of ``test_torch_models.hold`` (each side against the port's float64
evaluation, the port no further than ``BF16_MULTIPLE`` times the
reference); the gains bit for bit; the engines within the engine bound of
``test_torch_algorithms.py`` (F 1e-3, x 1e-2, with its float64 witness)
and exact queries.
"""

import dataclasses
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.core import algorithms as ralg
from repro.core import model_objectives as rmobj
from repro.models.params import init_params as rinit_params
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import algorithms as alg
from repro_torch.core import model_objectives as mobj
from repro_torch.models import forward
from repro_torch.models import layers as L
from repro_torch.models.params import init_params
from repro_torch.sharding import ShardingPolicy

N_ = lambda a: np.asarray(a)
T = lambda a: torch.from_numpy(np.array(a))
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    """A sibling test module, for its helpers."""
    path = Path(__file__).resolve().parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_{name}_helpers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TA = _load("test_torch_algorithms")
TM = _load("test_torch_models")

ARCHS = ["qwen1_5_0_5b", "mamba2_370m"]  # tests/test_objectives.py:92's two families
ENGINE_ARCHS = ARCHS + ["jamba_1_5_large_398b"]  # moe and ssm inside the engine


def _pair(arch, dtype, n=TA.N):
    """The reference's SMOKE model of ``arch`` in ``dtype`` (its
    ``init_params``), its LM objective for ``n`` clients and their port:
    {"arch", "rcfg", "rparams", "robj", "cfg", "params", "cps", "ref", "port"}
    with ``ref``/``port`` the (query, global_value, d, value) of each."""
    rcfg = dataclasses.replace(rget_config(arch, "smoke"), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype=dtype)
    rparams = rinit_params(jax.random.PRNGKey(0), rcfg)
    robj = rmobj.make_lm_objective(jax.random.PRNGKey(1), rcfg, n)
    params = convert.lm_params(to_np(rparams), "cpu")
    cps = convert.lm_objective(to_np(robj), "cpu")
    return dict(arch=arch, rcfg=rcfg, rparams=rparams, robj=robj, cfg=cfg, params=params,
                cps=cps, ref=rmobj.make_lm_query(rcfg, rparams),
                port=mobj.make_lm_query(cfg, params))


@pytest.fixture(scope="module", params=ARCHS + TM.NEW)
def lm32(request):
    """The float32 variant, shared by the query and engine tests."""
    return _pair(request.param, "float32")


@pytest.fixture(scope="module", params=ARCHS + TM.NEW)
def lm16(request):
    """The published bf16 model."""
    return _pair(request.param, "bfloat16")


def _ref_values(pair, x):
    """The reference's value at per-client points (N, K, d): (N, K)."""
    value = pair["ref"][3]
    return N_(jax.jit(jax.vmap(lambda cp, xi: jax.vmap(lambda v: value(cp, v))(xi)))(
        pair["robj"], x))


def _points(d, n=TA.N, k=4, seed=6):
    x = jax.random.uniform(jax.random.PRNGKey(seed), (n, k, d))
    return x.at[:, 0].set(0.5).at[:, 1].set(0.0).at[:, 2].set(1.0)


# -- the objective at fixed points ---------------------------------------------


def test_lm_query_matches_reference_f32(lm32):
    """Values at per-client points (the base gains, both corners and random
    points), F at shared points and the noisy query: the float32 variant
    within 1e-4 of the largest magnitude."""
    port, rquery, rglobal = lm32["port"], jax.jit(lm32["ref"][0]), jax.jit(lm32["ref"][1])
    d = lm32["cfg"].d_model
    assert port[2] == lm32["ref"][2] == d
    x = _points(d)
    want = _ref_values(lm32, x)
    got = port[3](lm32["cps"], T(x)).numpy()
    scale = np.abs(want).max()
    print(f"{lm32['cfg'].name} f32: max|port - reference| / max|reference| "
          f"{np.abs(got - want).max() / scale:.3e}")
    np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0)
    for xp in (jnp.full((d,), 0.5), x[0, 3], x[1, 3]):
        np.testing.assert_allclose(float(port[1](lm32["cps"], T(xp))),
                                   float(rglobal(lm32["robj"], xp)), atol=1e-4 * scale, rtol=0)
    z = torch.randn(TA.N, 4, generator=torch.Generator().manual_seed(1))
    y = port[0](lm32["cps"], T(x), z)
    assert y.shape == (TA.N, 4) and y.grad_fn is None
    np.testing.assert_allclose(y.numpy(), want + 0.001 * z.numpy(), atol=1e-4 * scale, rtol=0)
    # the reference's own query on one client, key for key, is its value + sigma z
    cp0 = jax.tree_util.tree_map(lambda a: a[0], lm32["robj"])
    rz = float(jax.random.normal(jax.random.PRNGKey(3), ()))
    np.testing.assert_allclose(float(rquery(cp0, x[0, 3], jax.random.PRNGKey(3))),
                               want[0, 3] + 0.001 * rz, atol=1e-6)


def test_lm_query_matches_reference_bf16(lm16):
    """The published bf16 model at the same points: each side against the
    port's float64 evaluation of the same parameters and gains
    (``TM.hold``); for the MoE families with the routing pinned to the
    float64 run's, every value compared, after the port's own routing is
    shown to differ from it only at near-ties (``TM.near_ties_only``)."""
    cfg, params, cps = lm16["cfg"], lm16["params"], lm16["cps"]
    x = _points(cfg.d_model)
    want = _ref_values(lm16, x)
    got = lm16["port"][3](cps, T(x))
    # the float64 model with the bf16 model's gains, which the bit-for-bit
    # test below holds to the reference's
    gains = mobj.lm_gains(params["final_norm"], cps.scale, T(x))
    routes64 = L.Routes()
    truth = mobj.lm_values(dataclasses.replace(cfg, dtype="float64"),
                           {k: v.double() for k, v in params.items()}, cps, gains.double(),
                           routes=routes64).numpy()
    what = f"{cfg.name} bf16 values"
    if cfg.is_moe_mlp:
        run = lambda routes: mobj.lm_values(cfg, params, cps, gains, routes=routes)
        assert torch.equal(run(None), got)
        TM.near_ties_only(run, routes64, cps.batches_tokens.shape[-1], what)
        got = run(L.Routes(pin=routes64))
    TM.hold(got.double().numpy(), want, truth, torch.bfloat16, what)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_gains_bit_for_bit(arch):
    """final_norm + (scale * (x - 1/2)) cast to bf16, on both sides, bit for
    bit: at random points, and at points whose shift lies on a bf16
    rounding edge (half an ulp either side of 1.0's spacing)."""
    cfg = get_config(arch, "smoke")
    d = cfg.d_model
    base = jax.random.normal(jax.random.PRNGKey(2), (d,)).astype(jnp.bfloat16) * 0.1 + 1.0
    scale = jnp.full((TA.N,), 0.5, jnp.float32)
    x = jax.random.uniform(jax.random.PRNGKey(4), (TA.N, 5, d))
    # shifts of k * 2^-9 (+- a float32 ulp): ties and near-ties of bf16 at 1.0
    edge = 0.5 + (jnp.arange(d) % 9 - 4) * 2.0 ** -8
    x = x.at[:, 0].set(edge).at[:, 1].set(jnp.nextafter(edge, 2.0)).at[:, 2].set(
        jnp.nextafter(edge, -2.0))
    ref = jax.jit(lambda b, s, v: b + (s[:, None, None] * (v - 0.5)).astype(b.dtype))
    want = N_(ref(base, scale, x).view(jnp.uint16))
    got = mobj.lm_gains(convert.tensor(to_np(base), "cpu"), T(scale), T(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)


@pytest.mark.parametrize("arch", ARCHS + TM.NEW)
def test_lm_objective_runs_on_zoo_archs(arch):
    """tests/test_objectives.py:92's assertions on the port's own objective
    (its ``init_params`` and ``make_lm_objective``, batch 1, seq 16)."""
    cfg = get_config(arch, "smoke")
    params = init_params(0, cfg, "cpu")
    assert all(not t.requires_grad for t in params.values())
    cobjs = mobj.make_lm_objective(0, cfg, n_clients=3, batch=1, seq=16, device="cpu")
    assert cobjs.batches_tokens.shape == (3, 1, 16) and cobjs.batches_tokens.dtype == torch.int64
    torch.testing.assert_close(cobjs.batches_tokens[..., 1:], cobjs.batches_labels[..., :-1])
    query, global_value, d, value = mobj.make_lm_query(cfg, params)
    assert d == cfg.d_model
    x0 = torch.full((d,), 0.5)
    v = float(global_value(cobjs, x0))
    assert np.isfinite(v) and v > 0
    cp = mobj.LMObjective(*(t[:1] for t in cobjs))
    y = query(cp, x0[None], torch.randn(1, generator=torch.Generator().manual_seed(1)))
    assert y.shape == (1,) and np.isfinite(float(y)) and y.grad_fn is None
    # perturbing the norm gains changes the loss
    x1 = torch.clamp(x0 + 0.4, 0, 1)
    assert float(global_value(cobjs, x1)) != pytest.approx(v, abs=1e-7)
    # a query batches its points: each point's value is its own forward pass
    pts = torch.rand(3, 2, d, generator=torch.Generator().manual_seed(2))
    both = value(cobjs, pts)
    for k in range(2):
        torch.testing.assert_close(both[:, k], value(cobjs, pts[:, k]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", TM.MOE)
def test_lm_values_route_each_point_alone(arch):
    """float32: ``lm_values`` at K=4 points a client equals its 4 single-point
    calls within 1e-6 of the largest magnitude, as the reference evaluates
    each point alone (its engine vmaps the query over clients and points):
    each (client, point) is its own group, with its own MoE capacity,
    drops and aux.  The batch's drops are real: with one group a call the
    values move."""
    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype="float32")
    params = init_params(0, cfg, "cpu")
    cps = mobj.make_lm_objective(0, cfg, n_clients=3, device="cpu")
    value = mobj.make_lm_query(cfg, params)[3]
    pts = torch.rand(3, 4, cfg.d_model, generator=torch.Generator().manual_seed(3))
    both = value(cps, pts)
    single = torch.stack([value(cps, pts[:, k]) for k in range(4)], dim=1)
    scale = float(both.abs().max())
    torch.testing.assert_close(both, single, rtol=0, atol=1e-6 * scale)
    # the same sequences as one group: another capacity, other drops, one aux
    gains = mobj.lm_gains(params["final_norm"], cps.scale, pts)
    every = lambda t: t[:, None].expand(3, 4, *t.shape[1:]).reshape(-1, t.shape[-1])
    final = gains[:, :, None, None, :].expand(3, 4, 2, 1, -1).reshape(24, 1, -1)
    _, merged = forward(dict(params, final_norm=final), cfg,
                             {"tokens": every(cps.batches_tokens)}, ShardingPolicy())
    _, grouped = forward(dict(params, final_norm=final), cfg,
                              {"tokens": every(cps.batches_tokens)}, ShardingPolicy(),
                              groups=12)
    assert abs(float(merged[0]) - float(grouped.mean())) > 1e-4, (merged, grouped)


# -- the engine on the objective -----------------------------------------------


def hold_x(got, want, truth, what):
    """The iterates: ``TA.assert_tracks``'s rule (within ``TA.X_TOL`` of the
    reference; else the port within it of the float64 witness and no
    further from it than the reference).  On this objective F moves in its
    sixth decimal over three rounds, so a surrogate gradient component
    can sit at float32's rounding of the queries, and Adam turns its sign
    into a whole step of eta on that coordinate: a float32 run of either
    side can leave the float64 run by eta there.  Where the port lies
    beyond ``TA.X_TOL`` from float64, DESIGN.md Sec. 2.4's rule for what
    is not well posed holds: the port no further from float64 than the
    reference, in the largest difference and in the count of coordinates
    moved by more than eta/2 (ROADMAP Queue C, "Adam sign flips on the LM
    objective")."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    gap = np.abs(got - want).max()
    if gap <= TA.X_TOL:
        return
    t = truth().numpy()
    e_port, e_ref = np.abs(got - t).max(), np.abs(want - t).max()
    eta = TA.KW["eta"]
    flips = lambda a: int((np.abs(a - t) > eta / 2).sum())
    print(f"{what}: port vs reference {gap:.3e} > {TA.X_TOL:g}; from float64: port "
          f"{e_port:.3e} ({flips(got)} coordinates beyond eta/2), reference {e_ref:.3e} "
          f"({flips(want)})")
    assert e_port <= e_ref, (what, gap, e_port, e_ref)
    if e_port > TA.X_TOL:
        assert flips(got) <= flips(want), (what, flips(got), flips(want))


PORT_ENGINE = """
import dataclasses, importlib, importlib.util, sys, types
from pathlib import Path
import torch
spec = importlib.util.spec_from_file_location("_ta", sys.argv[1])
TA = importlib.util.module_from_spec(spec)
spec.loader.exec_module(TA)
arch, kw, rounds, rparams, robj, draws = torch.load(sys.argv[2], weights_only=False)

def run(pkg, configs, params, obj, rec):
    cfg = dataclasses.replace(configs.get_config(arch, "smoke"), dtype="float32")
    query, glob = pkg.mobj.make_lm_query(cfg, pkg.convert.lm_params(params, "cpu"))[:2]
    cps = pkg.convert.lm_objective(types.SimpleNamespace(**obj), "cpu")
    res = pkg.alg.simulate(pkg.alg.AlgoConfig(**kw), 0, cps, query, glob, rounds, draws=rec,
                           chunk=0, device="cpu")
    assert rec.exhausted()
    return res.f_values, res.xs, res.queries

rec = TA.RecordedDraws()
rec.banks, rec.deltas_, rec.noise_, rec.directions_ = draws
rec64 = rec.widened()
import repro_torch, repro_torch.configs
port = types.SimpleNamespace(alg=importlib.import_module("repro_torch.core.algorithms"),
                             mobj=importlib.import_module("repro_torch.core.model_objectives"),
                             convert=importlib.import_module("repro_torch.convert"))
got = run(port, repro_torch.configs, rparams, robj, rec)
p64 = TA.float64_port(Path(sys.argv[4]))
truth = run(p64, importlib.import_module("repro_torch_f64.configs"), TA.wide(rparams),
            TA.wide(robj), rec64)
torch.save((got, truth), sys.argv[3])
"""


def _one_thread(code, *args):
    """``code`` in a child Python whose torch uses one CPU thread
    (``OMP_NUM_THREADS=1`` in the child's environment only): under the
    test runner's parallel workers torch's OpenMP regions oversubscribe
    the cores, and an engine's loop of forward passes slows by tens of
    times (ROADMAP Guards)."""
    src = str(ROOT / "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [src, os.environ.get("PYTHONPATH")])))
    res = subprocess.run([sys.executable, "-c", code, *args], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]


@pytest.mark.parametrize("lm32", ENGINE_ARCHS, indirect=True)
def test_lm_engine_matches_reference(lm32, tmp_path):
    """Three rounds of the deferred engine (``chunk=0``) on the float32
    variant at d=128, N=3, cap=16, M=32 on the reference's draws (jamba:
    its MoE and Mamba2 layers inside ``simulate``, each query its own
    group): exact
    queries, F within 1e-3 through ``TA.assert_tracks`` and x through
    ``hold_x``.  The port and its float64 witness (the float64 port on the
    same parameters, batches and draws) run in a child Python on one
    thread (``_one_thread``); ``-s`` prints each side's distance."""
    d, rounds = lm32["cfg"].d_model, 3
    kw = dict(TA.KW, dim=d)
    key = jax.random.PRNGKey(1)
    rquery, rglobal = lm32["ref"][:2]
    want = ralg.simulate(ralg.AlgoConfig(**kw), key, lm32["robj"], rquery, rglobal, rounds,
                         chunk=0)
    rec = TA._recorded_simulate_draws(alg.AlgoConfig(**kw), key, rounds)
    torch.save((lm32["arch"], kw, rounds, to_np(lm32["rparams"]),
                to_np(lm32["robj"]._asdict()), (rec.banks, rec.deltas_, rec.noise_,
                                                rec.directions_)), tmp_path / "in.pt")
    _one_thread(PORT_ENGINE, str(Path(__file__).resolve().parent / "test_torch_algorithms.py"),
                str(tmp_path / "in.pt"), str(tmp_path / "out.pt"), str(tmp_path / "f64"))
    (f, xs, queries), (f64, xs64, _) = torch.load(tmp_path / "out.pt", weights_only=False)
    print(f"{lm32['cfg'].name}: max|dF| {np.abs(f.numpy() - N_(want.f_values)).max():.3e}, "
          f"max|dx| {np.abs(xs.numpy() - N_(want.xs)).max():.3e}")
    np.testing.assert_array_equal(queries.numpy(), N_(want.queries))
    assert np.isfinite(f.numpy()).all()
    TA.assert_tracks(f, want.f_values, lambda: f64, TA.F_TOL, "F")
    hold_x(xs, want.xs, lambda: xs64, "x")


# -- the command line ----------------------------------------------------------


def _child(argv) -> subprocess.CompletedProcess:
    """The launcher in a child Python on one CPU thread (``OMP_NUM_THREADS=1``
    in the child's environment only; tests/test_torch_launch.py's
    ``_main_one_thread``)."""
    src = str(ROOT / "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [src, os.environ.get("PYTHONPATH")])))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.fedzoo", "--device", "cpu",
                           *argv], env=env, capture_output=True, text=True, timeout=600)


LM_CLI = ["--objective", "lm", "--clients", "3", "--rounds", "4", "--local-steps", "2",
          "--features", "32", "--traj-cap", "16", "--chunk", "2"]


def test_cli_lm_runs_and_resumes(tmp_path):
    """``--objective lm`` on qwen1.5 (by its published name) and mamba2: the
    SMOKE model at d = d_model = 128, a finite F in every row; the run
    identity holds the architecture, so a resume with another ``--arch``
    raises, and the same one (by its id) resumes bit for bit."""
    rows = lambda out: [line for line in out.splitlines() if line.startswith("  round")]
    ckpt = str(tmp_path / "qwen")
    first = _child(LM_CLI + ["--arch", "qwen1.5-0.5b", "--ckpt-dir", ckpt])
    assert first.returncode == 0, first.stderr[-4000:]
    assert first.stdout.startswith("objective=lm dim=128 clients=3 algo=fzoos\n")
    assert len(rows(first.stdout)) == 5 and "nan" not in first.stdout
    shutil.rmtree(os.path.join(ckpt, "step_00000004"))
    other = _child(LM_CLI + ["--arch", "mamba2-370m", "--ckpt-dir", ckpt])
    assert other.returncode != 0 and "cannot resume it with objective=" in other.stderr
    again = _child(LM_CLI + ["--arch", "qwen1_5_0_5b", "--ckpt-dir", ckpt])
    assert again.returncode == 0, again.stderr[-4000:]
    assert rows(again.stdout) == rows(first.stdout)
    mamba = _child(LM_CLI + ["--arch", "mamba2-370m", "--chunk", "0"])
    assert mamba.returncode == 0, mamba.stderr[-4000:]
    assert mamba.stdout.startswith("objective=lm dim=128 clients=3 algo=fzoos\n")
    fx = next(line for line in mamba.stdout.splitlines() if line.startswith("F(x_0)"))
    assert np.isfinite([float(w) for w in fx.split()[2:9:3]]).all(), fx


@pytest.mark.parametrize("arch, item", [("whisper-base", "reference's gap")])
def test_cli_lm_unported_families_exit(capsys, arch, item):
    """whisper-base (the encoder-decoder) exits naming the reference's gap,
    before any run."""
    from repro_torch.launch import fedzoo

    with pytest.raises(SystemExit, match=item):
        fedzoo.main(["--device", "cpu", "--objective", "lm", "--arch", arch, "--rounds", "1"])
    assert "F(x_0)" not in capsys.readouterr().out


NEW_CLI = r"""
import contextlib, io, sys
from repro_torch.launch import fedzoo
for arch in sys.argv[2:]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fedzoo.main(["--device", "cpu", "--arch", arch, *sys.argv[1].split()])
    print(f"=== {arch}\n{out.getvalue()}", end="")
"""


@pytest.fixture(scope="module")
def new_cli_runs():
    """``--objective lm --rounds 10`` (``LM_CLI``'s small flags otherwise) on
    each moe, hybrid and vlm architecture, by its published name, in one
    child Python on one thread: {arch: stdout}."""
    archs = ["llama4-scout-17b-16e", "llama4-maverick-400b-a17b", "jamba-1.5-large-398b",
             "qwen2-vl-7b"]
    flags = " ".join(LM_CLI[:5] + ["10"] + LM_CLI[6:])
    src = str(ROOT / "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [src, os.environ.get("PYTHONPATH")])))
    res = subprocess.run([sys.executable, "-c", NEW_CLI, flags, *archs], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    parts = res.stdout.split("=== ")[1:]
    return {part.split("\n", 1)[0]: part.split("\n", 1)[1] for part in parts}


@pytest.mark.parametrize("arch", ["llama4-scout-17b-16e", "llama4-maverick-400b-a17b",
                                  "jamba-1.5-large-398b", "qwen2-vl-7b"])
def test_cli_lm_runs_the_new_families(new_cli_runs, arch):
    """The moe, hybrid and vlm families run under ``--objective lm``: the
    SMOKE model at d = d_model = 128, 10 rounds, a finite F in every row."""
    out = new_cli_runs[arch]
    assert out.startswith("objective=lm dim=128 clients=3 algo=fzoos\n")
    rows = [line for line in out.splitlines() if line.startswith("  round")]
    assert len(rows) == 11 and "nan" not in out and "round   10" in rows[-1]
    fx = next(line for line in out.splitlines() if line.startswith("F(x_0)"))
    assert np.isfinite([float(w) for w in fx.split()[2:9:3]]).all(), fx
