"""The port's command line (``repro_torch.launch``) against the reference's
(``repro.launch``).

The flag surface is the reference's: ``add_algo_flags`` and
``add_engine_flags`` install the same options with the same destinations,
types, defaults and choices, and the launcher's parser adds only
``--device``.  The reference's launcher tests (tests/test_launchers.py)
run again on ``repro_torch.launch.fedzoo.main`` with ``--device cpu``;
a second call with the same ``--ckpt-dir`` resumes and prints the same
final row, and one with another seed or objective argument raises; the
model-backed objectives (attack, metric) run at their own widths; the
pool and fault flags run the pooled and faulted engines, a poisoned run
rolls back; every objective or flag whose module is not ported yet exits
naming its ROADMAP item.
"""

import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import common as rcommon
from repro.launch import fedzoo as rfedzoo
from repro_torch.checkpoint import io
from repro_torch.core import algorithms as alg
from repro_torch.core import graphs
from repro_torch.core import model_objectives as mobj
from repro_torch.launch import common, fedzoo


def _actions(ap: argparse.ArgumentParser) -> dict:
    """Option strings -> what parsing them does, for every option but -h."""
    return {tuple(a.option_strings): (a.dest, a.default, a.choices, a.type, a.nargs, a.const,
                                      type(a).__name__)
            for a in ap._actions if a.dest != "help"}


def _shared_parser(mod) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    mod.add_algo_flags(ap)
    mod.add_engine_flags(ap)
    return ap


def _reference_launcher_parser(monkeypatch) -> argparse.ArgumentParser:
    """The parser ``repro.launch.fedzoo.main`` builds, caught at its parse."""
    caught = {}

    class Caught(Exception):
        pass

    def catch(self, *args, **kwargs):
        caught["ap"] = self
        raise Caught

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(Caught):
            rfedzoo.main()
    return caught["ap"]


def test_flag_surface_matches_the_reference(monkeypatch):
    """The shared flags are the reference's, option for option; the
    launcher's parser is the reference launcher's plus ``--device``."""
    assert _actions(_shared_parser(common)) == _actions(_shared_parser(rcommon))
    assert common._FLAG_FIELDS == rcommon._FLAG_FIELDS
    ref, port = _actions(_reference_launcher_parser(monkeypatch)), _actions(fedzoo.parser())
    assert set(port) - set(ref) == {("--device",)}
    assert {k: v for k, v in port.items() if k != ("--device",)} == ref
    assert port[("--device",)][1] == "cuda"
    defaults = fedzoo.parser().parse_args([])
    assert (defaults.lengthscale, defaults.gp_noise, defaults.features, defaults.traj_cap,
            defaults.dim, defaults.clients) == (0.5, 1e-5, 1000, 192, 300, 5)


def test_config_from_args_round_trip():
    """Every flag lands on its AlgoConfig field (tests/test_launchers.py:54)."""
    ap = _shared_parser(common)
    args = ap.parse_args([
        "--algo", "fzoos", "--local-steps", "3", "--eta", "0.02", "--q", "4",
        "--features", "32", "--traj-cap", "24", "--lengthscale", "0.7",
        "--gp-noise", "1e-4", "--gamma-mode", "const", "--gamma-const", "0.5",
        "--no-defer-repair", "--eval-every", "4",
    ])
    cfg = common.config_from_args(args, dim=6, n_clients=3)
    assert cfg.name == "fzoos" and cfg.dim == 6 and cfg.n_clients == 3
    assert cfg.local_steps == 3 and cfg.eta == 0.02 and cfg.q == 4
    assert cfg.n_features == 32 and cfg.traj_capacity == 24
    assert cfg.lengthscale == 0.7 and cfg.noise == 1e-4
    assert cfg.gamma_mode == "const" and cfg.gamma_const == 0.5
    assert cfg.defer_repair is False and cfg.use_factor_cache is True
    assert args.eval_every == 4
    assert common.config_from_args(ap.parse_args(["--noise", "3e-5"]), dim=4,
                                   n_clients=2).noise == 3e-5
    cfg2 = common.config_from_args(ap.parse_args(["--no-factor-cache"]), dim=4, n_clients=2)
    assert cfg2.use_factor_cache is False and not cfg2.deferred
    assert common.config_from_args(ap.parse_args([]), dim=4, n_clients=2).deferred
    with pytest.raises(TypeError):
        common.make_config("fzoos", dim=4, n_clients=2, not_a_field=1)


def _main(capsys, argv) -> str:
    fedzoo.main(["--device", "cpu", *argv])
    return capsys.readouterr().out


def _main_one_thread(capsys, argv) -> str:
    """``_main`` in a child Python whose torch uses one CPU thread
    (``OMP_NUM_THREADS=1`` in the child's environment only): the
    model-backed objectives train their victims first, and under the test
    runner's parallel workers torch's OpenMP regions oversubscribe the
    cores and slow that loop by tens of times."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [src, os.environ.get("PYTHONPATH")])))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.fedzoo", "--device", "cpu",
                          *argv], env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


SMALL = ["--dim", "6", "--clients", "4", "--rounds", "7",
         "--local-steps", "2", "--features", "16", "--traj-cap", "16", "--lengthscale", "0.5",
         "--gp-noise", "1e-5", "--gamma-mode", "inv_t"]


@pytest.mark.parametrize("objective, algo, extra, dim, clients, run", [
    ("quadratic", "fzoos", ["--chunk", "5"], 6, 4, _main),
    ("quadratic", "fedzo", ["--chunk", "0"], 6, 4, _main),
    ("sinquad", "fzoos", ["--no-defer-repair"], 6, 4, _main),
    ("attack", "fzoos", ["--chunk", "5", "--clients", "1"], 256, 1, _main_one_thread),
    ("metric", "fzoos", ["--chunk", "0"], 119, 4, _main_one_thread),
], ids=["fzoos", "fedzo_loop", "sinquad_per_client", "attack", "metric"])
def test_cli_smoke(capsys, objective, algo, extra, dim, clients, run):
    """End to end on the quadratic (and the sinquad), the reference's lines;
    the table always shows the final round (tests/test_launchers.py:40).
    The attack (16 x 16 images; one victim, trained on 512 of them)
    and the metric (the 16 x 7 + 7 output layer) ignore ``--dim``, as the
    reference's do; they run through ``python -m`` on one CPU thread
    (``_main_one_thread``)."""
    out = run(capsys, SMALL + ["--objective", objective, "--algo", algo, *extra])
    assert out.startswith(f"objective={objective} dim={dim} clients={clients} algo={algo}\n")
    assert "queries/round/client = " in out and "F(x_0) = +" in out and "F(x_R) = " in out
    assert "round    7" in out and "round    0  F = " in out


def test_cli_eval_every(capsys):
    """``--eval-every`` leaves NaN rows but always the final round."""
    out = _main(capsys, ["--dim", "4", "--clients", "2", "--rounds", "5", "--local-steps", "1",
                         "--features", "8", "--traj-cap", "8", "--eval-every", "5",
                         "--chunk", "5"])
    assert "round    5" in out and "nan" in out


def test_cli_final_round_not_on_stride(capsys):
    """rounds=25: stride 2, and the final round 25 is shown."""
    out = _main(capsys, ["--dim", "4", "--clients", "2", "--rounds", "25", "--local-steps",
                         "1", "--algo", "fedzo", "--q", "2", "--chunk", "25"])
    assert "round   24" in out and "round   25" in out


FD_CKPT = ["--dim", "4", "--clients", "2", "--rounds", "4", "--local-steps", "1", "--algo",
           "fedzo", "--q", "2", "--chunk", "2"]


def test_cli_ckpt_flags_and_resume(capsys, tmp_path):
    """``--ckpt-dir``/``--ckpt-every``/``--sync-ckpt`` leave a complete last
    step (tests/test_launchers.py:113); with the last step removed, the
    same command resumes from the step before it (at ``--ckpt-every 2``
    there is none, and it starts again) and prints the same result rows."""
    ckpt = str(tmp_path / "cli_ckpt")
    argv = FD_CKPT + ["--ckpt-dir", ckpt, "--ckpt-every", "2", "--sync-ckpt"]
    first = _main(capsys, argv)
    assert io.list_steps(ckpt) == [4]
    rows = lambda out: [line for line in out.splitlines() if line.startswith("  round")]
    fx = lambda out: next(line for line in out.splitlines()
                          if line.startswith("F(x_0)")).split("   (")[0]
    for every in ("1", "2"):
        shutil.rmtree(ckpt)
        _main(capsys, FD_CKPT + ["--ckpt-dir", ckpt, "--ckpt-every", every])
        steps = io.list_steps(ckpt)
        shutil.rmtree(os.path.join(ckpt, f"step_{steps[-1]:08d}"))
        again = _main(capsys, FD_CKPT + ["--ckpt-dir", ckpt, "--ckpt-every", every])
        assert steps == ([2, 4] if every == "1" else [4]) and io.latest_step(ckpt) == 4
        assert rows(again) == rows(first) and fx(again) == fx(first)


@pytest.mark.parametrize("argv, item", [
    (["--objective", "lm", "--arch", "whisper-base"], "reference's gap"),
    (["--distributed"], "A11"),
], ids=["lm", "distributed"])
def test_unported_flags_exit_naming_their_item(capsys, argv, item):
    """An objective or flag whose module is not ported exits with a message
    that names its ROADMAP item, before any run."""
    with pytest.raises(SystemExit, match=item):
        fedzoo.main(["--device", "cpu", "--dim", "4", "--clients", "2", "--rounds", "1",
                     *argv])
    assert "F(x_0)" not in capsys.readouterr().out


POOLED = ["--dim", "4", "--clients", "2", "--rounds", "4", "--local-steps", "1", "--features",
          "8", "--traj-cap", "8", "--chunk", "2"]


@pytest.mark.parametrize("argv, printed", [
    (["--cohort", "2"], "cohort=2"),
    (["--pool-size", "8", "--cohort", "2"], "clients=8 algo=fzoos cohort=2"),
    (["--drop-rate", "0.1"], "mean drop_rate"),
    (["--nan-rate", "0.2", "--fault-until", "3"], "mean quarantine_rate"),
    (["--fault-tolerance"], "faults: FaultConfig(seed=0, drop_rate=0.0"),
], ids=["cohort", "pool", "drop", "nan", "tolerance"])
def test_pool_and_fault_flags_run(capsys, argv, printed):
    """The pool flags (``--pool-size`` overrides ``--clients``) and the
    fault flags run the engine as the reference's launcher does and print
    its lines."""
    out = _main(capsys, POOLED + argv)
    assert printed in out and "round    4" in out and "F(x_R) = " in out


def test_pool_flags_validated():
    """tests/test_pool.py:345 on the port's ``pool_from_args``."""
    ap = argparse.ArgumentParser()
    common.add_pool_flags(ap)
    with pytest.raises(SystemExit, match="cohort"):
        common.pool_from_args(ap.parse_args(["--pool-size", "16"]))
    assert common.pool_from_args(ap.parse_args(["--pool-size", "16", "--cohort", "4"])) == (16, 4)
    with pytest.raises(SystemExit, match="cohort"):
        common.pool_from_args(ap.parse_args(["--cohort", "0"]))


def test_faults_from_args_matches_the_reference():
    """Each flag set gives the reference's ``FaultConfig`` (its repr) or,
    like it, None."""
    for argv in ([], ["--drop-rate", "0.1", "--fault-seed", "4"], ["--fault-tolerance"],
                 ["--nan-rate", "0.2", "--fault-from", "2", "--fault-until", "5",
                  "--no-fault-tolerance"], ["--inf-rate", "0.3", "--fault-until", "0"]):
        args = _shared_parser(common).parse_args(argv)
        got, want = common.faults_from_args(args), rcommon.faults_from_args(args)
        assert repr(got) == repr(want), argv


def test_cli_rollback(capsys, tmp_path):
    """``--no-fault-tolerance --nan-rate`` with ``--ckpt-dir``: the poisoned
    chunk rolls back, tolerance is forced on and the run ends finite;
    ``--max-rollbacks 0`` fails it."""
    argv = POOLED + ["--clients", "5", "--nan-rate", "0.5", "--no-fault-tolerance",
                     "--ckpt-dir", str(tmp_path / "a")]
    out = _main(capsys, argv)
    assert "ROLLBACK 1/3" in out and "FORCED ON" in out and "nan" not in out.split("F(x_0)")[1]
    with pytest.raises(FloatingPointError, match="max_rollbacks=0 exhausted"):
        _main(capsys, POOLED + ["--clients", "5", "--nan-rate", "0.5", "--no-fault-tolerance",
                                "--ckpt-dir", str(tmp_path / "b"), "--max-rollbacks", "0"])


def _child(argv) -> subprocess.CompletedProcess:
    """The launcher in a child Python on one CPU thread (``_main_one_thread``)."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [src, os.environ.get("PYTHONPATH")])))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.fedzoo", "--device", "cpu",
                           *argv], env=env, capture_output=True, text=True, timeout=600)


def test_cli_resume_checks_the_seed_and_the_objective(capsys, tmp_path):
    """The run identity holds the seed and the objective's arguments: a
    resume with another ``--seed`` (the quadratic) or another
    ``--p-shared`` (the metric, in a child Python on one thread) raises
    instead of joining two runs; the same flags resume bit for bit."""
    rows = lambda out: [line for line in out.splitlines() if line.startswith("  round")]
    quad = FD_CKPT + ["--ckpt-dir", str(tmp_path / "quad")]
    first = _main(capsys, quad)
    shutil.rmtree(os.path.join(str(tmp_path / "quad"), "step_00000004"))
    with pytest.raises(ValueError, match="seed=0, cannot resume it with seed=1"):
        _main(capsys, quad + ["--seed", "1"])
    assert rows(_main(capsys, quad)) == rows(first)

    metric = SMALL + ["--objective", "metric", "--rounds", "4", "--chunk", "2", "--ckpt-dir",
                      str(tmp_path / "metric")]
    first = _child(metric)
    assert first.returncode == 0, first.stderr[-4000:]
    shutil.rmtree(os.path.join(str(tmp_path / "metric"), "step_00000004"))
    other = _child(metric + ["--p-shared", "0.3"])
    assert other.returncode != 0 and "cannot resume it with objective=" in other.stderr
    again = _child(metric)
    assert again.returncode == 0, again.stderr[-4000:]
    assert rows(again.stdout) == rows(first.stdout)


def test_cli_defaults_to_the_card():
    """Without ``--device`` the launcher asks for CUDA, and raises where
    there is none (no silent fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fedzoo.main(["--dim", "4", "--clients", "2", "--rounds", "1"])


def test_cuda_objective_builds_are_identical():
    """On the card, two builds of one seed give the same attack and metric
    objectives bit for bit (the victims' training has no scatter in its
    backward), as a command-line resume, which builds the objective again,
    needs; at the launcher's widths and defaults (N=10 and N=7, P=0.5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's training is what is compared")
    seed = alg.stream_seed(0, 0)
    for make, n in ((lambda: mobj.make_attack_objective(seed, 10, p_shared=0.5)[0], 10),
                    (lambda: mobj.make_metric_objective(seed, 7, p_shared=0.5)[0], 7)):
        first, second = graphs.tensors(make()), graphs.tensors(make())
        assert len(first) == len(second) and first[0].is_cuda and first[0].shape[0] == n
        assert all(torch.equal(a, b) for a, b in zip(first, second))
