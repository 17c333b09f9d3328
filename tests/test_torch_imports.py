"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` use
neither JAX nor the reference package, and entry points refuse to fall
back to the CPU silently."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {list(_modules())!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_fault_schedule_imports_neither_jax_nor_the_reference():
    """``repro_torch.faults`` computes the reference's threefry draws itself:
    importing it and drawing a schedule loads neither JAX nor ``repro``."""
    assert "repro_torch.faults" in _modules() and "repro_torch.faults.injector" in _modules()
    code = (
        "import sys\n"
        "from repro_torch.faults import FaultConfig, schedule_table\n"
        "tab = schedule_table(FaultConfig(seed=3, drop_rate=0.5), 4, 3)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', int(tab['drop'].sum()))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_pool_and_corrupt_import_neither_jax_nor_the_reference():
    """``repro_torch.core.pool`` samples the reference's cohorts with its own
    threefry and ``repro_torch.faults.corrupt`` damages steps with the
    standard library: importing them and using them loads neither JAX nor
    ``repro``."""
    assert {"repro_torch.core.pool", "repro_torch.faults.corrupt"} <= set(_modules())
    code = (
        "import os, sys, tempfile\n"
        "from repro_torch.core.pool import sample_cohort\n"
        "from repro_torch.faults import corrupt\n"
        "c = sample_cohort(7, 3, 256, 5)\n"
        "d = tempfile.mkdtemp(); os.makedirs(os.path.join(d, 'step_00000001'))\n"
        "open(os.path.join(d, 'step_00000001', 'arrays.npz'), 'wb').write(bytes(4096))\n"
        "corrupt.flip_bytes(d, 1); corrupt.truncate_npz(d, 1)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', c.tolist())\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", [*sorted(PKG.rglob("*.py")), ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_the_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (path, name)


def test_simulate_without_device_needs_cuda():
    from repro_torch.core import algorithms as alg
    from repro_torch.core import objectives as obj

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    cfg = alg.AlgoConfig(name="fzoos", dim=2, n_clients=2, traj_capacity=4, n_features=4)
    q = obj.make_quadratic(0, 2, 2, 1.0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        alg.simulate(cfg, 0, q, obj.quadratic_query, obj.quadratic_global_value, 1, chunk=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        obj.make_quadratic(0, 2, 2, 1.0)
