"""``chip_smoke.check_engine_inputs`` on the CPU.

The smoke holds each kernel against its plain version and float64 on the
calls a small engine makes (B1/B3 on the deferred engine, B7a/B8a on the
per-client one, B5/B6/B9 on both).  On the CPU every wrapper runs its plain
version, so the check is plain against plain and must pass; what this test
holds is that it records every call of the seven ops, with the keyword
arguments the engines pass (lengthscale, prior, the block pins), as many
times as the engine's schedule makes them: per round of T local steps on N
clients, the deferred engine scores once per step and once at the round
end and takes one gradient mean per step for all clients together, the
per-client engine does the same once per client; with the scoring's cap
tile pinned (``score_block_cap``, the route B2 and B7b take) the scoring
calls carry the pin, with the gradient's (``grad_block_cap``, B4 and B8b)
the gradient calls.
"""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
T, R, N = 3, 3, 3  # check_engine_inputs' small engine: local steps, rounds, clients


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("engine,per", [({}, 1), ({"defer_repair": False}, N),
                                        ({"score_block_cap": 8}, 1),
                                        ({"defer_repair": False, "score_block_cap": 8}, N),
                                        ({"grad_block_cap": 8}, 1),
                                        ({"defer_repair": False, "grad_block_cap": 8}, N)],
                         ids=["deferred", "per_client", "deferred_tiled", "per_client_tiled",
                              "deferred_grad_tiled", "per_client_grad_tiled"])
def test_check_engine_inputs_records_every_call(engine, per):
    calls = _smoke().check_engine_inputs("cpu", "cpu", **engine)
    batched = per == 1
    want = {
        "rff_features": R, "rff_grad_rows": 2 * T * R, "sqexp": 1 + (2 * T + 1) * R,
        "uncertainty_scores_clients": (T * R + R) if batched else 0,
        "grad_mean_clients": T * R if batched else 0,
        "uncertainty_scores": 0 if batched else per * (T * R + R),
        "grad_mean_batch": 0 if batched else per * T * R,
    }
    assert {name: len(recs) for name, recs in calls.items()} == want
    for name in ("uncertainty_scores_clients", "uncertainty_scores"):
        for _, kwargs, out in calls[name]:
            assert kwargs == dict(lengthscale=0.5, prior=8 / 0.25, block_n=None,
                                  block_cap=engine.get("score_block_cap"))
            assert out.shape[-1] == 12  # active_candidates
    for name in ("grad_mean_clients", "grad_mean_batch"):
        for args, kwargs, out in calls[name]:
            assert kwargs == dict(lengthscale=0.5, block_n=None,
                                  block_cap=engine.get("grad_block_cap"))
            assert out.shape == args[0].shape
    for name in ("rff_features", "rff_grad_rows", "sqexp"):
        assert all(kwargs == {} for _, kwargs, _ in calls[name])
