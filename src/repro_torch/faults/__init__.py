"""Deterministic fault injection for the round engine (port of
``repro.faults``).

``injector``: the per-(round, client) fault draws, bit for bit the
reference's, and the ``FaultConfig`` that ``core.algorithms.run_round``,
``simulate`` and ``core.rounds.run_rounds`` take.  ``corrupt``: damage to
a checkpoint step on the host (``truncate_npz``, ``flip_bytes``), the
storage faults that a restore falls back past.
"""

from repro_torch.faults import corrupt
from repro_torch.faults.corrupt import flip_bytes, truncate_npz
from repro_torch.faults.injector import (
    KINDS,
    FaultConfig,
    FaultDraw,
    FaultSchedule,
    draw_faults,
    effective_config,
    schedule_table,
)

__all__ = ["KINDS", "FaultConfig", "FaultDraw", "FaultSchedule", "corrupt", "draw_faults",
           "effective_config", "flip_bytes", "schedule_table", "truncate_npz"]
