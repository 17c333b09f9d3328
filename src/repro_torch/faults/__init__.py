"""Deterministic fault injection for the round engine (port of
``repro.faults``).

``injector``: the per-(round, client) fault draws, bit for bit the
reference's, and the ``FaultConfig`` that ``core.algorithms.run_round``,
``simulate`` and ``core.rounds.run_rounds`` take.  The reference's
``corrupt`` (checkpoint corruption for the rollback tests) comes with
chunk rollback (ROADMAP Queue A, A10b).
"""

from repro_torch.faults.injector import (
    KINDS,
    FaultConfig,
    FaultDraw,
    FaultSchedule,
    draw_faults,
    effective_config,
    schedule_table,
)

__all__ = ["KINDS", "FaultConfig", "FaultDraw", "FaultSchedule", "draw_faults",
           "effective_config", "schedule_table"]
