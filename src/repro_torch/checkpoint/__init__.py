"""Chunk-boundary checkpoints of the port (port of ``repro.checkpoint``):
the reference's single-file npz + JSON format."""

from repro_torch.checkpoint.io import (  # noqa: F401
    AsyncCheckpointWriter,
    CorruptCheckpointError,
    latest_step,
    list_steps,
    load_meta,
    prepare_pool_state,
    prepare_round_state,
    restore,
    restore_pool_state,
    restore_round_state,
    restore_train_state,
    save,
    save_train_state,
    write_round_state,
)
