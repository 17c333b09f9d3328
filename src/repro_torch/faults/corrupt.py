"""Checkpoint corruption on the host (port of ``repro.faults.corrupt``): the
storage half of the fault model.

Checkpoint steps are written atomically (a ``.tmp`` directory renamed into
place), so what survives into a complete step directory is damage of the
storage kind: a truncated ``arrays.npz`` (the file lost its tail) or
flipped bytes inside it.  These helpers make exactly those states on a real
checkpoint directory, in either layout (``step_<N>/arrays.npz``, or a file
per shard under ``step_<N>/shard_<p>/``, as the client pool writes), so the
tests can drive the restore fallback and chunk rollback end to end
(``checkpoint/io.py`` catches both through the per-leaf checksums and the
zip members' CRCs and raises ``CorruptCheckpointError``).  The damage is
the reference's byte for byte: the same bytes are cut or flipped.
"""

from __future__ import annotations

import os
import random


def _step_dir(root: str, step: int) -> str:
    path = os.path.join(root, f"step_{step:08d}")
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint step {step} under {root!r}")
    return path


def _npz_paths(root: str, step: int, shard: int | None) -> list[str]:
    """The ``arrays.npz`` file(s) of one step: the single file, or the given
    shard's (``shard=None``: every shard's)."""
    path = _step_dir(root, step)
    single = os.path.join(path, "arrays.npz")
    if os.path.isfile(single):
        return [single]
    shards = sorted(d for d in os.listdir(path)
                    if d.startswith("shard_") and os.path.isdir(os.path.join(path, d)))
    if shard is not None:
        shards = [s for s in shards if s == f"shard_{shard:05d}"]
    out = [os.path.join(path, s, "arrays.npz") for s in shards]
    if not out:
        raise FileNotFoundError(f"no arrays.npz under {path!r} (shard={shard})")
    return out


def truncate_npz(root: str, step: int, shard: int | None = None,
                 keep_fraction: float = 0.5) -> list[str]:
    """Tear a step's array file(s): keep only the leading ``keep_fraction``.

    Truncation destroys the zip central directory at the end of the file,
    as a torn write does; a restore must reject the step.  Returns the
    paths damaged."""
    if not 0.0 <= keep_fraction < 1.0:
        raise ValueError(f"keep_fraction={keep_fraction} outside [0, 1)")
    paths = _npz_paths(root, step, shard)
    for p in paths:
        size = os.path.getsize(p)
        with open(p, "r+b") as f:
            f.truncate(max(int(size * keep_fraction), 1))
    return paths


def flip_bytes(root: str, step: int, shard: int | None = None, n_bytes: int = 8,
               seed: int = 0) -> list[str]:
    """Flip ``n_bytes`` payload bytes, drawn from ``random.Random(seed)``, in
    a step's array file(s).

    The file's length and zip directory stay intact, so only the content
    checks (the per-leaf checksums, the members' CRCs) can catch it.  The
    first KiB is never touched: damage there fails to parse at once, and the
    point is content that parses.  Returns the paths damaged."""
    paths = _npz_paths(root, step, shard)
    rng = random.Random(seed)
    for p in paths:
        size = os.path.getsize(p)
        with open(p, "r+b") as f:
            for _ in range(n_bytes):
                off = rng.randrange(min(1024, size - 1), size)
                f.seek(off)
                b = f.read(1)
                f.seek(off)
                f.write(bytes([b[0] ^ 0xFF]))
    return paths
