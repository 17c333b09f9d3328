"""Sharding policy (port of ``repro.sharding.rules``, its policy only).

``ShardingPolicy`` keeps the reference's fields and defaults.  On one card
the model functions read ``attn_chunk`` (query-chunked attention for long
sequences); the other fields are the knobs of a sharded run.  The mesh
functions (``constrain``, ``spec_with_fallback``, ``param_pspecs``) come
with the distributed engine (ROADMAP Queue A, A11) and the launchers
(A13c); until then the port has no stand-in for them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Performance-relevant distribution knobs."""

    seq_parallel: bool = True  # residual stream seq-sharded over 'model' between blocks
    shard_heads: bool = True  # attention projections column-sharded over 'model'
    zero1: bool = True  # optimizer moments additionally sharded over 'data'
    remat: bool = True  # activation checkpointing on the layer stack
    fsdp: bool = True  # shard params (and moments) over 'data' too (ZeRO-3-style)
    attn_chunk: int = 2048  # query-chunked attention for long sequences (0 = off)
    donate: bool = True  # donate train state / decode cache buffers (aliasing)
    cache_seq_axis: Optional[str] = "model"  # decode KV-cache sequence shard axis
    scan_unroll: bool = False  # fully unroll layer stacks (cost accounting)
    batch_axes: tuple[str, ...] = ("data",)  # expanded to ("pod","data") multi-pod
