"""Block sizes of the GP kernels on Hopper.

``select_blocks(kind, ...)`` returns ``(block_n, block_cap)`` for the
scoring ("score") or gradient-mean ("grad") kernels; ``block_cap >= cap``
routes to the resident kernel, a smaller one to the cap-tiled kernel
(``kernels.ops``).  The choice is a pure function of the per-client shape
(n, cap, d), so it is deterministic, needs no cache, and serves the
single-client kernels (one client) and the client-batched ones alike: a
block never spans clients.  The budget is the shared memory one
block may use on an H100 (227 KB); what a block keeps there is the
candidate tile (block_n x d), and per route

* score resident: h and c.x over the whole trajectory (2 block_n cap);
* score tiled:    h_j, h_k, c.x_k tiles (3 block_n block_cap);
* grad resident:  w over the whole trajectory and the product
  (block_n cap + block_n d);
* grad tiled:     one w tile and the product (block_n block_cap + block_n d).

``validate_blocks`` checks a pinned pair (``AlgoConfig.*_block_*``)
against the same budget and the block sizes the kernels are built for.
"""

from __future__ import annotations

#: Shared memory one block may use on Hopper (232,448 bytes).
SMEM_BYTES = 227 * 1024
#: Candidate tiles the CUDA kernels are instantiated for (csrc/common.cuh).
BLOCK_N = (1, 2, 4, 8, 16)
#: Cap tiles tried when the resident route does not fit, largest first.
BLOCK_CAP = (256, 128, 64, 32)
#: Largest candidate tile the tuner picks: eight candidates keep 16 f32
#: accumulators per thread in the scoring sweep and still give one block
#: per 8 candidates of each client.
_DEFAULT_BLOCK_N = 8


def smem_bytes(kind: str, *, block_n: int, block_cap: int, cap: int, d: int) -> int:
    """Shared memory of one block for the route ``block_cap`` selects."""
    resident = block_cap >= cap
    t = cap if resident else block_cap
    words = block_n * d + block_n  # candidate tile and its squared norms
    if kind == "score":
        words += (2 if resident else 3) * block_n * t + 8 * block_n
    elif kind == "grad":
        words += block_n * t + block_n * d + block_n
    else:
        raise ValueError(f"unknown kernel kind {kind!r}")
    return 4 * words


def _fits(kind, bn, bc, cap, d) -> bool:
    return smem_bytes(kind, block_n=bn, block_cap=bc, cap=cap, d=d) <= SMEM_BYTES


def select_blocks(kind: str, *, n: int, cap: int, d: int) -> tuple[int, int]:
    """Deterministic ``(block_n, block_cap)`` for a kernel kind and shape.

    block_n is the smallest instantiated tile covering ``min(n, 8)``
    candidates (n = 1 on the gradient path gives 1: no padded rows).  The
    resident route is taken whenever its shared memory fits; otherwise the
    largest cap tile that fits.
    """
    want = min(max(n, 1), _DEFAULT_BLOCK_N)
    start = next(bn for bn in BLOCK_N if bn >= want)
    for bn in reversed([b for b in BLOCK_N if b <= start]):
        if _fits(kind, bn, cap, cap, d):
            return bn, cap
        for bc in BLOCK_CAP:
            if bc < cap and _fits(kind, bn, bc, cap, d):
                return bn, bc
    raise ValueError(f"no {kind} block fits {SMEM_BYTES} bytes of shared memory at d={d}")


def validate_blocks(kind: str, *, block_n: int, block_cap: int, cap: int, d: int) -> tuple[int, int]:
    """Check a pinned ``(block_n, block_cap)``; raise ``ValueError`` naming
    the block and the budget when the kernels cannot take it."""
    if block_n not in BLOCK_N:
        raise ValueError(f"pinned {kind} block_n={block_n} is not one of {BLOCK_N}")
    if block_cap < 1:
        raise ValueError(f"pinned {kind} block_cap={block_cap} must be positive")
    need = smem_bytes(kind, block_n=block_n, block_cap=block_cap, cap=cap, d=d)
    if need > SMEM_BYTES:
        raise ValueError(
            f"pinned {kind} blocks (block_n={block_n}, block_cap={block_cap}) need {need} "
            f"bytes of shared memory per block at cap={cap}, d={d}, above the "
            f"{SMEM_BYTES}-byte budget; pick smaller AlgoConfig block pins or leave "
            "them unset for the tuner")
    return block_n, block_cap
