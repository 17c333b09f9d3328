"""Block sizes and launch geometry of the GP kernels on Hopper.

``select_blocks(kind, ...)`` returns ``(block_n, block_cap)`` for the
scoring or gradient-mean kernels; ``block_cap >= cap`` routes to the
resident kernel, a smaller one to the cap-tiled kernel (``kernels.ops``).
The kinds are "score" and "grad" for the single-client kernels and
"score_clients" and "grad_clients" for the client-batched ones.  Both
scoring kinds run the same two routes: the resident one is a thread block
cluster per client and candidate tile (``score_cluster_kernel``), with
clusters of up to 8 blocks client-batched and up to 16 for one client
(``cluster_geometry``); the cap-tiled one an h pass, a panel pass and the
sums.  Every gradient route is one cluster kernel (``grad_cluster_kernel``)
whose blocks stream their part of the trajectory in chunks; the routes
differ in the geometry ``grad_geometry`` gives it.  The choice is a pure
function of the kind and the per-client shape (n, cap, d), so it is
deterministic and needs no cache.  The budget is the shared memory one
block may use on an H100 (227 KB); what a block keeps there, per route:

* score and score_clients resident (``score_cluster_kernel``): h over the
  whole trajectory (cap block_n, f64), the candidates (d block_n), c.x of
  the block's rows (rmax block_n), |c|^2 and the cluster's partials (cs
  block_n, f64), STAGES chunks of its columns of B and P in flight (2
  STAGES chunk rmax, f32), and one region holding first its rows of X (rmax
  x rows_ld(d), f32) with the row dot products' partials, then its column
  sums (2 block_n x 256, f64); rmax = ceil(cap / cs);
* score and score_clients tiled: the h pass the candidate tile in f64
  (block_n d), the panel pass STAGES chunks of its rows of B and P and of
  their h (``panel_smem``: at most 160 KB, whatever n); block_cap is the
  panel's rows;
* every gradient route (``grad_smem``): one or two chunks of its rows of X
  (jc x rows_ld(d), f32) and, in f64, the candidates (d block_n), |c|^2, w
  of a chunk (jc block_n), the row dot products' partials and its partial
  sums (block_n d).  The resident routes take a block's whole part as one
  chunk (jc = rmax), so they end where that part no longer fits: at d=300,
  cap 2960 for one client (16 blocks) and 1480 client-batched (8 blocks);
  the tiled routes take chunks of at most block_cap and GRAD_CHUNK rows,
  halved until they fit, so any cap fits.

``cluster_geometry`` gives the cluster kernels' cluster size and chunk
rows, and ``split`` the parts of the trajectory (and of d) each block of a
cluster owns, as ``csrc/common.cuh`` ``split_at`` computes them;
``grad_geometry`` the gradient kernel's cluster size and chunk rows per
route, and ``grad_layout`` the rows and columns of each of its blocks;
``score_tiled_layout`` what each block of the cap-tiled scoring's
passes computes, and ``score_tiled_work`` the f64 work buffer its wrapper
allocates.
``rff_grad_layout`` gives the same for the RFF gradient's kernel (B5):
which features each block of a row's cluster projects in which chunk, and
which output columns it sums; ``rows_route`` which kernel of
``csrc/proj.cuh`` an SE Gram (B9) or RFF features (B6) take, with
``proj_tile`` the tile kernel's tile, ``proj_threads`` and ``proj_smem``
its threads and shared memory and ``proj_tile_layout`` what each of its
blocks computes.
``validate_blocks`` checks a pinned pair (``AlgoConfig.*_block_*``)
against the same budget and the block sizes the kernels are built for.
"""

from __future__ import annotations

#: Shared memory one block may use on Hopper (232,448 bytes).
SMEM_BYTES = 227 * 1024
#: Threads of one block of every GP kernel (csrc/common.cuh kThreads).
THREADS = 256
#: Candidate tiles the CUDA kernels are instantiated for (csrc/common.cuh).
BLOCK_N = (1, 2, 4, 8, 16)
#: Cap tiles tried when the resident route does not fit, largest first.
BLOCK_CAP = (256, 128, 64, 32)
#: Largest candidate tile the tuner picks: eight candidates keep 16
#: accumulators per thread in the scoring sweep and still give one block
#: (or cluster) per 8 candidates of each client; one client's scoring takes
#: 4, so its 50 candidates make 13 clusters.
_DEFAULT_BLOCK_N = {"score": 4}
#: Blocks per cluster of the client-batched resident kernels: the portable
#: cluster size on Hopper (csrc/common.cuh kMaxCluster).
CLUSTER = 8
#: Blocks per cluster of the single-client routes (B7a, B8a, the tiled
#: gradient): the largest (non-portable) size on Hopper (csrc/common.cuh
#: kMaxClusterNonPortable), each block owning about SINGLE_ROWS rows.
SINGLE_CLUSTER = 16
SINGLE_ROWS = 12
#: Trajectory rows of B and P in one staging chunk of the scoring cluster
#: kernel and of the tiled panels, and the chunks in flight
#: (csrc/gp_score.cu kPanelChunk, kStages).
CHUNK_ROWS = 32
STAGES = 4
#: The cap-tiled scoring: trajectory rows of one block of the h pass, and a
#: panel's columns (csrc/gp_score.cu kHRows, kPanelCols).
H_ROWS = 16
PANEL_COLS = 32
#: Most trajectory rows in one chunk of the tiled gradient routes: one pass
#: of the row dot products, a row per lane.
GRAD_CHUNK = 32

KINDS = ("score", "grad", "score_clients", "grad_clients")


def split(total: int, parts: int) -> list[int]:
    """Bounds of ``parts`` near-equal parts of ``range(total)``: part r is
    ``range(b[r], b[r + 1])`` (``split_at`` in csrc/common.cuh)."""
    return [total * r // parts for r in range(parts + 1)]


def cluster_geometry(cap: int, single: bool = False) -> tuple[int, int]:
    """``(cluster size, chunk rows)`` of the resident cluster kernels at
    trajectory capacity ``cap``.  Client-batched: enough blocks that each
    owns at most 32 trajectory rows (one warp's lanes, one row or column
    each) up to ``CLUSTER`` blocks.  ``single`` (the single-client scoring
    B7a, the single-client gradient B8a and both tiled gradient routes):
    blocks of about ``SINGLE_ROWS`` rows up to ``SINGLE_CLUSTER``, so one
    client fills more of the card.  Every block owns at least one row."""
    if single:
        return min(SINGLE_CLUSTER, -(-cap // SINGLE_ROWS)), min(CHUNK_ROWS, cap)
    return min(CLUSTER, -(-cap // 32)), min(CHUNK_ROWS, cap)


def grad_smem(block_n: int, d: int, jc: int, nbuf: int) -> int:
    """Shared memory of one block of the gradient's cluster kernel with
    nbuf chunk buffers of jc rows (csrc/gp_grad.cu ``grad_cluster_smem``)."""
    return (_al(4 * nbuf * jc * rows_ld(d)) + _al(8 * d * block_n) + _al(8 * block_n)
            + _al(8 * jc * block_n) + _al(8 * (THREADS // 32) * 32 * (block_n + 1))
            + _al(8 * block_n * d))


def grad_geometry(cap: int, d: int, block_n: int, block_cap: int | None = None,
                  single: bool = False) -> tuple[int, int]:
    """``(cluster size, chunk rows)`` of the gradient's cluster kernel.
    Resident (``block_cap`` None): ``cluster_geometry(cap, single)``'s
    clusters, each block's part in one chunk.  Tiled: the single-client
    clusters for one client and for many (so one client's gradient is its
    row of a client-batched call bit for bit), chunks of at most
    ``block_cap`` and ``GRAD_CHUNK`` rows, halved until two buffers of them
    fit shared memory (down to 1 row)."""
    if block_cap is None:
        cs = cluster_geometry(cap, single)[0]
        return cs, -(-cap // cs)
    cs = cluster_geometry(cap, single=True)[0]
    rmax = -(-cap // cs)
    jc = min(block_cap, GRAD_CHUNK, rmax)
    while jc > 1 and grad_smem(block_n, d, jc, grad_buffers(rmax, jc)) > SMEM_BYTES:
        jc //= 2
    return cs, jc


def grad_layout(cap: int, d: int, block_n: int, block_cap: int | None = None,
                single: bool = False) -> list[dict]:
    """What each block (rank) of a cluster of the gradient kernel takes, as
    csrc/gp_grad.cu computes it for ``grad_geometry``: ``chunks``, its
    trajectory rows chunk by chunk in the order it sums them, and
    ``columns``, the output columns whose rank-order sums it writes."""
    cs, jc = grad_geometry(cap, d, block_n, block_cap, single)
    rows, cols = split(cap, cs), split(d, cs)
    return [{"chunks": [range(t, min(t + jc, end)) for t in range(start, end, jc)],
             "columns": range(cols[r], cols[r + 1])}
            for r, (start, end) in enumerate(zip(rows, rows[1:]))]


def grad_buffers(rmax: int, jc: int) -> int:
    """Chunk buffers of a block part of at most rmax rows taken in chunks of
    jc: two when it has more than one chunk (csrc/gp_grad.cu ``grad_buffers``)."""
    return 2 if rmax > jc else 1


def rows_ld(d: int) -> int:
    """Leading dimension of the trajectory rows a cluster kernel stages
    (``rows_ld`` in csrc/common.cuh): an odd number of float4s when
    d % 4 == 0, else odd."""
    return 4 * ((d // 4) | 1) if d % 4 == 0 else d | 1


def _al(nbytes: int) -> int:
    """One region of a cluster kernel's shared memory (16-byte aligned)."""
    return -(-nbytes // 16) * 16


def panel_cpw(n: int) -> int:
    """Candidates per warp of the tiled scoring's panel pass for n
    (padded) candidates: the fewest of 1, 2, 4, 8, 16 covering n with 8
    warps, 16 past 64 candidates, which then go in groups of 128
    (csrc/gp_score.cu ``panel_cpw``)."""
    cpw = 1
    while cpw < 16 and (THREADS // 32) * cpw < n:
        cpw *= 2
    return cpw


def panel_smem(cpw: int, block_cap: int) -> int:
    """Shared memory of one block of the panel pass: STAGES chunks of
    min(CHUNK_ROWS, block_cap) rows of its 32 columns of B and P (f32) and
    of h at its group's 8 cpw candidates (f64)."""
    return STAGES * min(CHUNK_ROWS, block_cap) * (2 * 4 * PANEL_COLS + 8 * (THREADS // 32) * cpw)


def score_tiled_work(nb: int, n: int, cap: int, block_cap: int) -> int:
    """f64 words of the tiled scoring's work buffer for nb clients of n
    (padded) candidates: h and m = 2 c.x - |c|^2 at every (row, candidate),
    then each candidate's part of corr from every panel."""
    cells = -(-cap // PANEL_COLS) * -(-cap // block_cap)
    return nb * n * (2 * cap + cells)


def score_tiled_layout(n: int, cap: int, block_n: int, block_cap: int) -> dict:
    """What each block of the tiled scoring computes for one client of n
    (padded, a multiple of block_n) candidates, as csrc/gp_score.cu
    launches it: ``h`` the (rows, candidates) of each block of the h pass;
    ``panels`` the (rows, columns, candidates) of each block of the panel
    pass in cell order (cell = row panel x column blocks + column block,
    the order the sums add them in), one entry per candidate group;
    ``cpw`` and ``cells``."""
    cpw = panel_cpw(n)
    group = (THREADS // 32) * cpw
    h = [(range(t0, min(t0 + H_ROWS, cap)), range(i0, i0 + block_n))
         for i0 in range(0, n, block_n) for t0 in range(0, cap, H_ROWS)]
    panels = [(range(j0, min(j0 + block_cap, cap)), range(k0, min(k0 + PANEL_COLS, cap)),
               range(g0, min(g0 + group, n)))
              for g0 in range(0, n, group) for j0 in range(0, cap, block_cap)
              for k0 in range(0, cap, PANEL_COLS)]
    return {"h": h, "panels": panels, "cpw": cpw,
            "cells": -(-cap // PANEL_COLS) * -(-cap // block_cap)}


def smem_bytes(kind: str, *, block_n: int, block_cap: int, cap: int, d: int) -> int:
    """Shared memory of one block for the route ``block_cap`` selects (the
    tiled scoring: the larger of its two passes' blocks, the panel pass at
    its largest group)."""
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}")
    resident = block_cap >= cap
    bn = block_n
    if kind.startswith("score") and not resident:
        return max(8 * bn * d + 8 * bn, panel_smem(16, block_cap))
    if kind.startswith("grad"):
        cs, jc = grad_geometry(cap, d, bn, None if resident else block_cap, single=kind == "grad")
        return grad_smem(bn, d, jc, grad_buffers(-(-cap // cs), jc))
    # the scoring's resident cluster kernel: csrc/gp_score.cu score_cluster_smem
    cs, jc = cluster_geometry(cap, single=kind == "score")
    rmax = -(-cap // cs)
    rows = _al(4 * rmax * rows_ld(d))  # the own rows of X
    rows_dot = 8 * 32 * (bn + 1)  # its partials per warp of 8: 32 x (bn + 1) values
    union = max(rows + 4 * rows_dot, 8 * THREADS * 2 * bn)
    return (_al(8 * cap * bn) + _al(4 * d * bn) + _al(4 * bn) + _al(4 * rmax * bn)
            + _al(8 * cs * bn) + 2 * _al(4 * STAGES * jc * rmax) + _al(union))


def _fits(kind, bn, bc, cap, d) -> bool:
    if kind.startswith("score") and bc >= cap and \
            -(-cap // cluster_geometry(cap, single=kind == "score")[0]) > THREADS:
        return False  # the cluster kernel gives each of a block's columns its own threads
    return smem_bytes(kind, block_n=bn, block_cap=bc, cap=cap, d=d) <= SMEM_BYTES


def select_blocks(kind: str, *, n: int, cap: int, d: int) -> tuple[int, int]:
    """Deterministic ``(block_n, block_cap)`` for a kernel kind and shape.

    block_n is the smallest instantiated tile covering ``min(n, 8)``
    candidates (``min(n, 4)`` for one client's scoring; n = 1 on the
    gradient path gives 1: no padded rows).  The resident route is taken
    whenever it fits; otherwise the largest cap tile that fits.
    """
    want = min(max(n, 1), _DEFAULT_BLOCK_N.get(kind, 8))
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
    if not _fits(kind, block_n, block_cap, cap, d):
        raise ValueError(
            f"pinned {kind} blocks (block_n={block_n}, block_cap={block_cap}) need {need} "
            f"bytes of shared memory per block at cap={cap}, d={d}, above the "
            f"{SMEM_BYTES}-byte budget (or more columns per cluster block than threads); "
            "pick smaller AlgoConfig block pins or leave them unset for the tuner")
    return block_n, block_cap


#: The RFF gradient's kernel (csrc/rff_grad.cu): blocks of a row's cluster,
#: groups of features (group g holds the m = g mod 32) and features a warp
#: projects at once.
RFF_GRAD_CLUSTER = 16
RFF_GRAD_GROUPS = 32
RFF_GRAD_FPW = 2
#: Columns of a block of the rows kernel (csrc/proj.cuh kRowsTile).
ROWS_TILE = 8
#: The projection's tile kernel (csrc/proj.cuh proj_tile_kernel): its d
#: chunk, f64 row stride and the card's SMs (kTileK, kTileLd, kTileSms).
PROJ_TILE_K = 32
PROJ_TILE_LD = PROJ_TILE_K + 4
PROJ_SMS = 132


def rff_grad_smem(d: int, slots: int, chunked: bool) -> int:
    """Shared memory of one block of the RFF gradient's kernel for chunks of
    ``slots`` features per group, ``chunked`` where M needs more than one
    (csrc/rff_grad.cu ``grad_smem``)."""
    gpb = RFF_GRAD_GROUPS // RFF_GRAD_CLUSTER
    f = -(-gpb * slots // RFF_GRAD_FPW) * RFF_GRAD_FPW
    smax = -(-d // RFF_GRAD_CLUSTER)
    return (_al(8) + _al(4 * d) + _al(4 * f * d) + 3 * _al(4 * f)
            + 2 * _al(4 * RFF_GRAD_GROUPS * smax)
            + (2 * _al(4 * gpb * d) if chunked else 0))


def rff_grad_slots(m: int, d: int) -> int:
    """Features per group in one chunk (csrc/rff_grad.cu ``grad_slots``): all
    ceil(M / 32) when they fit shared memory, else as many as fit; 0 when
    not one does (the kernel then refuses the launch)."""
    ns = -(-m // RFF_GRAD_GROUPS)
    for j in range(ns, 0, -1):
        if rff_grad_smem(d, j, j < ns) <= SMEM_BYTES:
            return j
    return 0


def rff_grad_owner(c: int, d: int) -> int:
    """The block whose slice ``split(d, RFF_GRAD_CLUSTER)`` holds column c,
    which receives the 32 groups' sums of that column (csrc/rff_grad.cu
    ``slice_owner``)."""
    return (RFF_GRAD_CLUSTER * (c + 1) - 1) // d


def rff_grad_layout(m: int, d: int) -> list[dict]:
    """What each block (rank) of a row's cluster does in the RFF gradient's
    kernel: ``chunks``, per chunk the features it projects and sums, by
    local group (a feature ``f = gl * js + j`` of the chunk is ``m = g0 + gl
    + 32 (j0 + j)``, valid where it is below M), and ``columns``, the output
    columns whose 32 group sums it receives (``rff_grad_owner``) and adds."""
    gpb, ns = RFF_GRAD_GROUPS // RFF_GRAD_CLUSTER, -(-m // RFF_GRAD_GROUPS)
    slots = rff_grad_slots(m, d)
    cols = split(d, RFF_GRAD_CLUSTER)
    blocks = []
    for rank in range(RFF_GRAD_CLUSTER):
        g0, chunks = rank * gpb, []
        for j0 in range(0, ns, slots):
            js = min(slots, ns - j0)
            cnt = [min(js, max(0, -(-(m - g0 - gl) // RFF_GRAD_GROUPS) - j0)) for gl in range(gpb)]
            chunks.append([[g0 + gl + RFF_GRAD_GROUPS * (j0 + j) for j in range(cnt[gl])]
                           for gl in range(gpb)])
        blocks.append({"groups": list(range(g0, g0 + gpb)), "chunks": chunks,
                       "columns": [c for c in range(d) if rff_grad_owner(c, d) == rank],
                       "slice": range(cols[rank], cols[rank + 1])})
    return blocks


def rows_route(rows: int, d: int, cols: int, batch: int) -> tuple[str, int]:
    """The kernel of csrc/proj.cuh ``launch_proj`` for ``batch`` problems of
    ``rows`` x ``cols`` outputs at width d, and its template: ("rows", BN)
    where the rows (BN = rows up to 8, else 16) and a tile of ROWS_TILE
    columns fit shared memory, else ("tile", ``proj_tile``)."""
    bn = rows if rows <= 8 else 16
    if rows <= 16 and 4 * (-(-bn * d // 4) * 4 + ROWS_TILE * d) <= SMEM_BYTES:
        return "rows", bn
    return "tile", proj_tile(batch, rows, cols)


def proj_tile(batch: int, rows: int, cols: int) -> int:
    """The tile kernel's T (csrc/proj.cuh ``launch_proj``): 64 where the
    problems' 64 x 64 tiles are at least half as many as the card's SMs,
    else 32 (factor_init's (5, 192, 192) Gram: 45 tiles of 64, 180 of 32)."""
    tiles64 = batch * -(-rows // 64) * -(-cols // 64)
    return 64 if tiles64 >= PROJ_SMS // 2 else 32


def proj_threads(tile: int) -> int:
    """Threads of one block of the tile kernel (csrc/proj.cuh ``TileShape``):
    T / 8 warps, 2 x T / 16, each owning (T / 2) x 16 of the T x T tile."""
    return 32 * tile // 8


def proj_smem(tile: int) -> int:
    """Shared memory of one block of the tile kernel (csrc/proj.cuh
    ``TileShape``): two f32 stages of 2T rows of PROJ_TILE_K, two f64 tiles
    of 2T rows of PROJ_TILE_LD and the 2T norms in f64; whatever d is."""
    return 2 * 4 * 2 * tile * PROJ_TILE_K + 2 * 8 * 2 * tile * PROJ_TILE_LD + 8 * 2 * tile


def proj_tile_layout(batch: int, rows: int, cols: int, d: int, tile: int) -> list[dict]:
    """What each block (z, y, x) of the tile kernel computes, by the
    kernel's own index arithmetic: ``outputs``, the (problem, row, col) its
    threads store (warp w of the T / 8 owns rows (w // (T / 16)) T / 2 on
    and columns 16 (w % (T / 16)) on of the T x T tile, lane 4 g + t of a
    fragment rows g and g + 8 and columns 2t and 2t + 1), ``convert``, the
    staged rows each warp converts (0 to T - 1 of a, T to 2T - 1 of bm),
    and ``chunks``, the d ranges it multiplies in order, each with its
    k-steps of 4 (slots past d are zero)."""
    warps, wns, half = tile // 8, tile // 16, tile // 2
    chunks = []
    for k0 in range(0, d, PROJ_TILE_K):
        k1 = min(d, k0 + PROJ_TILE_K)
        chunks.append((k0, k1, -(-(k1 - k0) // 4)))
    convert = {w: [w + warps * i for i in range(2 * tile // warps)] for w in range(warps)}
    blocks = []
    for z in range(batch):
        for by in range(-(-rows // tile)):
            for bx in range(-(-cols // tile)):
                row0, col0 = by * tile, bx * tile
                nr, nc = min(tile, rows - row0), min(tile, cols - col0)
                outs = []
                for thread in range(proj_threads(tile)):
                    (wm, wn), (g, t) = divmod(thread // 32, wns), divmod(thread % 32, 4)
                    for mi in range(tile // 32):
                        for ni in range(2):
                            for v in range(4):
                                r = wm * half + 16 * mi + g + 8 * (v >> 1)
                                c = wn * 16 + 8 * ni + 2 * t + (v & 1)
                                if r < nr and c < nc:
                                    outs.append((z, row0 + r, col0 + c))
                blocks.append({"block": (z, by, bx), "outputs": outs, "convert": convert,
                               "chunks": chunks})
    return blocks
