"""Tree checkpointing to .npz with a JSON sidecar (port of
``repro.checkpoint.io``, the single-file layout).

A step is ``<dir>/step_<N>/arrays.npz + meta.json``: every leaf gathered
to the host as member ``leaf_<i>``, with its dtype tag in ``meta.json``
(bfloat16 stored as a uint16 view, since npz has no bf16) and a
``zlib.crc32`` checksum per leaf.  The format is the reference's, so
either package restores a plain tree of arrays that the other wrote:

* the tree is flattened as JAX flattens it: dict keys sorted, tuples,
  lists and named tuples in order, ``None`` an empty node (the SGD
  optimizer's state), every other node a leaf (a tensor, an array or a
  number);
* ``np.savez`` and ``json`` only, never ``torch.save`` or pickle, and
  ``np.load`` keeps ``allow_pickle=False``;
* restore checks the leaf count, then each leaf's shape, dtype and
  checksum; the treedef string is recorded, never compared.

``meta.json`` has one key the reference does not write and does not read:
``strides``, each tensor leaf's element strides (None for a leaf without
them).  The arrays are stored in logical order either way; restore lays a
tensor out with its saved strides, since an eager chunk's arithmetic can
follow its inputs' layout (a leaf may be a transposed array), so a
resumed run computes on the layouts the stopped run had.  A leaf without
saved strides takes the template's.

A step is written into a ``.tmp`` sibling and renamed into place, so a
preemption mid-write leaves only a ``*.tmp`` directory that ``list_steps``
never matches.

Round-state checkpoints (``core/rounds.py``) split the save into
``prepare_round_state`` (every device read, synchronously: on the card the
next chunk's replay overwrites the state in place) and
``write_round_state`` (file I/O on host arrays only, so it may run on the
``AsyncCheckpointWriter`` thread, which makes no CUDA call).  Beside the
reference's two groups, ``states`` and ``hist``, the port's round state
has a third, ``draws``: the draw source's generator states, where the
reference keeps one key per client inside the state.

Client-pool checkpoints (``core/pool.py``) take the reference's
``pool-v1`` layout: ``step_<N>/meta.json`` is the manifest (the layout,
one shard, the pool's and the history's leaf counts, dtypes and treedefs,
the pool's rows) and ``step_<N>/shard_00000/`` holds ``arrays.npz``
(members ``pool_<i>`` and ``hist_<i>``) and ``shard.json`` (the rows and a
checksum per member).  The port adds a ``draws`` group (members
``draws_<i>``: the draw source's own state, then the N clients' generator
states stacked) and the pool leaves' layouts, under keys the reference
does not read.

The reference's sharded layout (a mesh, one file per process) is not
ported: restoring a step written in it raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch

_BF16 = "bfloat16"
_SHARDED_LAYOUT = "sharded-v1"
_POOL_LAYOUT = "pool-v1"
_SHARDED = ("the per-shard checkpoint layout of a device mesh is not ported yet "
            "(ROADMAP Queue A, A11: the distributed engine)")


class CorruptCheckpointError(ValueError):
    """A checkpoint step exists but its contents fail an integrity check:
    a truncated or unreadable ``arrays.npz``, a zip-member CRC failure
    (flipped bytes), a per-leaf checksum mismatch, or a missing member.
    ``rounds._restore_newest_good`` catches it and falls back to the next
    older step."""


def _crc(arr: np.ndarray) -> int:
    """Content checksum of one stored (already tagged) array."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _load_npz(path: str):
    """``np.load`` with every failure mapped to ``CorruptCheckpointError``
    (a truncated file presents as a bad zip central directory)."""
    try:
        return np.load(path, allow_pickle=False)
    except Exception as e:  # noqa: BLE001 - any load failure is a corrupt file
        raise CorruptCheckpointError(f"unreadable arrays file {path!r}: {e}") from e


def _npz_member(data, key: str, path: str) -> np.ndarray:
    """One npz member; zipfile checks the member's CRC on read, so flipped
    payload bytes surface here as ``CorruptCheckpointError``."""
    try:
        return data[key]
    except KeyError as e:
        raise CorruptCheckpointError(f"missing array {key!r} in {path!r}") from e
    except Exception as e:  # noqa: BLE001 - zip CRC and decompression failures
        raise CorruptCheckpointError(f"corrupt array {key!r} in {path!r}: {e}") from e


def _dtype_name(x) -> str:
    """The dtype tag of a tensor or array: numpy's name (``float32``,
    ``bool``, ``bfloat16``, ...), which torch's matches without its prefix."""
    return str(x.dtype).removeprefix("torch.")


def _to_numpy(leaf) -> tuple[np.ndarray, str, Optional[list]]:
    """A host copy of one leaf, its dtype tag and its strides (the device
    read of a save).  The copy is the snapshot: the live tensor may be
    overwritten after."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        # the strides a copy keeps: the tensor's own where it is dense and
        # does not overlap itself, else contiguous ones
        strides = list(torch.empty_like(t, device="meta").stride())
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).to("cpu", copy=True).numpy().view(np.uint16)
            return arr, _BF16, strides
        return t.to("cpu", copy=True).numpy(), _dtype_name(t), strides
    arr = np.array(leaf)
    return arr, _dtype_name(arr), None


def _from_numpy(raw: np.ndarray, tag: str, want, strides: Optional[list]) -> torch.Tensor:
    """A stored member as a tensor like the template leaf ``want``: on its
    device, with the saved strides (else the template's)."""
    if tag == _BF16:
        t = torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(raw))
    if not torch.is_tensor(want):
        return t
    if strides is None:
        out = torch.empty_like(want)
    else:
        out = torch.empty_strided(want.shape, strides, dtype=want.dtype, device=want.device)
    out.copy_(t)
    return out


def _check_leaf(i: int, got_shape, got_tag: str, want) -> None:
    """Shape and dtype of one restored leaf against the template."""
    want_shape = tuple(np.shape(want))
    if tuple(got_shape) != want_shape:
        raise ValueError(f"shape mismatch at leaf {i}: checkpoint {tuple(got_shape)} vs "
                         f"template {want_shape}")
    want_tag = _dtype_name(want) if hasattr(want, "dtype") else _dtype_name(np.asarray(want))
    if got_tag != want_tag:
        raise ValueError(f"dtype mismatch at leaf {i}: checkpoint holds {got_tag}, "
                         f"template wants {want_tag}")


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_flatten(tree: Any) -> tuple[list, str]:
    """(leaves, treedef string) in JAX's order: dict keys sorted, sequences
    and named tuples in order, ``None`` an empty node."""
    leaves: list = []

    def walk(node) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}" for k in sorted(node)) + "}"
        if _is_namedtuple(node):
            inner = ", ".join(f"{f}={walk(v)}" for f, v in zip(node._fields, node))
            return f"{type(node).__name__}({inner})"
        if isinstance(node, (list, tuple)):
            inner = ", ".join(walk(v) for v in node)
            return f"[{inner}]" if isinstance(node, list) else f"({inner})"
        leaves.append(node)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def tree_unflatten(like: Any, leaves) -> Any:
    """The structure of ``like`` with its leaves taken from ``leaves`` in
    ``tree_flatten``'s order (dicts keep ``like``'s key order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def _flatten_to_host(tree: Any) -> tuple[dict, dict]:
    """(npz arrays, meta) of one tree: the device-read half of a save.  The
    checksums are file metadata and are added at write time
    (``_with_checksums``), on the writer thread for async writes."""
    leaves, treedef = tree_flatten(tree)
    arrays, tags, strides = {}, [], []
    for i, leaf in enumerate(leaves):
        arrays[f"leaf_{i}"], tag, st = _to_numpy(leaf)
        tags.append(tag)
        strides.append(st)
    return arrays, {"treedef": treedef, "n_leaves": len(leaves), "dtypes": tags,
                    "strides": strides}


def _with_checksums(meta: dict, arrays: dict) -> dict:
    """meta plus the per-leaf content CRCs, ordered ``leaf_0..leaf_{n-1}``."""
    out = dict(meta)
    out["checksums"] = [int(_crc(arrays[f"leaf_{i}"])) for i in range(meta["n_leaves"])]
    return out


def _write_step_dir(path: str, populate: Callable[[str], None]) -> str:
    """Populate a ``.tmp`` sibling, then rename it into place."""
    tmp = path + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    populate(tmp)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def _write_single(path: str, arrays: dict, meta: dict) -> str:
    def populate(tmp: str) -> None:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)

    return _write_step_dir(path, populate)


def _step_path(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def save(path: str, tree: Any, step: int | None = None, extra_meta: dict | None = None) -> str:
    """Write ``tree`` into ``path`` (or ``path/step_<step>``) through a
    ``.tmp`` sibling renamed into place."""
    if step is not None:
        path = _step_path(path, step)
    arrays, meta = _flatten_to_host(tree)
    meta = _with_checksums(meta, arrays)
    if step is not None:
        meta["step"] = step
    if extra_meta:
        meta["extra"] = extra_meta
    return _write_single(path, arrays, meta)


def restore(path: str, like: Any, step: int | None = None) -> Any:
    """Restore into the structure of ``like``: the leaf count, each leaf's
    shape, dtype and checksum are checked; a truncated file, a zip CRC
    failure, a missing member or a checksum mismatch raises
    ``CorruptCheckpointError``.  A tensor leaf of ``like`` gets a tensor on
    its device with its strides; any other leaf a CPU tensor."""
    if step is not None:
        path = _step_path(path, step)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    apath = os.path.join(path, "arrays.npz")
    data = _load_npz(apath)
    leaves_like, _ = tree_flatten(like)
    if len(leaves_like) != meta["n_leaves"]:
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, template has "
                         f"{len(leaves_like)}")
    sums = meta.get("checksums")
    strides = meta.get("strides") or [None] * len(leaves_like)
    leaves = []
    for i, want in enumerate(leaves_like):
        raw, tag = _npz_member(data, f"leaf_{i}", apath), meta["dtypes"][i]
        if sums is not None and _crc(raw) != sums[i]:
            raise CorruptCheckpointError(f"checksum mismatch at leaf {i} in {apath!r}")
        _check_leaf(i, raw.shape, _BF16 if tag == _BF16 else _dtype_name(raw), want)
        leaves.append(_from_numpy(raw, tag, want, strides[i]))
    return tree_unflatten(like, leaves)


def list_steps(root: str) -> list[int]:
    """Every complete step under ``root``, ascending (``*.tmp`` never matches)."""
    if not os.path.isdir(root):
        return []
    return sorted(int(m.group(1)) for d in os.listdir(root)
                  if (m := re.fullmatch(r"step_(\d+)", d)))


def latest_step(root: str) -> int | None:
    steps = list_steps(root)
    return steps[-1] if steps else None


def save_train_state(root: str, step: int, params, opt_state, metrics: dict | None = None) -> str:
    return save(root, {"params": params, "opt": opt_state}, step=step, extra_meta=metrics)


def restore_train_state(root: str, params_like, opt_like, step: int | None = None):
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    tree = restore(root, {"params": params_like, "opt": opt_like}, step=step)
    return tree["params"], tree["opt"], step


def load_meta(root: str, step: int) -> dict:
    """The ``meta.json`` sidecar of one step (treedef, dtypes, extra)."""
    with open(os.path.join(_step_path(root, step), "meta.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Round-state checkpoints (core/rounds.py)
# ---------------------------------------------------------------------------


def _round_tree(states, history, draws) -> dict:
    tree = {"states": states, "hist": history}
    if draws is not None:
        tree["draws"] = draws
    return tree


def prepare_round_state(states, history, draws=None) -> dict:
    """Host snapshot of a round-state checkpoint: every device read happens
    here, and the copies are complete when it returns (the caller may
    overwrite the state next).  The payload is numpy and JSON only, for
    ``write_round_state``.  ``draws`` is the draw source's ``state()``."""
    arrays, meta = _flatten_to_host(_round_tree(states, history, draws))
    return {"arrays": arrays, "meta": meta}


def write_round_state(root: str, round_idx: int, payload: dict,
                      extra_meta: dict | None = None) -> str:
    """Persist a ``prepare_round_state`` or ``prepare_pool_state`` payload,
    keyed by the number of completed rounds: file I/O on host arrays, no
    device access, so it may run on the writer thread."""
    if payload.get("layout") == "sharded":
        return _write_shard(_step_path(root, round_idx), round_idx, payload, extra_meta)
    meta = _with_checksums(payload["meta"], payload["arrays"])
    meta["step"] = round_idx
    if extra_meta:
        meta["extra"] = extra_meta
    return _write_single(_step_path(root, round_idx), payload["arrays"], meta)


def _write_shard(path: str, round_idx: int, payload: dict, extra_meta: dict | None) -> str:
    """The per-shard layout of one process: the manifest as the step's
    ``meta.json``, the arrays and ``shard.json`` (rows, a checksum per
    member) under ``shard_<p>``."""
    def populate(tmp: str) -> None:
        shard = payload["shard_meta"]
        sdir = os.path.join(tmp, f"shard_{shard['shard']:05d}")
        os.makedirs(sdir)
        np.savez(os.path.join(sdir, "arrays.npz"), **payload["arrays"])
        shard = dict(shard, checksums={k: int(_crc(a)) for k, a in payload["arrays"].items()})
        with open(os.path.join(sdir, "shard.json"), "w") as f:
            json.dump(shard, f)
        manifest = dict(payload["manifest"], step=round_idx)
        if extra_meta:
            manifest["extra"] = extra_meta
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(manifest, f)

    return _write_step_dir(path, populate)


def restore_round_state(root: str, states_like, hist_like, step: int | None = None,
                        draws_like=None):
    """Inverse of ``prepare_round_state`` + ``write_round_state``; returns
    (states, history, draws, round_idx), ``draws`` None when ``draws_like``
    is.  A step in the reference's sharded or pool layout raises."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    layout = load_meta(root, step).get("layout")
    if layout == _SHARDED_LAYOUT:
        raise NotImplementedError(f"checkpoint step {step} under {root!r}: {_SHARDED}")
    if layout == _POOL_LAYOUT:
        raise ValueError(f"checkpoint step {step} under {root!r} is a client-pool step "
                         f"({_POOL_LAYOUT}); restore it with restore_pool_state (a pooled "
                         "run's directory is not shared with a dense run)")
    tree = restore(root, _round_tree(states_like, hist_like, draws_like), step=step)
    return tree["states"], tree["hist"], tree.get("draws"), step


# ---------------------------------------------------------------------------
# Client-pool checkpoints (core/pool.py)
# ---------------------------------------------------------------------------


def prepare_pool_state(pool_leaves: list, treedef_str: str, row_start: int, global_rows: int,
                       history, draws=None, orders: Optional[list] = None) -> dict:
    """Host snapshot of a client-pool checkpoint: the pool's leaves (host
    tensors, copied: the next boundary's scatter writes them in place
    while the writer may still be saving these), the history (the only
    device read) and the draw states (``[source state, (N, S) clients'
    generator states]``).  The payload is the ``pool-v1`` layout, for
    ``write_round_state``.  ``orders`` are the pool leaves' layouts
    (``core/pool.py``'s ``dim_order``), kept in the manifest."""
    arrays: dict = {}
    p_tags = []
    for i, leaf in enumerate(pool_leaves):
        arrays[f"pool_{i}"], tag, _ = _to_numpy(leaf)
        p_tags.append(tag)
    h_leaves, h_def = tree_flatten(history)
    h_tags = []
    for i, leaf in enumerate(h_leaves):
        arrays[f"hist_{i}"], tag, _ = _to_numpy(leaf)
        h_tags.append(tag)
    manifest = {
        "layout": _POOL_LAYOUT,
        "n_shards": 1,
        "pool": {"treedef": treedef_str, "n_leaves": len(pool_leaves), "dtypes": p_tags,
                 "global_rows": int(global_rows), "orders": orders},
        "hist": {"treedef": h_def, "n_leaves": len(h_leaves), "dtypes": h_tags},
    }
    if draws is not None:
        d_tags = []
        for i, leaf in enumerate(draws):
            arrays[f"draws_{i}"], tag, _ = _to_numpy(leaf)
            d_tags.append(tag)
        manifest["draws"] = {"n_leaves": len(draws), "dtypes": d_tags}
    rows = int(pool_leaves[0].shape[0]) if pool_leaves and np.ndim(pool_leaves[0]) else 0
    shard_meta = {"shard": 0, "row_start": int(row_start), "row_stop": int(row_start) + rows}
    return {"layout": "sharded", "arrays": arrays, "manifest": manifest,
            "shard_meta": shard_meta}


def restore_pool_state(root: str, pool_like: list, hist_like, step: int | None = None,
                       draws_like=None):
    """Inverse of ``prepare_pool_state`` + ``write_round_state``: returns
    (pool leaves as CPU tensors, history, draws, layouts, round_idx);
    ``draws`` is None when ``draws_like`` is.  The manifest (layout, one
    shard), every member's checksum and every leaf's shape and dtype are
    checked against the templates, as ``restore_round_state`` checks its
    own; damage raises ``CorruptCheckpointError``."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    meta = load_meta(root, step)
    if meta.get("layout") != _POOL_LAYOUT:
        raise ValueError(f"checkpoint step {step} under {root!r} has layout "
                         f"{meta.get('layout')!r}, expected {_POOL_LAYOUT!r} (a client-pool "
                         "checkpoint directory must not be shared with round-state runs)")
    if meta.get("n_shards") != 1:
        raise ValueError(f"pool checkpoint was written by {meta.get('n_shards')} process(es), "
                         "cannot restore with 1")
    sdir = os.path.join(_step_path(root, step), "shard_00000")
    with open(os.path.join(sdir, "shard.json")) as f:
        shard_meta = json.load(f)
    apath = os.path.join(sdir, "arrays.npz")
    data = _load_npz(apath)
    sums = shard_meta.get("checksums") or {}

    def member(key: str) -> np.ndarray:
        raw = _npz_member(data, key, apath)
        if key in sums and _crc(raw) != sums[key]:
            raise CorruptCheckpointError(f"checksum mismatch at {key!r} in {apath!r}")
        return raw

    def group(name: str, like: list, prefix: str) -> list:
        if len(like) != meta[name]["n_leaves"]:
            raise ValueError(f"pool checkpoint has {meta[name]['n_leaves']} {name} leaves, "
                             f"template has {len(like)}")
        out = []
        for i, want in enumerate(like):
            raw, tag = member(f"{prefix}_{i}"), meta[name]["dtypes"][i]
            _check_leaf(i, raw.shape, _BF16 if tag == _BF16 else _dtype_name(raw), want)
            out.append(_from_numpy(raw, tag, want, None))
        return out

    rows = shard_meta["row_stop"] - shard_meta["row_start"]
    if rows != meta["pool"]["global_rows"]:
        raise ValueError(f"pool shard rows [{shard_meta['row_start']}, "
                         f"{shard_meta['row_stop']}) are not the pool's "
                         f"{meta['pool']['global_rows']}")
    leaves = group("pool", pool_like, "pool")
    h_like, _ = tree_flatten(hist_like)
    hist = tree_unflatten(hist_like, group("hist", h_like, "hist"))
    draws = None if draws_like is None else group("draws", list(draws_like), "draws")
    return leaves, hist, draws, meta["pool"].get("orders"), step


class AsyncCheckpointWriter:
    """Single-worker background writer for chunk-boundary checkpoints.

    At most one write is in flight: ``submit`` joins the previous write
    first and re-raises any error it hit, so a failing checkpoint fails the
    run.  ``wait()`` drains the writer.  ``OSError``s are retried on the
    writer thread with capped exponential backoff (``retries`` extra
    attempts, ``backoff_s`` doubling up to ``max_backoff_s``); other errors
    are never retried.
    """

    def __init__(self, retries: int = 2, backoff_s: float = 0.1,
                 max_backoff_s: float = 2.0) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._retries = retries
        self._backoff_s = backoff_s
        self._max_backoff_s = max_backoff_s

    def _run(self, fn: Callable[[], Any]) -> None:
        delay, attempt = self._backoff_s, 0
        while True:
            try:
                fn()
                return
            except OSError as e:
                if attempt >= self._retries:
                    self._error = e  # re-raised on the main thread
                    return
                attempt += 1
                time.sleep(min(delay, self._max_backoff_s))
                delay *= 2
            except BaseException as e:  # noqa: BLE001 - re-raised on the main thread
                self._error = e
                return

    def submit(self, fn: Callable[[], Any]) -> None:
        self.wait()
        self._thread = threading.Thread(target=self._run, args=(fn,),
                                        name="repro-torch-ckpt-writer", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
