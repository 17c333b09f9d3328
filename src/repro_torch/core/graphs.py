"""Chunks of rounds as captured CUDA graphs: the card's side of
``core.rounds.run_rounds``, and the port's counterpart of the reference's
one jitted ``lax.scan`` per chunk with donated buffers.

``CapturedChunks`` holds the run's stacked ``ClientState`` and server
iterate in static buffers and captures ``rounds.chunk_fn``'s chunk once per
chunk length.  The graph reads the static buffers, and its last operations
copy the chunk's final state back into them, so a replay advances the run
in place; its per-round outputs stay in the graph's own output tensors
until the host writes them into the history.  The chunk's first round is a
static 0-d buffer that the host sets before each replay (``eval_every``'s
NaN rows are selected from it on the device).

Draws: each ``ClientDraws`` generator is registered with every graph, so
a replay draws from the generator's current state and advances it by what
the chunk consumed, the numbers an eager chunk draws.  Before the first
capture one round runs eagerly on a side stream, on clones of the state
and on generators of its own, so that libraries, kernels and workspaces
are set up outside the capture; the run's state and draws are untouched.

``captures`` is the rule of which engines capture.  A capture that fails
raises: nothing falls back to the eager chunk.  ``COUNTS`` counts the
captures and replays (the kernel wrappers' ``LAUNCHES`` count a captured
launch once, at its capture).
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import algorithms as alg

COUNTS = {"captures": 0, "replays": 0}


def captures(cfg, draws, device) -> bool:
    """True when a chunk runs as a captured graph: on a CUDA device, for
    the deferred client-batched FZooS engine and the FD baselines, drawing
    from ``ClientDraws``.  The per-client engine reads its health flags on
    the host at every append event and the seed engine's eigh checks its
    errors on the host, so both run eagerly; so does any other draw source,
    whose numbers a graph would replay unchanged."""
    return (torch.device(device).type == "cuda" and type(draws) is alg.ClientDraws
            and (cfg.deferred or cfg.uses_fd))


def tensors(tree) -> list:
    """The tensors of nested (named) tuples, in order (None entries skipped)."""
    return [t for t in pytree.tree_leaves(tree) if torch.is_tensor(t)]


def clone(tree):
    return pytree.tree_map_only(torch.Tensor, torch.clone, tree)


def copy_into(dst, src) -> None:
    """Copy the tensors of ``src`` into those of ``dst`` (same structure).
    A source that is its destination is skipped; one that shares storage
    with another destination is cloned before any copy, so no copy reads a
    buffer an earlier copy overwrote."""
    pairs = [(d, s) for d, s in zip(pytree.tree_leaves(dst), pytree.tree_leaves(src))
             if torch.is_tensor(d) and d is not s]
    storages = {d.untyped_storage().data_ptr() for d in tensors(dst)}
    pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in storages else s)
             for d, s in pairs]
    for d, s in pairs:
        d.copy_(s)


class CapturedChunks:
    """The run's state in static buffers, and one captured chunk per length.

    ``make_chunk(length, draws)`` builds ``rounds.chunk_fn``'s chunk;
    ``draws`` is the run's ``ClientDraws``.  ``run(length, offset)`` replays
    the chunk of that length (capturing it on first use) from round
    ``offset`` and returns its stacked per-round outputs, valid until the
    next replay; ``states`` and ``sx`` are then the state after the chunk.
    ``load`` overwrites the static state (the boundary's repair, a
    rollback's restore, a cohort's gather).
    """

    def __init__(self, make_chunk, draws, states, sx: torch.Tensor):
        self._make = make_chunk
        self._draws = draws
        self.states = clone(states)
        self.sx = sx.clone()
        self._offset = torch.zeros((), dtype=torch.int64, device=sx.device)
        self._graphs: dict[int, tuple] = {}
        self._pool = torch.cuda.graph_pool_handle()
        self._warm_up()

    def _warm_up(self) -> None:
        """One eager round on a side stream, on clones of the state and on a
        draw source of its own."""
        draws = alg.ClientDraws(0, range(len(self._draws.gens)), self._draws.device)
        side = torch.cuda.Stream(device=self.sx.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._make(1, draws)(clone(self.states), self.sx.clone(),
                                 self._offset.clone())
        torch.cuda.current_stream().wait_stream(side)

    def graph(self, length: int) -> tuple:
        """(graph, per-round output tensors) of the chunk of ``length``
        rounds, captured on first use."""
        if length not in self._graphs:
            graph = torch.cuda.CUDAGraph()
            for gen in self._draws.gens:
                graph.register_generator_state(gen)
            chunk = self._make(length, self._draws)
            with torch.cuda.graph(graph, pool=self._pool):
                states, sx, ys = chunk(self.states, self.sx, self._offset)
                copy_into((self.states, self.sx), (states, sx))
            self._graphs[length] = (graph, ys)
            COUNTS["captures"] += 1
        return self._graphs[length]

    def run(self, length: int, offset: int) -> tuple:
        graph, ys = self.graph(length)
        self._offset.fill_(offset)
        graph.replay()
        COUNTS["replays"] += 1
        return ys

    def load(self, states, sx=None) -> None:
        """Overwrite the static state (and server iterate, where given)."""
        copy_into(self.states, states)
        if sx is not None and sx is not self.sx:
            self.sx.copy_(sx)
