"""What the chunked drivers share: the CUDA graphs of their chunks and the
mesh's split of a state's rows.

A chunk on a card is one replay of a CUDA graph captured from its
launches at its first run (`ChunkGraphs`, counted in `GRAPHS`): the graded
carries' (ops/graded_step) and simulate's (ops/sim_step). On a mesh each
rank computes one block of the state's rows and an all_gather fills the
others (`Blocks`, `to_blocks`, `from_blocks`): the graded mesh
(ops/graded_step `graded_rows_chunk`, parallel/solver_sharded) and
simulate's (ops/sim_step `sim_rows_chunk_*`, parallel/sharded).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from ..utils import profiling


@dataclasses.dataclass
class GraphCounts:
    """The CUDA graphs of the graded chunks and of simulate's chunks
    (ops/sim_step) in this process, counted once each by
    `ChunkGraphs.run` (`--stats` prints them): replays, one a chunk;
    captures, one a chunk shape and set of buffers; and the host seconds
    the captures took, their buffers' allocation included."""
    replays: int = 0
    captures: int = 0
    capture_s: float = 0.0


GRAPHS = GraphCounts()


def capture_graph(body: Callable[[], None]) -> Callable[[], None]:
    """Capture body(), one chunk's launches, into a CUDA graph on the
    stream that torch.cuda.graph makes current, and return its replay. A
    capture that fails raises: nothing goes back to the launches one by
    one."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    return graph.replay


def _set_word(word: torch.Tensor, s0: int) -> None:
    """Write the base step s0 into a chunk's device word, ordered on the
    current stream before the replay: a copy from a fresh pinned host
    tensor (torch's host allocator does not hand its memory out again
    before the copy has run)."""
    if word.is_cuda:
        word.copy_(torch.full((1,), s0, dtype=torch.int32, pin_memory=True),
                   non_blocking=True)
    else:
        word.fill_(s0)


class ChunkGraphs:
    """A carry's captured chunks: one CUDA graph a chunk shape, replayed
    for every chunk of that shape; the graded carries' (`Carry.graphs`)
    and simulate's (ops/sim_step `SimCarry.graphs`).

    A graph bakes its kernels' arguments, so every buffer it touches keeps
    its address for the graph's life: the carry's tensors and the entry's
    own buffers (the second of the state's ping-pong pair, the second
    arrival buffer and the word of the chunk's base step), which the entry
    holds. The kernels read the base step from that word (csrc/graded.cuh),
    which `run` writes before each replay, so one graph serves every chunk
    of its K steps wherever it starts. `key` is all that decides the
    captured work (driver, representation, shape, K, the force's dist3 or
    tile, the layout, the constants and every buffer's address): a chunk
    whose key differs captures anew. Plain Python: `capture(body) ->
    replay` is `capture_graph` on a card and a stand-in in the CPU
    tests."""

    def __init__(self, capture: Callable = capture_graph):
        self.capture = capture
        self.entries: dict = {}

    def run(self, key: tuple, build: Callable, device: torch.device,
            s0: int) -> Callable:
        """Replay the graph of `key` for the chunk from step s0, first
        capturing build(word)(), the chunk's launches reading their base
        step from `word`, if there is none (inside a request, a capture
        span: utils/profiling.capture); returns the captured body."""
        entry = self.entries.get(key)
        if entry is None:
            t = time.perf_counter()
            with profiling.capture():
                word = torch.zeros(1, dtype=torch.int32, device=device)
                body = build(word)
                entry = self.entries[key] = (self.capture(body), word, body)
            GRAPHS.captures += 1
            GRAPHS.capture_s += time.perf_counter() - t
        replay, word, body = entry
        _set_word(word, s0)
        replay()
        GRAPHS.replays += 1
        return body


def _stream(x: torch.Tensor) -> int | None:
    """The current stream of x's card (the capture's, inside a capture)."""
    return torch.cuda.current_stream().cuda_stream if x.is_cuda else None


@dataclasses.dataclass(frozen=True)
class Blocks:
    """The mesh's split of n bodies over k body ranks: k blocks of ni =
    ceil(n / k) rows, block r the rows [r * ni, (r + 1) * ni) cut at n
    (the last blocks may be short or empty). `mine`: the blocks one call of
    the step computes, the rank's own, or all k where one process stands in
    for the k ranks (and nothing is gathered)."""
    n: int
    k: int
    mine: tuple

    @property
    def ni(self) -> int:
        return -(-self.n // self.k)

    def rows(self, r: int) -> tuple:
        """(first, end) of block r's real rows."""
        r0 = min(r * self.ni, self.n)
        return r0, min(r0 + self.ni, self.n)


def to_blocks(q: torch.Tensor, v: torch.Tensor, k: int) -> torch.Tensor:
    """The one-device state q, v (B, n, 3), or (B, n, 3, 2) double-double,
    in k blocks: (k, 2, B, ni, 3[, 2]), block r holding the rows
    [r * ni, (r + 1) * ni) of q and then of v, rows past n zero (the layout
    that an all_gather of the ranks' blocks makes)."""
    B, n = q.shape[:2]
    ni = -(-n // k)
    qv = q.new_zeros((2, B, k * ni) + tuple(q.shape[2:]))
    qv[0, :, :n] = q
    qv[1, :, :n] = v
    return qv.unflatten(2, (k, ni)).movedim(2, 0).contiguous()


def from_blocks(qv: torch.Tensor, n: int) -> tuple:
    """The one-device (q, v) of n bodies from a state in blocks."""
    x = qv.movedim(0, 2).flatten(2, 3)[:, :, :n]
    return x[0].contiguous(), x[1].contiguous()
