"""The port's span recorder, its records of requests, and a device trace.

A span is a named interval of one request: its name, its start and end,
its parent and the identifier of the request. A request's root span is its
entry (`entry`): the CLI's solve (read, solve, write), a `simulate()`
call, or an engine call with no entry open. Under it lie the phases
(`span`: read_input, oscillation_table, problems_fused, problem_1_2,
problem_3, write_output), a span for every chunk that a driver enqueues
(`chunk`: `ops/graded_step.graded_chunk` and `graded_rows_chunk`,
`simulate._march`), one for every capture of a chunk's CUDA graph
(`capture`: `ops/chunking.ChunkGraphs.run`) and one for the leapfrog's
seed force in `simulate()`, the force launch before the first chunk
(`seed`). Outside an open request nothing is recorded.

A chunk or a seed on a card is timed on the card's clock: two timing
events from a pool, recorded on the current stream, the start after any
capture (a capture moves it) and before the first enqueued operation, the
end after the replay, the C call or the force. They are resolved when the
root closes, after the host read that ends every driver, so nothing waits
for them. On the CPU a chunk or a seed takes the host's clock.

When the root closes, the request becomes one record, a dict of numbers,
appended to `RECORDS` (the last 512 requests; the CLI's `--stats` prints
its own):

    request       the request's identifier
    wall_s        the root's seconds on the host's clock
    phases_s      the phases' seconds by name
    chunks        the chunks enqueued
    chunk_s       their summed durations
    chunk_host_s  the host's seconds inside them (the enqueueing)
    gaps_s        each chunk's start less the previous chunk's end, summed
    span_s        from the first chunk's start to the last chunk's end
    outside_s     wall_s less span_s: the host's work before the first
                  chunk and after the last
    row_steps     rows x steps of the chunks by driver: p12, p3, p123, sim
    seeds, seed_s the leapfrog seeds of simulate() and their seconds
    sim_row_steps bodies x steps of simulate's one-device chunks on a
                  card, by precision and form (`sim_rows`): f64, f32 or
                  dd, then persistent (one launch a chunk) or blocked (a
                  launch a step on all rows), as the C call chose, for a
                  replay as its graph captured it; binary64's blocked
                  as blocked.g<k>, the geometry its step kernel took
                  (csrc/sim_step_f64.cu sim_step_f64_geometry)
    captures, capture_s   the graph captures and their host seconds
    resident_chunks       the graded chunks that ran as one launch of the
                  resident kernel (csrc/graded_step_f64.cu;
                  `resident_chunk`)
    b1_row_steps  rows x steps of the binary64 graded chunks that ran a
                  launch a step, by the geometry of B1''s step kernel that
                  the library chose for their shape (`b1_launch_rows`;
                  csrc/graded_step_f64.cu graded_step_f64_geometry)
    pdl_launches  the step launches of those chunks made as programmatic
                  dependents of the step before (`pdl_launched`; K - 1 a
                  chunk of K steps, csrc/graded.cuh graded_chunk; a replay
                  counts those it captured)
    gathers, gather_bytes the all_gathers of blocks over the mesh's 'body'
                  axis that the chunks enqueued (`gathered`: a step's
                  positions, a chunk's carry, the plain versions' forces;
                  a graph replay counts those it captured) and the bytes of
                  their gathered outputs; 0 off the mesh

so that wall_s = outside_s + gaps_s + chunk_s. A request that raises
leaves no record. While torch.profiler is active, each span is also a
`record_function` range named `nbody.<name>`, on the trace's clock with
the device's operations; otherwise no range is entered (the test of the
profiler costs a fraction of a microsecond, an idle range about 12).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time

import torch

RECORDS: collections.deque = collections.deque(maxlen=512)

_requests = itertools.count(1)
_open = threading.local()           # .request: this thread's open request
_pool: dict = {}                    # card index: free timing events


@dataclasses.dataclass(eq=False, slots=True)
class Span:
    name: str
    parent: Span | None
    request: int
    start: float = 0.0              # the host's clock
    end: float = 0.0
    # a chunk on a card: its (start, end) timing events and their stream
    events: tuple | None = None
    stream: torch.cuda.Stream | None = None
    mirror: object = None           # its record_function, under a profiler


class Request:
    """An open request: its root span, its open spans, and what its spans
    add up to; `record` once the root has closed."""

    def __init__(self, root: Span):
        self.root = root
        self.stack = [root]
        self.phases: dict = {}
        self.chunks: list = []
        self.chunk_host_s = 0.0
        self.row_steps: dict = {}
        self.seeds: list = []
        self.sim_row_steps: dict = {}
        self.captures = 0
        self.capture_s = 0.0
        self.resident_chunks = 0
        self.b1_row_steps: dict = {}
        self.pdl_launches = 0
        self.gathers = 0
        self.gather_bytes = 0
        self.stream: torch.cuda.Stream | None = None    # the last chunk's
        self.record: dict | None = None


def _mirror(name: str):
    """An entered `record_function` range named nbody.<name> while a
    profiler is active, else None."""
    if not torch.autograd._profiler_enabled():
        return None
    rf = torch.profiler.record_function("nbody." + name)
    rf.__enter__()
    return rf


def _open_span(req: Request | None, name: str) -> Span:
    parent = req.stack[-1] if req is not None else None
    sp = Span(name, parent, parent.request if parent else next(_requests),
              start=time.perf_counter(), mirror=_mirror(name))
    if req is not None:
        req.stack.append(sp)
    return sp


def _close_span(req: Request, sp: Span) -> None:
    sp.end = time.perf_counter()
    if sp.mirror is not None:
        sp.mirror.__exit__(None, None, None)
    req.stack.pop()


@contextlib.contextmanager
def entry(name: str):
    """The root span of a request named `name`, yielding its `Request`
    (whose `record` is set when the root closes); where a request is open
    already, nothing: the open entry is the root. Also a decorator."""
    if getattr(_open, "request", None) is not None:
        yield None
        return
    root = _open_span(None, name)
    req = _open.request = Request(root)
    done = False
    try:
        yield req
        done = True
    finally:
        _open.request = None
        _close_span(req, root)
        try:
            if done:
                req.record = _reduce(req)
                RECORDS.append(req.record)
        finally:
            for c in req.chunks + req.seeds:
                if c.events is not None:
                    _pool.setdefault(c.stream.device_index, []).extend(
                        c.events)


@contextlib.contextmanager
def span(name: str):
    """A phase of the open request; nothing outside one."""
    req = getattr(_open, "request", None)
    if req is None:
        yield
        return
    sp = _open_span(req, name)
    try:
        yield
    finally:
        _close_span(req, sp)
        req.phases[name] = req.phases.get(name, 0.0) + (sp.end - sp.start)


def _event(index: int) -> torch.cuda.Event:
    free = _pool.get(index)
    return free.pop() if free else torch.cuda.Event(enable_timing=True)


def _stream(req: Request, device: torch.device) -> torch.cuda.Stream:
    """The current stream of `device`: the request's last chunk's while
    it is still current. Its raw handle is a cheap read where a new Stream
    object costs some 9 us on the card's host."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    s = req.stream
    if s is None or s.device_index != index \
            or s.cuda_stream != torch._C._cuda_getCurrentRawStream(index):
        s = req.stream = torch.cuda.current_stream(index)
    return s


@contextlib.contextmanager
def _device_span(name: str, device: torch.device, closed):
    """A span `name` of work enqueued on `device`, on the card's clock
    where `device` is a card; closed(req, span) once it has closed.
    Nothing outside a request."""
    req = getattr(_open, "request", None)
    if req is None:
        yield
        return
    sp = _open_span(req, name)
    if device.type == "cuda":
        sp.stream = _stream(req, device)
        sp.events = (_event(sp.stream.device_index),
                     _event(sp.stream.device_index))
        sp.events[0].record(sp.stream)
    try:
        yield
    finally:
        if sp.events is not None:
            sp.events[1].record(sp.stream)
        _close_span(req, sp)
        closed(req, sp)


def chunk(driver: str, rows: int, steps: int, device: torch.device):
    """A chunk of `steps` steps of `rows` rows enqueued on `device` by
    `driver` (a context manager); nothing outside a request."""
    def closed(req: Request, sp: Span) -> None:
        req.chunks.append(sp)
        req.chunk_host_s += sp.end - sp.start
        req.row_steps[driver] = req.row_steps.get(driver, 0) + rows * steps
    return _device_span("chunk", device, closed)


def seed(device: torch.device):
    """The leapfrog's seed force of a simulate() call enqueued on `device`
    (a context manager); nothing outside a request."""
    return _device_span("seed", device,
                        lambda req, sp: req.seeds.append(sp))


@contextlib.contextmanager
def capture():
    """A capture of a chunk's CUDA graph; the chunk it lies in starts
    again after it. Nothing outside a request."""
    req = getattr(_open, "request", None)
    if req is None:
        yield
        return
    sp = _open_span(req, "capture")
    try:
        yield
    finally:
        _close_span(req, sp)
        req.captures += 1
        req.capture_s += sp.end - sp.start
        if sp.parent.name == "chunk":
            sp.parent.start = sp.end
            if sp.parent.events is not None:
                sp.parent.events[0].record(sp.parent.stream)


def resident_chunk() -> None:
    """Count a graded chunk that ran as one launch of the resident kernel
    in the open request; nothing outside one."""
    req = getattr(_open, "request", None)
    if req is not None:
        req.resident_chunks += 1


def b1_launch_rows(geometry: str, row_steps: int) -> None:
    """Count `row_steps` rows x steps of binary64 graded chunks that ran a
    launch a step in B1''s geometry `geometry`, in the open request;
    nothing outside one."""
    req = getattr(_open, "request", None)
    if req is not None:
        req.b1_row_steps[geometry] = \
            req.b1_row_steps.get(geometry, 0) + row_steps


def pdl_launched(count: int) -> None:
    """Count `count` graded step launches made as programmatic dependents
    of the launch before them in the open request; nothing outside one."""
    req = getattr(_open, "request", None)
    if req is not None:
        req.pdl_launches += count


def sim_rows(key: str, row_steps: int) -> None:
    """Count `row_steps` bodies x steps of a simulate chunk of the
    precision and form `key` ('f64.blocked.g1', ...) in the open request;
    nothing outside one."""
    req = getattr(_open, "request", None)
    if req is not None:
        req.sim_row_steps[key] = req.sim_row_steps.get(key, 0) + row_steps


def gathered(count: int, nbytes: int) -> None:
    """Count `count` all_gathers whose gathered outputs hold `nbytes` bytes
    in all in the open request; nothing outside one."""
    req = getattr(_open, "request", None)
    if req is not None:
        req.gathers += count
        req.gather_bytes += nbytes


def _reduce(req: Request) -> dict:
    """The closed request's record (module docstring). The gaps are the
    span less the chunks: one clock reading a chunk and one a request."""
    chunks = req.chunks
    chunk_s = span_s = 0.0
    if chunks and all(c.events is not None for c in chunks):
        last = chunks[-1].events[1]
        last.synchronize()      # complete: every driver ends with a host read
        chunk_s = sum(c.events[0].elapsed_time(c.events[1])
                      for c in chunks) * 1e-3
        span_s = chunks[0].events[0].elapsed_time(last) * 1e-3
    elif chunks:
        chunk_s = sum(c.end - c.start for c in chunks)
        span_s = chunks[-1].end - chunks[0].start
    seed_s = 0.0
    for sp in req.seeds:
        if sp.events is not None:
            sp.events[1].synchronize()      # complete, as the chunks are
            seed_s += sp.events[0].elapsed_time(sp.events[1]) * 1e-3
        else:
            seed_s += sp.end - sp.start
    root = req.root
    wall_s = root.end - root.start
    return {"request": root.request, "wall_s": wall_s,
            "phases_s": dict(req.phases), "chunks": len(chunks),
            "chunk_s": chunk_s, "chunk_host_s": req.chunk_host_s,
            "gaps_s": span_s - chunk_s, "span_s": span_s,
            "outside_s": wall_s - span_s, "row_steps": dict(req.row_steps),
            "seeds": len(req.seeds), "seed_s": seed_s,
            "sim_row_steps": dict(req.sim_row_steps),
            "captures": req.captures, "capture_s": req.capture_s,
            "resident_chunks": req.resident_chunks,
            "b1_row_steps": dict(req.b1_row_steps),
            "pdl_launches": req.pdl_launches, "gathers": req.gathers,
            "gather_bytes": req.gather_bytes}


@contextlib.contextmanager
def device_trace(logdir: str | None):
    """A torch.profiler trace of the block (the CPU, and the card where
    there is one) written into `logdir` for TensorBoard or Perfetto (a
    `*.pt.trace.json`); does nothing if logdir is falsy."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
