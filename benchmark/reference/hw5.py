"""Plain reference of the graded solve: the NTHU IPC hw5 N-body spec.

The three answers of a scene, worked out again from its arrays with plain
PyTorch tensor ops, one op after another, in the spec program's order
(the homework's `samples/nbody.cc`, with the Problem-3 search of the
surveyed solution, `hw5.cu:438-530`):

    a_i = fold over ascending j != i of ((G * m_j) * dx) / d3,
    dx = q_j - q_i,  d2 = ((dx*dx + dy*dy) + dz*dz) + eps*eps,
    d3 = d2 * sqrt(d2);   v += a * dt;  q += v * dt

with a device's mass m0 + (0.5 * m0) * |sin(step * dt / period)|, libm's
sin on the host. Problem 1 (devices off) keeps the least planet-asteroid
d² over steps 0..N; Problem 2 (devices on) stops at the first step where
it is below the planet radius squared, and records each device's missile
arrival (the first step where the planet-device d² is below
(speed * dt * step)²) with the state there; Problem 3 runs each device
that arrives by the hit from that state with the device's mass at zero,
and the cheapest device whose run never hits saves the planet.

Bits: every op is one IEEE operation rounded to nearest (no fused
multiply-add: each product and sum is its own op), square roots are
correctly rounded (numpy's on the CPU, where torch's float64 sqrt is not;
CUDA's double sqrt on a card), and the fold is `torch.cumsum` along an
outer axis, which both the CPU and the CUDA build compute as one serial
sum per column in ascending order. The j == i term is 0 and is folded, as
adding 0 leaves a sum unchanged. So the answers are the spec program's to
the bit, which is what the configuration's guarantee asks of the port.

The rows of all problems march together in one batch, each at its own
step: a Problem-3 row joins at the end of the chunk in which Problem 2's
row records its arrival, from the state there, so it runs beside Problems
1 and 2 rather than after them; a row leaves the batch at the end of the
chunk in which it finished. On a card each chunk of `chunk` steps is one
replay of a CUDA graph of the same ops.

Imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

P1, P2, P3 = 0, 1, 2
# from this many bodies Problem 3 runs one scenario at a time ('auto')
SEQUENTIAL_MIN_N = 256


@dataclasses.dataclass
class Answers:
    min_dist: float
    hit_step: int
    device_id: int
    cost: float
    # row-steps each problem ran: P1, P2 and one per Problem-3 scenario
    p1_steps: int
    p2_steps: int
    p3_steps: list

    def text(self) -> str:
        """The 3-line `.out` the spec program writes (%.16e, 17 digits)."""
        return "%.16e\n%d\n%d %.16e\n" % (self.min_dist, self.hit_step,
                                          self.device_id, self.cost)

    @property
    def row_steps(self) -> int:
        return self.p1_steps + self.p2_steps + sum(self.p3_steps)


def oscillation(n_steps: int, dt: float, period: float) -> np.ndarray:
    """|sin(step * dt / period)| for step 0..n_steps, libm's sin."""
    return np.array([abs(math.sin((s * dt) / period))
                     for s in range(n_steps + 1)])


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


class _Batch:
    """The marching rows: state, masses, step and the problems' carries,
    each a tensor with the rows first. `step()` and `check()` only write
    into these tensors, so a chunk of them can be captured once."""

    def __init__(self, rows: list, scene: dict, phys: dict, table, dtype,
                 device):
        def put(x, dt=dtype):
            return torch.as_tensor(np.asarray(x), dtype=dt).to(device)

        self.rows = rows
        n = len(scene["m"])
        self.q = put(np.stack([r["q"] for r in rows]))
        self.v = put(np.stack([r["v"] for r in rows]))
        m0, mh = [], []
        for r in rows:
            m = scene["m"].copy()
            dev = scene["devices"]
            if r["kind"] == P1:
                m[dev] = 0.0
            elif r["kind"] == P3:
                m[r["dead"]] = 0.0
            half = np.zeros(n)
            half[dev] = 0.5 * m[dev]
            m0.append(m)
            mh.append(half)
        self.m0, self.mh = put(np.stack(m0)), put(np.stack(mh))
        self.table = put(table)
        self.at = put([r["step"] for r in rows], torch.int64)
        kinds = np.array([r["kind"] for r in rows])
        self.is_p1 = put(kinds == P1, torch.bool)
        self.can_hit = put(kinds != P1, torch.bool)
        self.min_d2 = put([r.get("min_d2", math.inf) for r in rows])
        self.hit = put([r.get("hit", -2) for r in rows], torch.int64)
        self.has_p2 = bool((kinds == P2).any())
        if self.has_p2:
            d = len(scene["devices"])
            self.is_p2 = put(kinds == P2, torch.bool)
            self.devs = put(scene["devices"], torch.int64)
            self.arr = put([r.get("arrivals", [-2] * d) for r in rows],
                           torch.int64)
            self.snap_q = torch.zeros((len(rows), d, n, 3), dtype=dtype,
                                      device=device)
            self.snap_v = torch.zeros_like(self.snap_q)
        self.planet, self.asteroid = scene["planet"], scene["asteroid"]
        self.dtype = dtype
        c = (lambda x: float(np.float32(x))) if dtype == torch.float32 \
            else float
        self.G, self.dt = c(phys["G"]), c(phys["dt"])
        self.eps2 = c(c(phys["eps"]) * c(phys["eps"]))
        self.r2 = c(c(phys["planet_radius"]) * c(phys["planet_radius"]))
        self.sdt = c(c(phys["missile_speed"]) * c(phys["dt"]))

    def step(self) -> None:
        """Advance every row one step (the force at the row's next step)."""
        self.at += 1
        fst = self.table[self.at]
        gm = (self.m0 + self.mh * fst[:, None]) * self.G
        dq = self.q[:, :, None, :] - self.q[:, None, :, :]   # q_j - q_i
        sq = dq * dq
        d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        d2 = d2 + self.eps2
        d3 = d2 * _sqrt(d2)
        term = (gm[:, :, None, None] * dq) / d3[..., None]
        a = torch.cumsum(term, dim=1)[:, -1]                 # serial over j
        self.v.copy_(self.v + a * self.dt)
        self.q.copy_(self.q + self.v * self.dt)
        self.check()

    def check(self) -> None:
        """The problems' checks on the rows' current states."""
        d2 = _sq_dist(self.q[:, self.planet], self.q[:, self.asteroid])
        self.min_d2.copy_(torch.where(self.is_p1 & (d2 < self.min_d2), d2,
                                      self.min_d2))
        open_ = self.hit == -2
        if self.has_p2:
            md = self.at.to(self.dtype) * self.sdt
            dd2 = _sq_dist(self.q[:, None, self.planet],
                           self.q[:, self.devs])
            new = (self.is_p2 & open_)[:, None] & (self.arr == -2) \
                & (dd2 < (md * md)[:, None])
            self.arr.copy_(torch.where(new, self.at[:, None], self.arr))
            self.snap_q.copy_(torch.where(new[..., None, None],
                                          self.q[:, None], self.snap_q))
            self.snap_v.copy_(torch.where(new[..., None, None],
                                          self.v[:, None], self.snap_v))
        self.hit.copy_(torch.where(self.can_hit & open_ & (d2 < self.r2),
                                   self.at, self.hit))


def _chunk_runner(batch: _Batch, k: int):
    """A function that advances the batch k steps: a CUDA graph replay on
    a card (captured here, after one step on a copy warms the ops up),
    the ops one by one on the CPU."""
    if batch.q.device.type != "cuda":
        def run():
            for _ in range(k):
                batch.step()
        return run
    scratch = _Batch.__new__(_Batch)
    scratch.__dict__.update({key: (val.clone() if torch.is_tensor(val)
                                   else val)
                             for key, val in batch.__dict__.items()})
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        scratch.step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(k):
            batch.step()
    return graph.replay


def solve(scene: dict, phys: dict, *, device: str | torch.device = "cpu",
          dtype: torch.dtype = torch.float64, chunk: int = 1000,
          strategy: str = "auto") -> Answers:
    """The scene's three answers and each problem's row-steps. `phys`:
    n_steps, dt, eps, G, planet_radius, missile_speed, cost_base,
    cost_per_t, mass_period (the spec's constants).

    Problem 3's rows start as soon as Problem 2's row records their
    arrivals, from the states there, in (arrival, body index) order.
    strategy 'sequential' runs one at a time and stops at the first whose
    run never hits: cost grows with the arrival step, so no later device
    can be cheaper (the surveyed solution's pruning, hw5.cu:574-585);
    'batched' runs them all at once; 'auto' is sequential from
    SEQUENTIAL_MIN_N bodies. The answers are the same; only the time
    differs."""
    n_steps = int(phys["n_steps"])
    if strategy == "auto":
        strategy = "sequential" if len(scene["m"]) >= SEQUENTIAL_MIN_N \
            else "batched"
    if strategy not in ("sequential", "batched"):
        raise ValueError(f"unknown strategy {strategy!r}")
    table = oscillation(n_steps, phys["dt"], phys["mass_period"])
    rows = [{"kind": P1, "step": 0, "q": scene["q"], "v": scene["v"]},
            {"kind": P2, "step": 0, "q": scene["q"], "v": scene["v"],
             "arrivals": [-2] * len(scene["devices"])}]
    queue, p3, done = [], [], {}
    while rows:
        batch = _Batch(rows, scene, phys, table, dtype, device)
        batch.check()               # each row's state where it stands
        k = min(chunk, min(n_steps - r["step"] for r in rows))
        run = _chunk_runner(batch, k) if k > 0 else None
        while True:
            state = _rows_state(batch)
            arrived = _arrivals(batch, state)
            finished = [i for i, r in enumerate(state)
                        if r["step"] == n_steps
                        or (r["kind"] != P1 and r["hit"] != -2)]
            if finished or arrived or run is None:
                break
            left = min(n_steps - r["step"] for r in state)
            if left < k:            # the last, shorter chunk: no capture
                for _ in range(left):
                    batch.step()
            else:
                run()
        queue = sorted(queue + arrived, key=lambda r: (r["arr"], r["dead"]))
        rows = []
        for i, r in enumerate(state):
            if i not in finished:
                rows.append(r)
            elif r["kind"] == P3:
                p3.append(r)
            else:
                done[r["kind"]] = r
        if P2 in done and done[P2]["hit"] == -2:    # no hit, no Problem 3
            queue, rows = [], [r for r in rows if r["kind"] != P3]
        if strategy == "batched":
            rows, queue = rows + queue, []
        elif any(r["hit"] == -2 for r in p3):       # the first saver
            queue = []
        elif queue and not any(r["kind"] == P3 for r in rows):
            rows.append(queue.pop(0))
    hit_step = done[P2]["hit"]
    winner, cost, p3_steps = -1, 0.0, []
    if hit_step != -2:
        for r in sorted(p3, key=lambda r: (r["arr"], r["dead"])):
            end = r["hit"] if r["hit"] != -2 else n_steps
            p3_steps.append(end - r["arr"])
            if r["hit"] == -2:
                winner = r["dead"]
                cost = phys["cost_base"] + phys["cost_per_t"] * (
                    (r["arr"] + 1) * phys["dt"])
                break
    return Answers(min_dist=math.sqrt(done[P1]["min_d2"]), hit_step=hit_step,
                   device_id=winner, cost=cost, p1_steps=n_steps,
                   p2_steps=hit_step if hit_step != -2 else n_steps,
                   p3_steps=p3_steps)


def _rows_state(batch: _Batch) -> list:
    """The rows as host dicts: their states and carries where they stand."""
    q, v = batch.q.cpu().double().numpy(), batch.v.cpu().double().numpy()
    at, hit = batch.at.tolist(), batch.hit.tolist()
    min_d2 = batch.min_d2.double().tolist()
    arr = batch.arr.tolist() if batch.has_p2 else None
    out = []
    for i, r in enumerate(batch.rows):
        out.append({**r, "step": at[i], "hit": hit[i], "min_d2": min_d2[i],
                    "q": q[i], "v": v[i]})
        if r["kind"] == P2:
            out[-1]["arrivals"] = arr[i]
    return out


def _arrivals(batch: _Batch, state: list) -> list:
    """Problem 3's rows of the devices whose missiles Problem 2's row
    recorded since the batch began: one a device, from the state at its
    arrival, with the device's mass at zero from there on."""
    rows = []
    for i, r in enumerate(state):
        if r["kind"] != P2:
            continue
        for k, dev in enumerate(batch.devs.tolist()):
            at = r["arrivals"][k]
            if at == -2 or batch.rows[i]["arrivals"][k] != -2:
                continue
            rows.append({"kind": P3, "step": at, "arr": at,
                         "dead": dev,
                         "q": batch.snap_q[i, k].cpu().double().numpy(),
                         "v": batch.snap_v[i, k].cpu().double().numpy()})
    return rows


def _parse(text: str):
    """(min_dist, hit, device, cost) of a 3-line `.out`; None if it is not
    one."""
    try:
        lines = text.strip().split("\n")
        dev, cost = lines[2].split()
        return float(lines[0]), int(lines[1]), int(dev), float(cost)
    except (AttributeError, IndexError, ValueError):
        return None


def compare(texts: list, ref: Answers) -> dict:
    """The widest gaps of the `.out` texts (None: never written) from the
    reference's answers: `outs_unequal` counts the texts that are not the
    reference's byte for byte; the others are the largest relative gap of
    the min distance and the missile cost, of the hit step in steps, and
    the count of wrong devices (inf for a text that does not parse)."""
    want = ref.text()
    out = {"outs_unequal": 0, "min_dist_rel_gap": 0.0, "hit_step_gap": 0,
           "device_id_gap": 0, "cost_rel_gap": 0.0}
    for text in texts:
        out["outs_unequal"] += text != want
        got = _parse(text)
        if got is None:
            for key in ("min_dist_rel_gap", "hit_step_gap", "cost_rel_gap"):
                out[key] = math.inf
            out["device_id_gap"] += 1
            continue
        md, hit, dev, cost = got
        out["min_dist_rel_gap"] = max(out["min_dist_rel_gap"],
                                      abs(md - ref.min_dist)
                                      / max(abs(ref.min_dist), 1e-300))
        out["hit_step_gap"] = max(out["hit_step_gap"],
                                  abs(hit - ref.hit_step))
        out["device_id_gap"] += dev != ref.device_id
        out["cost_rel_gap"] = max(out["cost_rel_gap"],
                                  abs(cost - ref.cost) / max(ref.cost, 1.0))
    return out
