"""Plain reference of `simulate()` on a mesh: the Euler steps of
`plummer.py`, each step's rows split over several cards.

    a_i = sum over j != i of G m_j (q_j - q_i) / (|q_j - q_i|^2 + eps^2)^1.5
    v += a dt;  q += v dt

The formulas are `plummer.accel`'s (the force of a block of rows through
two matrix products in binary64), restricted to a card's rows, with eps^2
added to the left factor's column of |q_i|^2 rather than as the first
product's bias: a bias of one value is expanded to the whole (rows, n)
block and read again (on an H100 the first product with it took 18.3 ms
a block of 8192 rows of 262144, and a card's step at n = 262144 fell
from some 0.32 s to 0.24 s without it; eps^2 = 1e-6 m^2 lies far under
the rounding of |q_i|^2 ~ 1e12 m^2 either way). Card c
holds the whole positions in binary64 and computes the force and the
update of its equal share of the rows, [c * ni, (c + 1) * ni) with ni =
ceil(n / cards). After each step every card's new rows are copied to every
other card. All of it is driven from this one process, the cards' work
enqueued side by side; no `torch.distributed`.

`dtype` is `plummer.march`'s: the precision of the state and its update
(the force formed from that state in binary64 and rounded to it), so that
`dtype=torch.bfloat16` gives the control.

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.plummer import BLOCK


def accel_rows(q: torch.Tensor, gm: torch.Tensor, eps: float, r0: int,
               r1: int, block: int = BLOCK) -> torch.Tensor:
    """Accelerations (r1 - r0, 3) of the rows r0..r1 of float64 positions
    q (n, 3) under gm = G m: `plummer.accel`'s products on those rows
    (module docstring)."""
    n = q.shape[0]
    sq = (q * q).sum(1, keepdim=True)
    one = torch.ones_like(sq)
    left = torch.cat([q[r0:r1], one[r0:r1], sq[r0:r1] + eps * eps],
                     1)                                       # (rows, 5)
    right = torch.cat([-2.0 * q, sq, one], 1).T               # (5, n)
    src = torch.cat([gm[:, None] * q, gm[:, None]], 1)        # (n, 4)
    out = torch.empty((r1 - r0, 4), dtype=q.dtype, device=q.device)
    for b0 in range(r0, r1, block):
        b1 = min(b0 + block, r1)
        w = torch.mm(left[b0 - r0:b1 - r0], right)            # d2 + eps^2
        diag = w.view(-1)[b0::n + 1][:b1 - b0]                # (i, i)
        diag.fill_(1.0)             # |q_i|^2 - |q_i|^2 may round below 0
        w.pow_(-1.5)
        diag.fill_(0.0)
        torch.mm(w, src, out=out[b0 - r0:b1 - r0])
        del w, diag
    return out[:, :3] - q[r0:r1] * out[:, 3:]


def march(q0: np.ndarray, v0: np.ndarray, m: np.ndarray, *, n_steps: int,
          G: float, eps: float, dt: float, devices: list,
          dtype: torch.dtype = torch.float64) -> tuple:
    """(q, v) float64 host arrays after n_steps Euler steps from (q0, v0),
    the rows of every step split over `devices` (one entry a card; a
    device may repeat, as the CPU does in the tests)."""
    n, cards = len(m), len(devices)
    ni = -(-n // cards)
    bounds = [(min(c * ni, n), min((c + 1) * ni, n)) for c in range(cards)]

    def put(x, dev):
        return torch.as_tensor(np.asarray(x, np.float64)).to(dev)

    # each card: the whole positions in binary64 (what its force reads; a
    # copy of its own, written each step), gm, and its rows' state in
    # `dtype`
    qs = [put(q0, d).to(dtype).double().clone() for d in devices]
    gms = [put(m, d) * G for d in devices]
    rows = [(put(q0[a:b], d).to(dtype), put(v0[a:b], d).to(dtype))
            for d, (a, b) in zip(devices, bounds)]
    for _ in range(n_steps):
        for c, (a, b) in enumerate(bounds):
            if b > a:
                acc = accel_rows(qs[c], gms[c], eps, a, b).to(dtype)
                q, v = rows[c]
                v = v + acc * dt
                rows[c] = (q + v * dt, v)
        for c, (a, b) in enumerate(bounds):
            if b > a:
                new = rows[c][0].double()
                for d, dev in enumerate(devices):
                    qs[d][a:b] = new.to(dev)
    q = np.concatenate([r[0].double().cpu().numpy() for r in rows])
    v = np.concatenate([r[1].double().cpu().numpy() for r in rows])
    return q, v
