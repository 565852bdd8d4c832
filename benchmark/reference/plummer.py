"""Plain reference of `simulate()`: Euler steps of softened gravity.

    a_i = sum over j != i of G m_j (q_j - q_i) / (|q_j - q_i|^2 + eps^2)^1.5
    v += a dt;  q += v dt

in float64 with plain PyTorch ops, worked out again from the scene's
arrays. The force is taken in blocks of rows through two matrix products,
so that a step at n = 65536 costs some 50 ms on a card rather than
seconds: with w_ij = G m_j / (d2_ij + eps^2)^1.5 (w_ii = 0),

    d2_ij = |q_i|^2 + |q_j|^2 - 2 q_i . q_j   (one product of width 5)
    a_i   = sum_j w_ij q_j - q_i sum_j w_ij   (one product of width 4)

Both forms lose a few bits of binary64 to cancellation (|q|^2 against
d2, and the sum of w q_j against q_i's share), some 1e-12 of a typical
pair's force in a Plummer sphere: far below the float32 program's own
rounding, which is what the comparison measures.

`dtype` sets the precision of the state and its update (the force is
formed from that state in binary64 and rounded to it), so that
`dtype=torch.bfloat16` gives the control: the reference marched in the
precision below the configuration's float32.

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 8192    # rows a block: two (BLOCK, n) binary64 matrices at a time


def accel(q: torch.Tensor, gm: torch.Tensor, eps: float,
          block: int = BLOCK) -> torch.Tensor:
    """Accelerations (n, 3) of float64 positions q (n, 3) under gm = G m."""
    n = q.shape[0]
    sq = (q * q).sum(1, keepdim=True)
    one = torch.ones_like(sq)
    left = torch.cat([q, one, sq], 1)                    # (n, 5)
    right = torch.cat([-2.0 * q, sq, one], 1).T          # (5, n)
    src = torch.cat([gm[:, None] * q, gm[:, None]], 1)   # (n, 4)
    eps2 = torch.full((1, 1), eps * eps, dtype=q.dtype, device=q.device)
    out = torch.empty((n, 4), dtype=q.dtype, device=q.device)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        w = torch.addmm(eps2, left[r0:r1], right)        # d2 + eps^2
        diag = w.view(-1)[r0::n + 1][:r1 - r0]           # (i, i) entries
        diag.fill_(1.0)             # |q_i|^2 - |q_i|^2 may round below 0
        w.pow_(-1.5)
        diag.fill_(0.0)
        torch.mm(w, src, out=out[r0:r1])
        del w, diag
    return out[:, :3] - q * out[:, 3:]


def march(q0: np.ndarray, v0: np.ndarray, m: np.ndarray, *, n_steps: int,
          G: float, eps: float, dt: float, device,
          dtype: torch.dtype = torch.float64) -> tuple:
    """(q, v) float64 host arrays after n_steps Euler steps from (q0, v0)."""
    def put(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(device)

    q, v = put(q0).to(dtype), put(v0).to(dtype)
    gm = put(m) * G
    for _ in range(n_steps):
        a = accel(q.double(), gm, eps).to(dtype)
        v = v + a * dt
        q = q + v * dt
    return q.double().cpu().numpy(), v.double().cpu().numpy()


def gaps(finals: list, ref: tuple, q0: np.ndarray,
         v0: np.ndarray) -> dict:
    """The widest gaps over the calls' final states. q_gap: the RMS of
    (program - reference) positions over the RMS of the reference's own
    change over the call. v_med_gap: the median over the bodies of each
    body's velocity error over its own velocity change (steady from seed
    to seed, where an RMS follows the few bodies of a sphere's tightest
    pairs). A call whose state is not finite reads inf."""
    rq, rv = ref
    dq = np.sqrt(np.mean((rq - q0) ** 2))
    dv_each = np.linalg.norm(rv - v0, axis=1)
    out = {"q_gap": 0.0, "v_med_gap": 0.0}
    for q, v in finals:
        if not (np.isfinite(q).all() and np.isfinite(v).all()):
            return dict.fromkeys(out, float("inf"))
        out["q_gap"] = max(out["q_gap"],
                           float(np.sqrt(np.mean((q - rq) ** 2)) / dq))
        with np.errstate(divide="ignore", invalid="ignore"):
            each = np.linalg.norm(v - rv, axis=1) / dv_each
        out["v_med_gap"] = max(out["v_med_gap"], float(np.median(each)))
    return out
