"""Traffic `simulate_calls_f64`: whole binary64 `simulate()` calls from one
state, held to the direct-difference binary64 reference.

A request is one call of `nbody_tpu_torch.simulate.simulate(scene, cfg,
n_steps=..., chunk=..., ...)` on the Plummer sphere drawn from the seed
(`reference/scenes.plummer_scene`), always from that initial state, in
the configuration's precision and integrator (`simulate_calls`' request;
calls run back to back, one at a time).

Parameters (the cell's `traffic`): `n`, `n_steps`, `chunk`. The
configuration gives `precision`, `integrator`, `compensated` and the
constants (G, eps, dt, the sphere's total mass and scale radius).

The check: `reference/plummer_kdk.py` marches the same state once in
block mode, in binary64 with the configuration's integrator, and every
call's final (q, v) is held to it (`plummer.gaps`). The work of a request
is the n^2 pairs of each force evaluation the problem needs: n_steps + 1
for the leapfrog (its seed at the initial positions), n_steps for Euler.
"""

from __future__ import annotations

import torch

from benchmark.reference import plummer, plummer_kdk
from benchmark.traffic import simulate_calls


class Traffic(simulate_calls.Traffic):
    def _reference(self, dtype: torch.dtype = torch.float64) -> tuple:
        c = self.c
        return plummer_kdk.march(
            self.q, self.v, self.m, n_steps=self.n_steps, G=c["G"],
            eps=c["eps"], dt=c["dt"], device=self.device,
            integrator=self.kw["integrator"], dtype=dtype)

    def check(self) -> tuple[dict, dict]:
        """(the numbers compared, the work of one request)."""
        forces = self.n_steps + (self.kw["integrator"] == "leapfrog")
        return (plummer.gaps(self.finals, self._reference(), self.q,
                             self.v),
                {"pairs": self.n * self.n * forces,
                 "precision": self.kw["precision"]})


def control(cell: dict, config: dict, seed: int, device: str) -> dict:
    """The control's numbers for one seed: the reference marched in
    float32 (the precision below the configuration's binary64), put in
    the program's place and judged as a call's final state is; beside it
    the program's own float32 path (precision 'f32' with Kahan, the
    configuration's integrator), a second witness."""
    t = Traffic(cell, config, seed, device)
    ref = t._reference()
    low = t._reference(torch.float32)
    t.kw.update(precision="f32", compensated=True)
    t.request("f32")
    return {"f32": plummer.gaps([low], ref, t.q, t.v),
            "program_f32": plummer.gaps(t.finals, ref, t.q, t.v)}
