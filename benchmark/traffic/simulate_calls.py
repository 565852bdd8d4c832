"""Traffic `simulate_calls`: whole `simulate()` calls from one state.

A request is one call of `nbody_tpu_torch.simulate.simulate(scene, cfg,
n_steps=..., chunk=..., ...)` on a Plummer sphere drawn from the seed
(`reference/scenes.plummer_scene`), always from that initial state, so
that the work of a window does not hang on how far the system has
evolved. The call returns the final state on the host.

Parameters (the cell's `traffic`): `n`, `n_steps`, `chunk`. The
configuration gives `precision`, `integrator`, `compensated` and the
constants (G, eps, dt, the sphere's total mass and scale radius).

The check: the reference (`reference/plummer.py`) marches the same state
once, and every call's final (q, v) is held to it (`plummer.gaps`).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import plummer, scenes


class Traffic:
    def __init__(self, cell: dict, config: dict, seed: int, device: str):
        from nbody_tpu_torch.config import SimConfig
        from nbody_tpu_torch.io import Scene
        from nbody_tpu_torch.ops.graded_step import GRAPHS
        from nbody_tpu_torch.simulate import simulate

        t, c = cell["traffic"], config["constants"]
        self.n, self.n_steps = t["n"], t["n_steps"]
        self.c, self.device = c, device
        self.q, self.v, self.m = scenes.plummer_scene(
            self.n, seed=seed, total_mass=c["total_mass"],
            scale_radius=c["scale_radius"], G=c["G"])
        self.scene = Scene(n=self.n, planet=0, asteroid=1, q=self.q,
                           v=self.v, m=self.m, types=["star"] * self.n,
                           device_idx=np.zeros(0, np.int64))
        self.cfg = SimConfig(G=c["G"], eps=c["eps"], dt=c["dt"])
        self.kw = {"n_steps": self.n_steps, "chunk": t["chunk"],
                   "precision": config["precision"],
                   "integrator": config["integrator"],
                   "compensated": config["compensated"], "device": device}
        self._simulate, self._graphs = simulate, GRAPHS
        self.finals = []

    def request(self, tag: str) -> None:
        """One simulate() call from the initial state."""
        st = self._simulate(self.scene, self.cfg, **self.kw)
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.finals.append((st.q, st.v))

    def counters(self) -> dict:
        g = self._graphs
        return {"graph_replays": g.replays, "graph_captures": g.captures,
                "graph_capture_s": g.capture_s}

    def end_to_end(self, window_s: float, completed: int) -> dict:
        pairs = self.n * self.n * self.n_steps * completed
        return {"sim_pairs_per_s": pairs / window_s}

    def check(self) -> tuple[dict, dict]:
        """(the numbers compared, the work of one request)."""
        c = self.c
        ref = plummer.march(self.q, self.v, self.m, n_steps=self.n_steps,
                            G=c["G"], eps=c["eps"], dt=c["dt"],
                            device=self.device)
        return (plummer.gaps(self.finals, ref, self.q, self.v),
                {"pairs": self.n * self.n * self.n_steps,
                 "precision": "f32"})


def control(cell: dict, config: dict, seed: int, device: str) -> dict:
    """The control's numbers for one seed: the reference marched in
    bfloat16 (the precision below the configuration's float32), put in
    the program's place and judged as a call's final state is; beside it
    the program's own uncompensated float32 path, a second witness."""
    t = Traffic(cell, config, seed, device)
    t.kw["compensated"] = False
    t.request("plain")
    c = t.c
    kw = {"n_steps": t.n_steps, "G": c["G"], "eps": c["eps"],
          "dt": c["dt"], "device": device}
    ref = plummer.march(t.q, t.v, t.m, **kw)
    low = plummer.march(t.q, t.v, t.m, dtype=torch.bfloat16, **kw)
    return {"bf16": plummer.gaps([low], ref, t.q, t.v),
            "program_uncompensated": plummer.gaps(t.finals, ref, t.q, t.v)}
