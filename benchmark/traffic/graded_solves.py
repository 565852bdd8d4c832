"""Traffic `graded_solves`: whole graded solves through the CLI's entry.

A request is one call of `nbody_tpu_torch.cli.main([in, out, flags])` in
this process, as a grader runs `prog in out`: it reads the `.in`, solves
the three problems and writes the `.out`. Every request solves the run's
one scene (the cell's template with its background drawn from the seed,
`reference/scenes.graded_scene`) and writes its own `.out` under a
temporary directory of TMPDIR. Each solve builds its carries and graphs
anew, as the entry does.

Parameters (the cell's `traffic`): `template` {n, bodies, background}:
the planet, asteroid and devices as given, and the background's
distributions. The configuration gives `precision`, `dist3_mode` and
`constants.n_steps`, passed as the CLI's flags.

The check: the reference (`reference/hw5.py`) answers the scene once, and
every `.out` the run wrote is held to its text (`hw5.compare`). The
reference's answers and each problem's row-steps go to standard error,
so that a run shows the work its seed gave.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

import torch

from benchmark.reference import hw5, scenes


class Traffic:
    def __init__(self, cell: dict, config: dict, seed: int, device: str):
        from nbody_tpu_torch import cli
        from nbody_tpu_torch.ops.graded_step import GRAPHS

        self._main, self._graphs = cli.main, GRAPHS
        self.config, self.device = config, device
        self.scene = scenes.graded_scene(cell["traffic"]["template"], seed)
        self.dir = tempfile.mkdtemp(prefix="nbody-bench-")
        self.inp = os.path.join(self.dir, "scene.in")
        scenes.write_in(self.inp, self.scene)
        self.flags = ["--device", device, "--precision", config["precision"],
                      "--dist3-mode", config["dist3_mode"],
                      "--n-steps", str(config["constants"]["n_steps"])]
        self.outs = []

    def request(self, tag: str) -> None:
        """One graded solve, its `.out` written when it returns."""
        out = os.path.join(self.dir, tag + ".out")
        self.outs.append(out)
        if self._main([self.inp, out, *self.flags]) != 0:
            raise RuntimeError(f"the CLI's entry failed on {self.inp}")
        if self.device == "cuda":
            torch.cuda.synchronize()

    def counters(self) -> dict:
        g = self._graphs
        return {"graph_replays": g.replays, "graph_captures": g.captures,
                "graph_capture_s": g.capture_s}

    def end_to_end(self, window_s: float, completed: int) -> dict:
        return {"graded_solve_s": window_s / completed}

    def check(self) -> tuple[dict, dict]:
        """(the numbers compared, the work of one request)."""
        ref = hw5.solve(self.scene, self.config["constants"],
                        device=self.device)
        texts = []
        for path in self.outs:
            try:
                with open(path) as f:
                    texts.append(f.read())
            except FileNotFoundError:
                texts.append(None)
        shutil.rmtree(self.dir, ignore_errors=True)
        print(f"reference: hit {ref.hit_step} device {ref.device_id} "
              f"min_dist {ref.min_dist!r}; row-steps P1 {ref.p1_steps} "
              f"P2 {ref.p2_steps} P3 {ref.p3_steps}", file=sys.stderr)
        n = len(self.scene["m"])
        return hw5.compare(texts, ref), {"pairs": n * n * ref.row_steps,
                                         "precision": "f64"}


def control(cell: dict, config: dict, seed: int, device: str) -> dict:
    """The control's numbers for one seed: the reference itself computed
    in float32 (the precision below the configuration's binary64), put in
    the program's place and judged as the program's `.out` is."""
    scene = scenes.graded_scene(cell["traffic"]["template"], seed)
    ref = hw5.solve(scene, config["constants"], device=device)
    low = hw5.solve(scene, config["constants"], device=device,
                    dtype=torch.float32)
    return {"f32": hw5.compare([low.text()], ref)}
