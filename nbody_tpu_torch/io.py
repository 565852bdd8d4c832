"""Scene I/O: testcase `.in` parser and writer, 3-line `.out` writer.

Input format (hw5.cu:86-103 / samples/nbody.cc:22-39):
    n planet_idx asteroid_idx
    qx qy qz vx vy vz m type      (n lines)

Bodies stay in file order; the planet/asteroid indices and the device index
list carry the reference's slot permutation (hw5.cu:110-130).

Output format (hw5.cu:133-141): three lines —
    min_dist                        (scientific, 16 digits after the point)
    hit_time_step                   (int)
    gravity_device_id missile_cost  (int, scientific)

numpy only: parsing and formatting are byte-compatible with `nbody_tpu.io`.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Scene:
    """An N-body scene in file order."""

    n: int
    planet: int
    asteroid: int
    q: np.ndarray          # (n, 3) float64 positions
    v: np.ndarray          # (n, 3) float64 velocities
    m: np.ndarray          # (n,)   float64 masses
    types: list            # list[str], length n
    device_idx: np.ndarray  # (D,) int64 body indices of type == "device",
    #                         ascending file order (hw5.cu:100-102)

    @property
    def device_cnt(self) -> int:
        return int(self.device_idx.shape[0])

    def device_mask(self) -> np.ndarray:
        """(n,) float64: 1.0 where body is a gravity device else 0.0."""
        mask = np.zeros(self.n, dtype=np.float64)
        mask[self.device_idx] = 1.0
        return mask


class SceneFormatError(ValueError):
    """Malformed testcase input or output file."""


def read_input(path: str) -> Scene:
    with open(path, "r") as f:
        tokens = f.read().split()
    if len(tokens) < 3:
        raise SceneFormatError(f"{path}: missing header")
    it = iter(tokens)
    n = int(next(it))
    planet = int(next(it))
    asteroid = int(next(it))
    if n <= 0:
        raise SceneFormatError(f"{path}: body count {n} must be positive")
    if len(tokens) != 3 + 8 * n:
        raise SceneFormatError(
            f"{path}: expected {3 + 8 * n} tokens for n={n}, got {len(tokens)}")
    if not (0 <= planet < n and 0 <= asteroid < n):
        raise SceneFormatError(
            f"{path}: planet/asteroid indices ({planet}, {asteroid}) out of "
            f"range for n={n}")
    q = np.empty((n, 3), dtype=np.float64)
    v = np.empty((n, 3), dtype=np.float64)
    m = np.empty(n, dtype=np.float64)
    types = []
    device_idx = []
    for i in range(n):
        q[i, 0] = float(next(it))
        q[i, 1] = float(next(it))
        q[i, 2] = float(next(it))
        v[i, 0] = float(next(it))
        v[i, 1] = float(next(it))
        v[i, 2] = float(next(it))
        m[i] = float(next(it))
        t = next(it)
        types.append(t)
        if t == "device":
            device_idx.append(i)
    if not (np.isfinite(q).all() and np.isfinite(v).all()
            and np.isfinite(m).all()):
        raise SceneFormatError(f"{path}: non-finite body values")
    if (m < 0).any():
        raise SceneFormatError(f"{path}: negative masses")
    return Scene(n=n, planet=planet, asteroid=asteroid, q=q, v=v, m=m,
                 types=types,
                 device_idx=np.asarray(device_idx, dtype=np.int64))


def write_input(path: str, scene: Scene) -> None:
    """Write a scene in the testcase format. '%.16e' carries 17 significant
    digits, so every float64 reads back to the same bits."""
    with open(path, "w") as f:
        f.write(f"{scene.n} {scene.planet} {scene.asteroid}\n")
        for i in range(scene.n):
            f.write(" ".join("%.16e" % x for x in (*scene.q[i], *scene.v[i],
                                                   scene.m[i]))
                    + f" {scene.types[i]}\n")


def _sci(x: float) -> str:
    """C++ `std::scientific << std::setprecision(17)`-compatible formatting
    (16 digits after the point, signed exponent of at least 2 digits)."""
    return "%.16e" % float(x)


def format_output(min_dist: float, hit_time_step: int,
                  gravity_device_id: int, missile_cost: float) -> str:
    return "%s\n%d\n%d %s\n" % (
        _sci(min_dist), int(hit_time_step), int(gravity_device_id),
        _sci(missile_cost),
    )


def write_output(path: str, min_dist: float, hit_time_step: int,
                 gravity_device_id: int, missile_cost: float) -> None:
    with open(path, "w") as f:
        f.write(format_output(min_dist, hit_time_step,
                              gravity_device_id, missile_cost))


def parse_output(text: str):
    """Parse a 3-line .out file into (min_dist, hit_step, device_id, cost),
    raising SceneFormatError on malformed text."""
    lines = text.strip().split("\n")
    if len(lines) != 3:
        raise SceneFormatError(
            f"output: expected 3 lines, got {len(lines)}")
    try:
        min_dist = float(lines[0])
        hit_step = int(lines[1])
        parts = lines[2].split()
        if len(parts) != 2:
            raise ValueError(
                f"line 3 must be 'device_id missile_cost', got "
                f"{lines[2]!r}")
        dev, cost = int(parts[0]), float(parts[1])
    except ValueError as e:
        raise SceneFormatError(f"output: {e}") from e
    return min_dist, hit_step, dev, cost
