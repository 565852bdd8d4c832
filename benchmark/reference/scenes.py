"""The benchmark's scenes, made from seeds with numpy alone.

- `graded_scene`: a graded testcase built from a cell's template (data in
  `workloads/<cell>.json`): the template's planet, asteroid and gravity
  devices as given, and a background of stars drawn from the run's seed.
  The templates are designed to the assignment's recorded answers (hit
  step, saving device) with a deterministic encounter, so every seed keeps
  the hit step, the arrivals and the saving device, and with them the
  work of each problem; the check of every run (`reference/hw5.py`)
  recomputes them.
- `plummer_scene`: a frozen copy of the port's own generator
  (`nbody_tpu_torch.models.plummer.plummer_scene`; Plummer 1911, GPU Gems
  3 ch. 31's initial condition), so that the yardstick does not move when
  the program does.

A scene is a dict of numpy arrays: q (n, 3), v (n, 3), m (n,) float64,
types (list of str), planet, asteroid and devices (int64 body indices,
ascending).
"""

from __future__ import annotations

import numpy as np

# numpy's RandomState takes seeds below 2**32; the driver's seeds may be
# larger, so a seed is folded into that range
SEED_RANGE = 2 ** 32


def graded_scene(template: dict, seed: int) -> dict:
    """A graded scene of `template["n"]` bodies: the template's own bodies
    (planet, asteroid, devices) at their indices, exactly as given, and
    every other index a background star drawn from `seed`: a direction
    uniform on the sphere at a radius uniform in `background.radius`, a
    velocity normal at `background.speed` a component, a mass
    |normal| * 10**U(background.mass_exp). The stars lie far outside the
    encounter, so every seed keeps the template's discrete answers and
    with them each problem's work; they still cost the kernels their n²
    pairs a step."""
    n = int(template["n"])
    bg = template["background"]
    q, v = np.zeros((n, 3)), np.zeros((n, 3))
    m = np.zeros(n)
    types = [bg["type"]] * n
    own = sorted(template["bodies"], key=lambda b: b["index"])
    for b in own:
        i = int(b["index"])
        q[i], v[i], m[i], types[i] = b["q"], b["v"], b["m"], b["type"]
    stars = np.setdiff1d(np.arange(n), [b["index"] for b in own])
    k = stars.size
    rng = np.random.RandomState(seed % SEED_RANGE)
    way = rng.randn(k, 3)
    way /= np.linalg.norm(way, axis=1, keepdims=True)
    q[stars] = way * rng.uniform(*bg["radius"], size=k)[:, None]
    v[stars] = rng.randn(k, 3) * bg["speed"]
    m[stars] = np.abs(rng.randn(k)) * 10.0 ** rng.uniform(*bg["mass_exp"],
                                                          size=k)

    def one(kind):
        (i,) = [b["index"] for b in own if b["type"] == kind]
        return int(i)

    devices = [b["index"] for b in own if b["type"] == "device"]
    return {"q": q, "v": v, "m": m, "types": types, "planet": one("planet"),
            "asteroid": one("asteroid"),
            "devices": np.asarray(devices, np.int64)}


def plummer_scene(n: int, *, seed: int, total_mass: float = 1e15,
                  scale_radius: float = 1e6,
                  G: float = 6.674e-11) -> tuple:
    """(q, v, m) float64 of an approximately virialised Plummer sphere,
    the draws of `nbody_tpu_torch.models.plummer.plummer_scene`."""
    rs = np.random.RandomState(seed % SEED_RANGE)
    m = np.full(n, total_mass / n)
    x = rs.uniform(0.0, 1.0, n)
    r = scale_radius / np.sqrt(np.maximum(x ** (-2.0 / 3.0) - 1.0, 1e-12))
    mu = rs.uniform(-1.0, 1.0, n)
    phi = rs.uniform(0.0, 2 * np.pi, n)
    st = np.sqrt(1 - mu * mu)
    q = (r[:, None] * np.stack([st * np.cos(phi), st * np.sin(phi), mu],
                               axis=1))
    # velocities: von Neumann rejection from g(x) = x^2 (1-x^2)^(7/2)
    ve = np.sqrt(2.0 * G * total_mass) * (r * r + scale_radius ** 2) ** -0.25
    xv = np.empty(n)
    todo = np.arange(n)
    while todo.size:
        x1 = rs.uniform(0.0, 1.0, todo.size)
        x2 = rs.uniform(0.0, 0.1, todo.size)
        ok = x2 < x1 * x1 * (1.0 - x1 * x1) ** 3.5
        xv[todo[ok]] = x1[ok]
        todo = todo[~ok]
    vmag = xv * ve
    mu_v = rs.uniform(-1.0, 1.0, n)
    phi_v = rs.uniform(0.0, 2 * np.pi, n)
    st_v = np.sqrt(1 - mu_v * mu_v)
    v = vmag[:, None] * np.stack(
        [st_v * np.cos(phi_v), st_v * np.sin(phi_v), mu_v], axis=1)
    q -= q.mean(0)
    v -= v.mean(0)
    return q, v, m


def write_in(path: str, scene: dict) -> None:
    """The scene as a testcase `.in` (hw5 format; '%.16e' carries 17
    significant digits, so every float64 reads back to the same bits)."""
    lines = [f"{len(scene['m'])} {scene['planet']} {scene['asteroid']}\n"]
    for i, t in enumerate(scene["types"]):
        vals = (*scene["q"][i], *scene["v"][i], scene["m"][i])
        lines.append(" ".join("%.16e" % x for x in vals) + f" {t}\n")
    with open(path, "w") as f:
        f.writelines(lines)
