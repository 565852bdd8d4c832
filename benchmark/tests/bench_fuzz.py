"""Short-horizon graded scenes for the CPU tests.

`fuzz_scene` draws an asteroid aimed at a planet with gravity devices in
early missile range and a background of stars close by, so that a hit,
the arrivals and Problem 3's outcomes all come within a few hundred
steps; `template` turns one into a cell's template (its planet, asteroid
and devices as given, the background drawn from a seed far outside).
"""

import numpy as np

FAR = {"type": "star", "radius": [5e12, 2e13], "speed": 10.0,
       "mass_exp": [18.0, 22.0]}


def fuzz_scene(seed: int, n: int, n_devices: int) -> dict:
    rng = np.random.RandomState(seed)
    q = rng.randn(n, 3) * 10.0 ** rng.uniform(9, 11)
    v = rng.randn(n, 3) * 10.0 ** rng.uniform(2, 4)
    m = np.abs(rng.randn(n)) * 10.0 ** rng.uniform(20, 26, size=n)
    planet, asteroid = 0, 1
    m[planet] = 10.0 ** rng.uniform(24, 26)
    m[asteroid] = 10.0 ** rng.uniform(20, 23)
    q[planet] = rng.randn(3) * 1e9
    sep_dir = rng.randn(3)
    sep_dir /= np.linalg.norm(sep_dir)
    dist = 10.0 ** rng.uniform(8.5, 10.5)
    q[asteroid] = q[planet] + sep_dir * dist
    steps_to_close = rng.uniform(30, 400 if seed % 2 else 150)
    speed = dist / (steps_to_close * 60.0)
    v[asteroid] = -sep_dir * speed
    lat = rng.randn(3)
    lat -= lat @ sep_dir * sep_dir
    lat /= np.linalg.norm(lat)
    v[asteroid] += lat * speed * (rng.uniform(0.0, 3e7) / dist)
    v[planet] = rng.randn(3) * 1e2
    devices = []
    for k in range(n_devices):
        i = 2 + k
        devices.append(i)
        ddir = rng.randn(3)
        ddir /= np.linalg.norm(ddir)
        q[i] = q[planet] + ddir * 10.0 ** rng.uniform(8.3, 9.8)
        v[i] = v[planet] + rng.randn(3) * 1e2
        m[i] = 10.0 ** rng.uniform(25.5, 28)
    types = (["planet", "asteroid"] + ["device"] * n_devices
             + ["star"] * (n - 2 - n_devices))
    return {"q": q, "v": v, "m": m, "types": types, "planet": planet,
            "asteroid": asteroid, "devices": np.asarray(devices, np.int64)}


def template(seed: int, n: int, n_devices: int) -> dict:
    """A cell's template with fuzz_scene's planet, asteroid and devices."""
    sc = fuzz_scene(seed, n, n_devices)
    own = [sc["planet"], sc["asteroid"], *sc["devices"].tolist()]
    bodies = [{"index": int(i), "type": sc["types"][i],
               "q": sc["q"][i].tolist(), "v": sc["v"][i].tolist(),
               "m": float(sc["m"][i])} for i in own]
    return {"n": n, "bodies": bodies, "background": FAR}
