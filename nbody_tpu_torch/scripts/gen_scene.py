"""Scene generator: testcase-format `.in` files from a seed.

    python -m nbody_tpu_torch.scripts.gen_scene out.in [--n 64]
        [--devices 2] [--black-holes 1] [--seed 0]

The port of the root `scripts/gen_scene.py`, with the same draws in the
same order, so the same arguments write a byte-equal file: a Plummer
background of stars at graded-case scales (`models/plummer.plummer_scene`,
bit-equal to the JAX package's), its centre and masses scattered; body 0
the planet, body 1 an asteroid aimed loosely at it; `--devices` gravity
devices near the planet and `--black-holes` black holes among the stars.
Written by `io.write_input` ('%.16e', so every float64 reads back to the
same bits). The graded testcases are not in the repo: scenes from here,
with goldens from `native/oracle`, make the corpus `run_golden` reads.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..io import Scene, write_input
from ..models.plummer import plummer_scene


def make_scene(n: int = 64, devices: int = 2, black_holes: int = 1,
               seed: int = 0) -> Scene:
    """The scene the root generator writes for these arguments."""
    rs = np.random.RandomState(seed)
    # background cluster at graded-case scales
    q, v, m = plummer_scene(n, seed=seed, total_mass=2e33,
                            scale_radius=3e19)
    q += rs.randn(3) * 1e19
    m *= np.exp(rs.randn(n) * 1.5)
    types = ["star"] * n

    # planet + asteroid on a rough collision-ish course
    planet, asteroid = 0, 1
    types[planet] = "planet"
    m[planet] = 5.5e24
    types[asteroid] = "asteroid"
    m[asteroid] = 8.5e22
    sep = rs.randn(3)
    sep *= 2.2e13 / np.linalg.norm(sep)
    q[asteroid] = q[planet] + sep
    v[asteroid] = v[planet] - sep / np.linalg.norm(sep) * 2.4e6 \
        + rs.randn(3) * 2e5

    # devices near the planet
    for i in rs.choice(np.arange(2, n), size=devices, replace=False):
        types[i] = "device"
        m[i] = abs(rs.randn()) * 5e24
        off = rs.randn(3)
        off *= (3e12 + abs(rs.randn()) * 3e13) / np.linalg.norm(off)
        q[i] = q[planet] + off
        v[i] = v[planet] + rs.randn(3) * 1e4
    for i in rs.choice([j for j in range(2, n) if types[j] == "star"],
                       size=black_holes, replace=False):
        types[i] = "black_hole"
        m[i] = abs(rs.randn()) * 4e36

    device_idx = [i for i, t in enumerate(types) if t == "device"]
    return Scene(n=n, planet=planet, asteroid=asteroid, q=q, v=v, m=m,
                 types=types, device_idx=np.asarray(device_idx, np.int64))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m nbody_tpu_torch.scripts.gen_scene",
        description="Write a testcase-format scene generated from a seed")
    p.add_argument("out")
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--devices", type=int, default=2)
    p.add_argument("--black-holes", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    write_input(args.out, make_scene(args.n, args.devices, args.black_holes,
                                     args.seed))
    print(f"wrote {args.out}: n={args.n}, devices={args.devices}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
