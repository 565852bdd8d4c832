"""ctypes binding to the native serial core (native/core.cc).

Serves precision 'exact' and is the oracle the tests and `chip_smoke.py`
hold the device path against. The library and the `oracle` CLI are built
on demand by `make -C native`, shared with the JAX package.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import platform
import subprocess

import numpy as np

from .config import SimConfig
from .io import Scene

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")

_DIST3_MODES = {"pow": 0, "dsqrt": 1, "sqrt3": 2}


def build(target: str) -> str:
    """Build `native/<target>` if it is missing and return its path.

    On aarch64 GCC contracts `a*b + c` into FMA by default, which breaks bit
    equality with the fp64 device kernel; the flag goes on the make command
    line so native/Makefile stays shared and unchanged."""
    path = os.path.join(NATIVE_DIR, target)
    cmd = ["make", "-C", NATIVE_DIR, target]
    if platform.machine() in ("aarch64", "arm64"):
        cmd.append("CXXFLAGS=-O3 -std=c++17 -Wall -Wextra -fPIC "
                   "-ffp-contract=off")
    # processes that build at once (test workers) take turns, and none sees
    # a half-written file; a lock on the directory leaves no lock file
    fd = os.open(NATIVE_DIR, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        if not os.path.exists(path):
            subprocess.run(cmd, check=True, capture_output=True)
    finally:
        os.close(fd)
    return path


@functools.cache
def _load():
    lib = ctypes.CDLL(build("libnbody_core.so"))
    lib.nbody_solve_cfg.restype = ctypes.c_int
    lib.nbody_solve_cfg.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,          # n, planet, asteroid
        ctypes.POINTER(ctypes.c_double),                   # q (n,3)
        ctypes.POINTER(ctypes.c_double),                   # v (n,3)
        ctypes.POINTER(ctypes.c_double),                   # m (n,)
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,      # device_idx, cnt
        ctypes.c_int, ctypes.c_int,                        # n_steps, mode
        ctypes.POINTER(ctypes.c_double),                   # phys[8]
        ctypes.POINTER(ctypes.c_double),                   # out_min_dist
        ctypes.POINTER(ctypes.c_int32),                    # out_hit_step
        ctypes.POINTER(ctypes.c_int32),                    # out_device_id
        ctypes.POINTER(ctypes.c_double),                   # out_cost
    ]
    return lib


def solve_exact(scene: Scene, cfg: SimConfig, dist3_mode: str = "pow"):
    """Solve all three problems with the native serial core; every physics
    constant in `cfg` passes through the C ABI (core.h nbody_solve_cfg).
    Returns (min_dist, hit_step, device_id, cost)."""
    lib = _load()
    q = np.ascontiguousarray(scene.q, dtype=np.float64)
    v = np.ascontiguousarray(scene.v, dtype=np.float64)
    m = np.ascontiguousarray(scene.m, dtype=np.float64)
    dev = np.ascontiguousarray(scene.device_idx, dtype=np.int32)
    phys = np.asarray([cfg.dt, cfg.eps, cfg.G, cfg.planet_radius,
                       cfg.missile_speed, cfg.missile_cost_base,
                       cfg.missile_cost_per_t, cfg.device_mass_period],
                      dtype=np.float64)
    dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    out_min = ctypes.c_double()
    out_hit = ctypes.c_int32()
    out_dev = ctypes.c_int32()
    out_cost = ctypes.c_double()
    rc = lib.nbody_solve_cfg(
        scene.n, scene.planet, scene.asteroid, dptr(q), dptr(v), dptr(m),
        dev.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        scene.device_cnt, cfg.n_steps, _DIST3_MODES[dist3_mode], dptr(phys),
        ctypes.byref(out_min), ctypes.byref(out_hit), ctypes.byref(out_dev),
        ctypes.byref(out_cost),
    )
    if rc != 0:
        raise RuntimeError(f"nbody_solve failed with code {rc}")
    return out_min.value, int(out_hit.value), int(out_dev.value), out_cost.value
