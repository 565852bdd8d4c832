"""Build and load the package's hand-written CUDA kernels.

nvcc compiles each of `csrc/*.cu` to an object, one process per source,
all started together, and links them into one shared library with a plain
C interface, `_build/libnbody_kernels.so`, loaded with ctypes. The build
runs at first use and again whenever a source, a shared header (`*.cuh`)
or the flags change (a SHA-256 stamp beside the library). Nothing here
runs at import: this module is imported on machines that have no nvcc.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libnbody_kernels.so")
SOURCES = ("accel_f64.cu", "accel_f32.cu", "accel_mxu.cu", "accel_dd.cu",
           "graded_step_f64.cu", "graded_step_f32.cu", "graded_step_dd.cu")
# -fmad=false: no a*b+c contraction anywhere on the fp64 path (kernels B1 and
# B4 also spell every op as a round-to-nearest intrinsic; B4's one fused
# multiply-add, the exact product error, is an explicit __fma_rn, which the
# flag leaves alone). It applies to the whole
# library, so kernels B2's and B3's fp32 multiply-adds are not fused either
# (the cost is noted in csrc/accel_f32.cu; for B3 it keeps every product and
# sum rounded as the plain version rounds them)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return path


def source_digest() -> str:
    """SHA-256 of the flags and of every source and header in `CSRC`, so an
    edited shared header rebuilds the library too."""
    h = hashlib.sha256(repr((NVCC_FLAGS, SOURCES)).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()


def _nvcc_all(cmds) -> None:
    """Run every nvcc command at once; raise with the errors of all that
    failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed with code {proc.returncode}:\n"
                          f"{' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _compile_and_link(digest: str, stamp: str) -> None:
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, name + ".o") for name in SOURCES]
        _nvcc_all([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj,
                   os.path.join(CSRC, name)]
                  for name, obj in zip(SOURCES, objs))
        lib = os.path.join(tmp, os.path.basename(LIB_PATH))
        _nvcc_all([[_nvcc(), "-shared", "-o", lib, *objs]])
        os.replace(lib, LIB_PATH)
    with open(stamp, "w") as f:
        f.write(digest)


@functools.cache
def load() -> ctypes.CDLL:
    """Build the kernel library if it is missing or stale, load it, and
    declare every entry point's C signature."""
    digest = source_digest()
    stamp = LIB_PATH + ".sha256"
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd = os.open(BUILD_DIR, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)   # one build at a time
        fresh = os.path.exists(LIB_PATH) and os.path.exists(stamp)
        if fresh:
            with open(stamp) as f:
                fresh = f.read().strip() == digest
        if not fresh:
            _compile_and_link(digest, stamp)
    finally:
        os.close(fd)
    lib = ctypes.CDLL(LIB_PATH)
    lib.accel_f64_launch.restype = ctypes.c_int
    lib.accel_f64_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # qi, qj, gm
        ctypes.c_void_p, ctypes.c_int,                       # a, B
        ctypes.c_int, ctypes.c_int, ctypes.c_double,         # ni, nj, eps2
        ctypes.c_int,                                        # dist3
        ctypes.c_void_p,                                     # cudaStream_t
    ]
    lib.accel_dd_launch.restype = ctypes.c_int
    lib.accel_dd_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # qi, qj, gm
        ctypes.c_void_p, ctypes.c_int,                       # a, B
        ctypes.c_int, ctypes.c_int,                          # ni, nj
        ctypes.c_double, ctypes.c_double,                    # eps2 hi, lo
        ctypes.c_void_p,                                     # cudaStream_t
    ]
    lib.accel_f32_launch.restype = ctypes.c_int
    lib.accel_f32_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # qi, qj, gmj
        ctypes.c_void_p, ctypes.c_int,                       # a, B
        ctypes.c_int, ctypes.c_int, ctypes.c_float,          # ni, nj, eps2
        ctypes.c_void_p,                                     # cudaStream_t
    ]
    lib.rsqrt_probe_launch.restype = ctypes.c_int
    lib.rsqrt_probe_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # x, want, got
        ctypes.c_int, ctypes.c_void_p,                       # n, cudaStream_t
    ]
    lib.accel_mxu_launch.restype = ctypes.c_int
    lib.accel_mxu_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, gm, a
        ctypes.c_int, ctypes.c_float,                        # n, eps2
        ctypes.c_int, ctypes.c_int,                # gram_bf16, accum_bf16
        ctypes.c_void_p,                                     # cudaStream_t
    ]
    # graded_chunk_*_launch: the ints after (mode, B, n, D, planet), then
    # G, dt, eps2, r2 (each as (hi, lo) for double-double)
    for name, ints, real, reals in (
            ("graded_chunk_f64_launch", 1, ctypes.c_double, 4),   # dist3
            ("graded_chunk_f32_launch", 0, ctypes.c_float, 4),
            ("graded_chunk_dd_launch", 0, ctypes.c_double, 8)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            *[ctypes.c_void_p] * 16,   # q, v, q2, v2, m0, mh, fst, md2,
            #                            others, arr, arr2, hit, flag,
            #                            min_d2, q_snap, v_snap
            *[ctypes.c_int] * (5 + ints),
            *[real] * reals,
            ctypes.c_int, ctypes.c_int,                      # s0, s1
            ctypes.c_void_p,                                 # cudaStream_t
        ]
    lib.graded_step_dd_info.restype = ctypes.c_int
    lib.graded_step_dd_info.argtypes = [
        ctypes.c_int, ctypes.c_void_p,                       # n, int out[10]
    ]
    lib.fold_floor_f64_launch.restype = ctypes.c_int
    lib.fold_floor_f64_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # x, out, ns
        ctypes.c_int, ctypes.c_int,                          # n, reps
        ctypes.c_void_p,                                     # cudaStream_t
    ]
    return lib
