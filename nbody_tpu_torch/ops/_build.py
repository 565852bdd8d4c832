"""Build and load the package's hand-written CUDA kernels.

nvcc compiles each of `csrc/*.cu` to an object, one process per source,
all started together, and links them into one shared library with a plain
C interface, `_build/libnbody_kernels.so`, loaded with ctypes. The build
runs at first use and again whenever a source, a shared header (`*.cuh`)
or the flags change (a SHA-256 stamp beside the library). Nothing here
runs at import: this module is imported on machines that have no nvcc.
`build_variant` builds another copy of the sources into a library of its
own, for a measurement that times a variant against this build;
`build_chunk_variants` builds several copies of the binary64 graded step
alone at once.
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
           "graded_step_f64.cu", "graded_step_f32.cu", "graded_step_dd.cu",
           "sim_step_f64.cu", "sim_step_f32.cu", "sim_step_dd.cu")
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


def _compile_and_link(libs: dict, sources: tuple = SOURCES) -> None:
    """Compile `sources` from each directory of libs ({lib_path: csrc}),
    every nvcc process at once, and link each directory's objects into its
    lib_path."""
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(next(iter(libs)))) as tmp:
        compiles, links = [], []
        for k, (lib_path, csrc) in enumerate(libs.items()):
            objs = [os.path.join(tmp, f"{k}_{name}.o") for name in sources]
            compiles += [[_nvcc(), *NVCC_FLAGS, "-c", "-o", obj,
                          os.path.join(csrc, name)]
                         for name, obj in zip(sources, objs)]
            lib = os.path.join(tmp, f"{k}_{os.path.basename(lib_path)}")
            links.append((lib, lib_path,
                          [_nvcc(), "-shared", "-o", lib, *objs]))
        _nvcc_all(compiles)
        _nvcc_all([cmd for _, _, cmd in links])
        for lib, lib_path, _ in links:
            os.replace(lib, lib_path)


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
            _compile_and_link({LIB_PATH: CSRC})
            with open(stamp, "w") as f:
                f.write(digest)
    finally:
        os.close(fd)
    return declare(ctypes.CDLL(LIB_PATH))


def build_variant(csrc: str, lib_path: str) -> ctypes.CDLL:
    """Build a library from another copy of the sources, the directory
    csrc (e.g. with one constant edited, to time a variant against this
    one in one process), into lib_path, a name no other loaded library
    has; load it and declare its entry points."""
    _compile_and_link({lib_path: csrc})
    return declare(ctypes.CDLL(lib_path))


def build_chunk_variants(libs: dict) -> dict:
    """Build `graded_step_f64.cu` alone from each directory of libs
    ({lib_path: csrc}, copies of the sources edited, or another checkout's
    own), all at once, each into its lib_path; load each and declare the
    entry points of `graded_step_f64.cu` it has as this build declares
    them (`graded_chunk_f64_launch`'s signature every checkout since the
    graded graphs shares). Returns {lib_path: lib}."""
    _compile_and_link(libs, ("graded_step_f64.cu",))
    ref = load()
    out = {}
    for lib_path in libs:
        lib = out[lib_path] = ctypes.CDLL(lib_path)
        for name in ("graded_chunk_f64_launch", "graded_step_f64_geometry",
                     "graded_step_f64_info"):
            if hasattr(lib, name):
                fn, want = getattr(lib, name), getattr(ref, name)
                fn.restype, fn.argtypes = want.restype, want.argtypes
    return out


def declare(lib):
    """Declare every entry point's C signature on the loaded library lib;
    returns lib."""
    lib.accel_f64_launch.restype = ctypes.c_int
    lib.accel_f64_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # qi, qj, gm
        ctypes.c_void_p, ctypes.c_int,                       # a, B
        ctypes.c_int, ctypes.c_int, ctypes.c_double,         # ni, nj, eps2
        ctypes.c_int,                                        # dist3
        ctypes.c_void_p,                                     # cudaStream_t
    ]
    # simulate's step kernels: st0, st1, m0, mh, fst, n, integrator, then
    # compensated (f64, f32) and dist3 (f64); G, dt, kick and eps2 (dd:
    # eps2 as hi, lo); the persistent chunks' grid cap (f64, f32); the
    # base step's device word t0, K, the host int that receives the
    # launches made, cudaStream_t
    for name, ints, real, reals, cap in (
            ("sim_chunk_f64_launch", 4, ctypes.c_double, 4, 1),
            ("sim_chunk_f32_launch", 3, ctypes.c_float, 4, 1),
            ("sim_chunk_dd_launch", 2, ctypes.c_double, 5, 0)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [*[ctypes.c_void_p] * 5, *[ctypes.c_int] * ints,
                       *[real] * reals, *[ctypes.c_int] * cap,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
    # a chunk of grid syncs alone in a persistent chunk's grid: n, K, grid
    # cap, cudaStream_t
    for name in ("sim_barrier_f64_launch", "sim_barrier_f32_launch"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [*[ctypes.c_int] * 3, ctypes.c_void_p]
    # sim_rows_*_step, a mesh rank's launch: in, out, m0, mh, fst; n, ni,
    # k, r0, integrator, then compensated (f64, f32), dist3 (f64) or the
    # tile (f32); G, dt, kick and eps2 as sim_chunk_*_launch has them; the
    # word t0, the offset in the chunk, next, cudaStream_t
    for name, ints, real, reals in (
            ("sim_rows_f64_step", 7, ctypes.c_double, 4),
            ("sim_rows_f32_step", 7, ctypes.c_float, 4),
            ("sim_rows_dd_step", 5, ctypes.c_double, 5)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [*[ctypes.c_void_p] * 5, *[ctypes.c_int] * ints,
                       *[real] * reals, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
    lib.div_probe_launch.restype = ctypes.c_int
    lib.div_probe_launch.argtypes = [
        *[ctypes.c_void_p] * 4,                  # n, d, want, got
        ctypes.c_int, ctypes.c_void_p,           # count, cudaStream_t
    ]
    lib.sim_step_slots.restype = ctypes.c_int
    lib.sim_step_slots.argtypes = []
    # what the card says of B2 and the double-double step kernel (int
    # out[5], forces.cuh kernel_info) and of the persistent binary64 and
    # float32 chunks (int out[7], sim_step.cuh sim_persistent_info): B2 at
    # n rows, the chunks at n bodies (n, integrator, compensated; dist3 in
    # binary64), the dd step kernel of one variant
    lib.accel_f32_info.restype = ctypes.c_int
    lib.accel_f32_info.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.sim_step_f32_info.restype = ctypes.c_int
    lib.sim_step_f32_info.argtypes = [*[ctypes.c_int] * 3, ctypes.c_void_p]
    lib.sim_step_f64_info.restype = ctypes.c_int
    lib.sim_step_f64_info.argtypes = [*[ctypes.c_int] * 4, ctypes.c_void_p]
    lib.sim_step_dd_info.restype = ctypes.c_int
    lib.sim_step_dd_info.argtypes = [ctypes.c_int, ctypes.c_void_p]
    # what the card says of a binary64 force kernel (int out[7])
    lib.accel_f64_info.restype = ctypes.c_int
    lib.accel_f64_info.argtypes = [ctypes.c_void_p]
    # B1''s launch-a-step kernel at (B, n) (int out[11]); its geometry at
    # (B, n, ni) (int out[5])
    lib.graded_step_f64_info.restype = ctypes.c_int
    lib.graded_step_f64_info.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
    lib.graded_step_f64_geometry.restype = ctypes.c_int
    lib.graded_step_f64_geometry.argtypes = [*[ctypes.c_int] * 3,
                                             ctypes.c_void_p]
    # what the resident chunk is at (B, n, D) (int out[9])
    lib.graded_resident_f64_info.restype = ctypes.c_int
    lib.graded_resident_f64_info.argtypes = [*[ctypes.c_int] * 3,
                                             ctypes.c_void_p]
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
    # G, dt, eps2, r2 (each as (hi, lo) for double-double); the device
    # word of the base step s0, the chunk's K steps and the host int that
    # receives the launches made (binary64: two, the launches made and the
    # step launches made as programmatic dependents)
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
            ctypes.c_void_p, ctypes.c_int,                   # s0, K
            ctypes.c_void_p,                                 # launched
            ctypes.c_void_p,                                 # cudaStream_t
        ]
    # graded_rows_*_step: the chunk's pointers from m0 to v_snap; (mode, B,
    # n, D, planet, p1, p2, ni, k), dist3 in binary64 or the tile in
    # float32, the reals as above; then the launch's qv, qv_out, r0, the
    # base step's device word, the step's offset in the chunk, check and
    # stream
    for name, ints, real, reals in (
            ("graded_rows_f64_step", 1, ctypes.c_double, 4),
            ("graded_rows_f32_step", 1, ctypes.c_float, 4),
            ("graded_rows_dd_step", 0, ctypes.c_double, 8)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            *[ctypes.c_void_p] * 12,
            *[ctypes.c_int] * (9 + ints),
            *[real] * reals,
            ctypes.c_void_p, ctypes.c_void_p,                # qv, qv_out
            ctypes.c_int, ctypes.c_void_p,                   # r0, s0
            ctypes.c_int, ctypes.c_int,                      # off, check
            ctypes.c_void_p,                                 # cudaStream_t
        ]
    lib.graded_step_dd_info.restype = ctypes.c_int
    lib.graded_step_dd_info.argtypes = [
        ctypes.c_int, ctypes.c_void_p,                       # n, int out[10]
    ]
    # what a CUDA graph holds (int out[5]): graph_edge_counts(cudaGraph_t,
    # out)
    lib.graph_edge_counts.restype = ctypes.c_int
    lib.graph_edge_counts.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.fold_floor_f64_launch.restype = ctypes.c_int
    lib.fold_floor_f64_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # x, out, ns
        ctypes.c_int, ctypes.c_int,                          # n, reps
        ctypes.c_void_p,                                     # cudaStream_t
    ]
    return lib
