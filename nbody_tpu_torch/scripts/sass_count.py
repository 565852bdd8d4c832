"""Count, in the SASS, the fp64 instructions that kernels B4 and B4' issue
for one pair, and those of kernel B1's pair (B1', simulate's step).

    python -m nbody_tpu_torch.scripts.sass_count

Compiles, with the kernel library's flags (ops/_build.NVCC_FLAGS), probe
kernels that each do one piece of a pair's work and nothing else, on
values they load, so that nothing folds away: B4's pair term
(csrc/dd.cuh `dd_pair_terms<1>`), B4''s two interleaved pair terms
(`dd_pair_terms<2>`), the fold of one term component (`dd_fold_add`), the
pair term with the fold of its three components, and the graded step's
gm_j = (m0_j + mh_j * fst[t]) * G in double-double (csrc/graded.cuh
`graded_gm`), and kernel B1's binary64 pair term (csrc/forces.cuh
`b1_pair_term`, dsqrt) with the fold of its three components. It
disassembles them with `cuobjdump -sass`
and counts in each the fp64 instructions of the fast path (DADD, DMUL,
DFMA, MUFU.RCP64H, MUFU.RSQ64H) before the kernel's EXIT. The slow paths of
the binary64 divisions and roots, taken only for operands near the ends
of binary64's range, are subroutines placed after the EXIT; they are
counted apart. Prints one JSON object. Needs the CUDA toolkit (nvcc,
cuobjdump), not a card.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

from ..ops import _build

FP64 = ("DADD", "DMUL", "DFMA", "MUFU.RCP64H", "MUFU.RSQ64H")

PROBES = r"""
#include "dd.cuh"
#include "forces.cuh"
#include "graded.cuh"

using nbody::dd;

extern "C" __global__ void pair_term(const dd* in, dd* out) {
    const dd* p = in + threadIdx.x * 8;
    const dd xi[1] = {p[4]}, yi[1] = {p[5]}, zi[1] = {p[6]};
    dd t[1][3];
    nbody::dd_pair_terms<1>(p[0], p[1], p[2], p[3], xi, yi, zi, p[7], t);
    for (int c = 0; c < 3; ++c) out[threadIdx.x * 3 + c] = t[0][c];
}

extern "C" __global__ void pair_terms_2(const dd* in, dd* out) {
    const dd* p = in + threadIdx.x * 11;
    const dd xi[2] = {p[4], p[7]}, yi[2] = {p[5], p[8]}, zi[2] = {p[6], p[9]};
    dd t[2][3];
    nbody::dd_pair_terms<2>(p[0], p[1], p[2], p[3], xi, yi, zi, p[10], t);
    for (int c = 0; c < 6; ++c) out[threadIdx.x * 6 + c] = t[c / 3][c % 3];
}

extern "C" __global__ void fold(const dd* in, dd* acc) {
    dd a = acc[threadIdx.x];
    nbody::dd_fold_add(a, in[threadIdx.x]);
    acc[threadIdx.x] = a;
}

extern "C" __global__ void pair_term_and_fold(const dd* in, dd* acc) {
    const dd* p = in + threadIdx.x * 8;
    const dd xi[1] = {p[4]}, yi[1] = {p[5]}, zi[1] = {p[6]};
    dd t[1][3];
    nbody::dd_pair_terms<1>(p[0], p[1], p[2], p[3], xi, yi, zi, p[7], t);
    for (int c = 0; c < 3; ++c) {
        dd a = acc[threadIdx.x * 3 + c];
        nbody::dd_fold_add(a, t[0][c]);
        acc[threadIdx.x * 3 + c] = a;
    }
}

extern "C" __global__ void b1_pair_term_and_fold(const double* in,
                                                  double* acc) {
    const double* p = in + threadIdx.x * 8;
    double t[3];
    nbody::b1_pair_term<nbody::DIST3_DSQRT>(p[0], p[1], p[2], p[3], p[4],
                                            p[5], p[6], p[7], t[0], t[1],
                                            t[2]);
    for (int c = 0; c < 3; ++c)
        acc[threadIdx.x * 3 + c] = __dadd_rn(acc[threadIdx.x * 3 + c], t[c]);
}

extern "C" __global__ void gm(const dd* in, dd* out) {
    const dd* p = in + threadIdx.x * 4;
    out[threadIdx.x] = nbody::graded_gm(p[0], p[1], p[2], p[3]);
}
"""

_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def count_fp64(sass: str) -> dict:
    """By function of a `cuobjdump -sass` listing: the fp64 instructions
    before its first unpredicated EXIT (`fast`, by opcode, and their
    `total`), those after it (`slow`), and every instruction before the
    EXIT (`all_fast`)."""
    out, name, past_exit = {}, None, False
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            name, past_exit = m.group(1), False
            out[name] = {"fast": {op: 0 for op in FP64}, "total": 0,
                         "slow": 0, "all_fast": 0}
            continue
        m = _INSTR.search(line)
        if name is None or not m:
            continue
        pred, op = m.groups()
        rec = out[name]
        if op == "EXIT" and not pred:
            past_exit = True
        if not past_exit:
            rec["all_fast"] += 1
        key = op if op.startswith("MUFU") else op.split(".")[0]
        if key not in FP64:
            continue
        if past_exit:
            rec["slow"] += 1
        else:
            rec["fast"][key] += 1
            rec["total"] += 1
    return out


def global_loads(sass: str, name_part: str) -> dict:
    """By function of a `cuobjdump -sass` listing whose (mangled) name
    holds `name_part`: its global loads (`ldg`, opcodes LDG*), those of
    them through the non-coherent path (`constant`, a .CONSTANT suffix:
    ld.global.nc, which may return a value older than another block's
    write in the same launch), and its cp.async copies (`ldgsts`)."""
    out, name = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            name = m.group(1) if name_part in m.group(1) else None
            if name is not None:
                out[name] = {"ldg": 0, "constant": 0, "ldgsts": 0}
            continue
        m = _INSTR.search(line)
        if name is None or not m:
            continue
        op = m.group(2)
        if op.startswith("LDGSTS"):
            out[name]["ldgsts"] += 1
        elif op.startswith("LDG"):
            out[name]["ldg"] += 1
            out[name]["constant"] += ".CONSTANT" in op
    return out


def _tool(name: str) -> str:
    path = os.path.join(os.path.dirname(_build._nvcc()), name)
    if os.path.exists(path):
        return path
    found = shutil.which(name)
    if not found:
        raise RuntimeError(f"{name} not found beside nvcc or on PATH")
    return found


def sass_of_probes() -> str:
    """The probe kernels compiled with the library's flags, disassembled."""
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probes.cu")
        cubin = os.path.join(tmp, "probes.cubin")
        with open(src, "w") as f:
            f.write(PROBES)
        flags = [x for x in _build.NVCC_FLAGS if x not in ("-Xcompiler",
                                                           "-fPIC")]
        subprocess.run([_build._nvcc(), *flags, "-cubin", "-I", _build.CSRC,
                        "-o", cubin, src], check=True)
        return subprocess.run([_tool("cuobjdump"), "-sass", cubin],
                              check=True, capture_output=True,
                              text=True).stdout


def sass_of_library(path: str) -> str:
    """A built kernel library (ops/_build.LIB_PATH), disassembled."""
    return subprocess.run([_tool("cuobjdump"), "-sass", path], check=True,
                          capture_output=True, text=True).stdout


def main() -> int:
    counts = count_fp64(sass_of_probes())
    per_pair = counts["pair_term_and_fold"]["total"]
    print(json.dumps({"probes": counts, "fp64_per_pair": per_pair,
                      "two_rows_fp64_per_pair":
                          counts["pair_terms_2"]["total"] / 2,
                      "gm_fp64": counts["gm"]["total"],
                      "b1_fp64_per_pair":
                          counts["b1_pair_term_and_fold"]["total"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
