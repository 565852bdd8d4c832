"""nbody_tpu_torch — the N-body scenario engine on PyTorch and CUDA.

The port of `nbody_tpu` (JAX on a TPU) to one NVIDIA Hopper card. It answers
the same three scenario questions of NTHU IPC HW5 (min planet-asteroid
distance with devices off, first planet-hit step with devices on, cheapest
missile-destroyable device that saves the planet) and writes the same
byte-compatible 3-line `.out`.

The graded solve runs in IEEE binary64 on the card through kernel B1
(csrc/accel_f64.cu), a hand-written CUDA all-pairs force with the serial
spec's ascending-j fold: bit-identical to the native core
(native/core.cc, dsqrt mode). On the CPU every kernel has a plain PyTorch
twin with the same op order, which the tests hold against the JAX package.

`simulate` is the general API ("integrate this system for N steps"): in
'f32' it runs kernel B2 (csrc/accel_f32.cu), a hand-written CUDA fp32
all-pairs rsqrt force, in 'f64'/'e64'/'dd' kernel B1 (on one card inside
the binary64 step kernel, csrc/sim_step_f64.cu, one persistent launch a
chunk up to 512 bodies, one launch a step above), and
beyond binary64 ('tf3', 'ddp', 'dd+') kernel B4 (csrc/accel_dd.cu) in
double-double. The graded solve's 'tf3' runs the double-double graded step
kernel (csrc/graded_step_dd.cu), and every driver can checkpoint and
resume.
`parallel/` runs both over a ('scen', 'body') mesh of torch.distributed
ranks (NCCL on cards, gloo on the CPU), and `graft_entry` holds the entry
points. This package imports neither `jax` nor `nbody_tpu`.
"""

from .config import SimConfig
from .engine import Answers, solve_scene
from .io import Scene, format_output, read_input, write_output
from .simulate import SimState, simulate

__all__ = [
    "SimConfig",
    "Scene",
    "read_input",
    "write_output",
    "format_output",
    "Answers",
    "solve_scene",
    "SimState",
    "simulate",
]

__version__ = "0.1.0"
