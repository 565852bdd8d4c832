"""The mesh of ranks: body-sharded forces, and the layout on which the
graded solve's drivers run over a ('scen', 'body') grid of
torch.distributed processes (mesh.py, sharded.py, solver_sharded.py), the
port of `nbody_tpu.parallel`."""

from .mesh import init_process_group, make_mesh, parse_mesh_spec
from .sharded import make_sharded_step, ring_accel_ordered, \
    ring_pairwise_accel, simulate_sharded

__all__ = ["init_process_group", "make_mesh", "parse_mesh_spec",
           "ring_pairwise_accel", "ring_accel_ordered", "make_sharded_step",
           "simulate_sharded"]
