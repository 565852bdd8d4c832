"""The device mesh: torch.distributed ranks in a ('scen', 'body') grid.

The port of `nbody_tpu.parallel.mesh`. The JAX package builds a
`jax.sharding.Mesh` of the chips one process sees; here every rank is a
process with one device (`cuda:LOCAL_RANK` on GPUs, the CPU for the tests),
and the mesh is a `torch.distributed.device_mesh.DeviceMesh` over the
default process group:

    'scen' — scenario parallelism: the P1/P2 rows and the Problem-3
             scenarios spread over the mesh's rows (the reference's two
             GPUs, hw5.cu:564-588);
    'body' — body parallelism: the force's rows (binary64, double-double)
             or the bodies themselves (float32, the ordered ring) split over
             the ranks of a row.

`init_process_group` opens the default group: under `torchrun` through its
environment rendezvous, alone as a group of one rank through a `file://`
store in a fresh temporary directory (no TCP port, so processes started
side by side cannot collide). The backend follows the device: NCCL for
'cuda', gloo for 'cpu'.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

AXES = ("scen", "body")


def _under_launcher() -> bool:
    """Whether a launcher (torchrun) set the env rendezvous."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                         "MASTER_PORT"))


def rank_device(device: str) -> torch.device:
    """This rank's device: 'cuda' is cuda:LOCAL_RANK (raises without a
    card), 'cpu' the CPU."""
    if resolve_device(device).type == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def init_process_group(device: str = "cuda") -> torch.device:
    """Open the default process group if none is open, and return this
    rank's device. NCCL for 'cuda', gloo for 'cpu'; an open group is kept
    as it is."""
    dev = rank_device(device)
    if dist.is_initialized():
        return dev
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if _under_launcher():
        dist.init_process_group(backend, init_method="env://")
        return dev
    tmp = tempfile.mkdtemp(prefix="nbody_mesh_")
    dist.init_process_group(backend,
                            init_method="file://" + os.path.join(tmp, "store"),
                            rank=0, world_size=1)
    atexit.register(shutil.rmtree, tmp, True)
    return dev


def close() -> None:
    """Close the default process group if one is open."""
    if dist.is_initialized():
        dist.destroy_process_group()


def mesh_sizes(axes: dict, world: int) -> tuple[int, int]:
    """(scen, body) of an {axis: size} spec on `world` ranks: one size may
    be -1 (inferred), a missing axis is 1, and the product must be the
    world size: a process group has no idle ranks to leave out, where
    `jax.devices()` may list more chips than a mesh takes."""
    unknown = set(axes) - set(AXES)
    if unknown:
        raise ValueError(f"mesh axes are 'scen' and 'body', got {axes}")
    sizes = [int(axes.get(name, 1)) for name in AXES]
    if sizes.count(-1) > 1:
        raise ValueError(f"mesh {axes}: at most one size may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if known < 1 or world % known:
            raise ValueError(f"mesh {axes}: {world} ranks do not divide "
                             f"into rows of {known}")
        sizes[sizes.index(-1)] = world // known
    if min(sizes) < 1:
        raise ValueError(f"mesh sizes must be positive, got {axes}")
    if sizes[0] * sizes[1] != world:
        raise ValueError(
            f"mesh {axes} takes {sizes[0] * sizes[1]} ranks but the process "
            f"group has {world}: every rank of a process group takes part "
            "in its collectives, so the mesh must use them all (start as "
            "many ranks as the mesh has, e.g. torchrun --nproc-per-node)")
    return sizes[0], sizes[1]


def make_mesh(axes: dict, device: str = "cuda"):
    """A DeviceMesh of the default process group (opened here if needed),
    shaped (scen, body) from {axis_name: size} with
    mesh_dim_names=('scen', 'body')."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = init_process_group(device)
    shape = mesh_sizes(axes, dist.get_world_size())
    return init_device_mesh(dev.type, shape, mesh_dim_names=AXES)


def check_mesh(mesh) -> None:
    """Raise TypeError unless `mesh` is a DeviceMesh with the dims
    ('scen', 'body') (make_mesh's)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or \
            tuple(mesh.mesh_dim_names or ()) != AXES:
        raise TypeError(f"mesh must be a DeviceMesh with mesh_dim_names "
                        f"{AXES} (parallel.make_mesh), got {mesh!r}")


def axis(mesh, name: str):
    """(process group, this rank's index on it, its size) of mesh axis
    `name`."""
    return (mesh.get_group(name), mesh.get_local_rank(name),
            mesh.size(AXES.index(name)))


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def parse_mesh_spec(spec: str) -> dict:
    """'scen=S,body=B' -> {'scen': S, 'body': B} (order preserved; a
    missing axis is 1)."""
    axes = {}
    for part in spec.split(","):
        if "=" not in part:
            raise ValueError(
                f"--mesh expects comma-separated axis=size pairs "
                f"(e.g. scen=2,body=4); got {spec!r}")
        name, _, size = part.partition("=")
        name = name.strip()
        if name not in AXES:
            raise ValueError(
                f"--mesh axis must be 'scen' or 'body'; got {name!r}")
        if name in axes:
            raise ValueError(f"--mesh axis {name!r} given twice")
        axes[name] = int(size)
    for name in AXES:
        axes.setdefault(name, 1)
    return axes
