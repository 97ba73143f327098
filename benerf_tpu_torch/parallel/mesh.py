"""Ray-data parallelism over several GPUs: one process per card, parameters
replicated, each step's pixels sharded, one gradient all-reduce per step.

Port of benerf_tpu/parallel/mesh.py. The JAX package lays a 1-D "data" mesh
over its devices and lets XLA partition the step. Here each process of a
launch

    python -m torch.distributed.run --nproc_per_node N \\
        -m benerf_tpu_torch.cli.train --config ... --mesh_devices N

owns one card, renders its block of the step's pixels at every pose, and
sums its partial loss and gradients with the other ranks' in one all-reduce
(train/step.py). A `RayMesh` names the process group, this process's rank,
the world size, the device it computes on and the group's backend; None
means one process, as the JAX package's make_mesh returns None for one
device. Every collective launched here adds one to COLLECTIVES.

Refused where the JAX package adapts: a mesh size the launch cannot give
raises ValueError (JAX takes the first n of its devices).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from benerf_tpu_torch import cli_device
from benerf_tpu_torch.models.bridge import tree_leaves

# the environment torch.distributed.run gives each process it starts
LAUNCH_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR")
# collectives launched, over the process (a captured step's count at each
# replay: train/step.py)
COLLECTIVES = {"all_reduce": 0, "broadcast": 0}


@dataclass(frozen=True)
class RayMesh:
    """The ranks that share each step's rays."""

    group: Any            # torch.distributed ProcessGroup
    rank: int             # this process's rank in `group`
    size: int             # ranks in `group`
    device: torch.device  # where this rank computes
    backend: str          # "nccl" or "gloo"


def launched() -> bool:
    """Whether a launcher (torch.distributed.run) started this process."""
    return all(os.environ.get(k) for k in LAUNCH_ENV)


def initialize_distributed(device=None) -> Optional[torch.device]:
    """Join the launch's process group, iff a launcher started this process:
    NCCL on the card (cuda:LOCAL_RANK unless `device` names another, made
    current through cli_device), gloo when `device` is the CPU. Returns that
    device, or None without a launcher. Idempotent."""
    if not launched():
        return None
    device = None if device is None else torch.device(device)
    if device is None or device.type == "cuda":
        index = int(os.environ["LOCAL_RANK"])
        device = cli_device(index if device is None or device.index is None
                            else device.index)
    if not dist.is_initialized():
        if device.type == "cuda":
            dist.init_process_group("nccl", device_id=device)
        else:
            dist.init_process_group("gloo")
    return device


def finalize_distributed():
    """Leave the default process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def mesh_of_group(group=None, device=None) -> RayMesh:
    """The RayMesh of an initialized process group (default: the world's).
    device: where this rank computes (default: the current card under NCCL,
    the CPU under gloo)."""
    group = group or dist.group.WORLD
    backend = str(dist.get_backend(group))
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    return RayMesh(group, dist.get_rank(group), dist.get_world_size(group),
                   torch.device(device), backend)


def make_mesh(n_devices: int = -1, device=None) -> Optional[RayMesh]:
    """The mesh of the launch's n_devices processes (-1: as many as it
    started), or None for one process. An n_devices the launch cannot give
    raises ValueError: more than one without a launcher, or under a launch
    of w > 1 processes any count but w."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices == -1:
        n_devices = world
    if world == 1 and n_devices <= 1:
        return None
    if n_devices == world:
        return mesh_of_group(None, device)
    launch = (f"python -m torch.distributed.run --nproc_per_node {n_devices} "
              f"-m benerf_tpu_torch.cli.train ... --mesh_devices {n_devices}")
    if world == 1:
        raise ValueError(
            f"mesh_devices={n_devices} needs {n_devices} processes, one per "
            f"card, and this one was not started by a launcher: {launch}")
    raise ValueError(
        f"mesh_devices={n_devices}, but the launch started {world} "
        f"processes: set mesh_devices to {world} (or -1), or launch with "
        f"{launch}")


def shard_rows(x, mesh: Optional[RayMesh], dim: int = 0):
    """This rank's contiguous block of x along `dim` (torch.tensor_split: the
    first len % size ranks take one more); x itself without a mesh."""
    if mesh is None:
        return x
    return torch.tensor_split(x, mesh.size, dim=dim)[mesh.rank]


def all_reduce_flat(tensors, mesh: Optional[RayMesh]):
    """Sum each tensor over the ranks, in place, through one all-reduce of
    one flat buffer in the first tensor's dtype."""
    if mesh is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1).to(tensors[0].dtype) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    COLLECTIVES["all_reduce"] += 1
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks. Every rank's loss reads y, so the
    global loss's gradient w.r.t. y is the sum of the ranks' upstream
    gradients: the backward all-reduces them too."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.clone()
        dist.all_reduce(y, group=mesh.group)
        COLLECTIVES["all_reduce"] += 1
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.mesh.group)
        COLLECTIVES["all_reduce"] += 1
        return g, None


def all_reduce_sum(x, mesh: Optional[RayMesh]):
    """The sum of x over the ranks, differentiable; x without a mesh."""
    return x if mesh is None else _AllReduceSum.apply(x, mesh)


def replicate_tree(tree, mesh: Optional[RayMesh]):
    """Make every rank's leaves equal rank 0's, in place, through one
    broadcast of one flat buffer. Returns the tree."""
    if mesh is None:
        return tree
    leaves = tree_leaves(tree)
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1) for t in leaves])
        dist.broadcast(flat, src=dist.get_global_rank(mesh.group, 0),
                       group=mesh.group)
        COLLECTIVES["broadcast"] += 1
        for t, part in zip(leaves, flat.split([t.numel() for t in leaves])):
            t.copy_(part.view_as(t))
    return tree


def barrier(mesh: Optional[RayMesh]):
    """Wait until every rank of the mesh reaches this point."""
    if mesh is not None:
        dist.barrier(group=mesh.group)
