"""Rank layouts over torch.distributed (port of arnerf_tpu/parallel/mesh.py).

The reference scales with PyTorch-Lightning DDP over NCCL (reference
train.py:286-291, opt.py:49-50); the JAX package lays the same ranks out
as a device mesh. Here every rank is one process and one device: a `Mesh`
holds this rank's place in a (data, model) layout of `n_dp` x `n_mp`
ranks, rank `d * n_mp + m` (JAX's make_mesh_2d reshapes its device list
the same way), and the process groups of its row and column.
"""

import datetime
import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

# how long a collective waits for a missing rank before it raises
TIMEOUT = datetime.timedelta(minutes=10)


@dataclass(frozen=True)
class Mesh:
    """This rank's coordinates and groups in an (n_dp, n_mp) layout.

    `world` joins every rank, `data` the ranks that hold the same table
    rows (this rank's column: same model coordinate), `model` the ranks
    among which the table's rows are split (this rank's row: same data
    coordinate). `collective_bytes` counts the logical bytes each
    collective moved, by primitive name (parallel/accounting.py)."""
    n_dp: int
    n_mp: int
    rank: int
    world: object
    data: object
    model: object
    collective_bytes: dict = field(default_factory=dict, compare=False)

    @property
    def size(self) -> int:
        return self.n_dp * self.n_mp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.n_mp

    @property
    def mp_rank(self) -> int:
        return self.rank % self.n_mp

    def barrier(self):
        dist.barrier(group=self.world)


def init_distributed(device: torch.device):
    """Join the process group torchrun's environment describes (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL for a CUDA
    device, gloo for the CPU; the counterpart of maybe_init_distributed
    (mesh.py:25-45). Returns this rank's device (cuda:LOCAL_RANK on the
    card), or None when WORLD_SIZE is not set (one process, no group)."""
    if "WORLD_SIZE" not in os.environ:
        return None
    rank = int(os.environ["RANK"])
    world_size = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if device.type == "cuda":
        n = torch.cuda.device_count()
        if local_rank >= n:
            raise RuntimeError(f"rank {rank} asks for GPU {local_rank} but "
                               f"only {n} GPU(s) are visible")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://", rank=rank,
                            world_size=world_size, timeout=TIMEOUT)
    return device


def make_mesh_2d(n_dp: int, n_mp: int) -> Mesh:
    """The (data, model) layout of the initialised group's n_dp * n_mp
    ranks. Every rank creates every row and column group, in one order, as
    dist.new_group requires, and keeps the two that hold it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh_2d needs an initialised process "
                           "group (init_distributed)")
    world_size, rank = dist.get_world_size(), dist.get_rank()
    if n_dp * n_mp != world_size:
        raise ValueError(f"a {n_dp} x {n_mp} mesh needs {n_dp * n_mp} "
                         f"ranks; the process group has {world_size}")
    data = model = None
    for m in range(n_mp):
        g = dist.new_group([d * n_mp + m for d in range(n_dp)])
        if rank % n_mp == m:
            data = g
    for d in range(n_dp):
        g = dist.new_group([d * n_mp + m for m in range(n_mp)])
        if rank // n_mp == d:
            model = g
    return Mesh(n_dp, n_mp, rank, dist.group.WORLD, data, model)


def make_mesh(n: int = None) -> Mesh:
    """The 1-D data layout of all n ranks (default: the group's size)."""
    return make_mesh_2d(dist.get_world_size() if n is None else n, 1)
