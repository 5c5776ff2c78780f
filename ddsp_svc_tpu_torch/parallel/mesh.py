"""Process groups and the ('data', 'model') mesh.

Counterpart of `ddsp_svc_tpu/parallel/mesh.py`. JAX's mesh is a grid of
devices that one program spans; here each rank is a process with one
device, and an axis of the mesh is a process group: the ranks that share
the other axis's index. `init_distributed` joins the processes (NCCL, one
rank a card, or Gloo, which on CUDA tensors takes all_reduce and broadcast
only: the collectives the time-parallel paths use); `make_mesh` cuts the
world into the grid.
"""
from __future__ import annotations

from typing import Dict, Optional
from urllib.parse import urlsplit

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

_LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1")


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: int = 1, process_id: int = 0,
                     backend: Optional[str] = None, device=None) -> None:
    """Join this process to the default process group: `coordinator`
    'host:port' (rank 0 listens there; None: an in-process store, for one
    process only), `num_processes` ranks, this one `process_id`.
    backend: 'nccl' (CUDA only, one rank a card) or 'gloo'; None takes
    'nccl' on CUDA and 'gloo' on the CPU. device: this rank's device (CUDA
    unless the caller asks for the CPU; 'cuda' with no index is card
    process_id modulo the cards here), made current on CUDA. NCCL with more
    local ranks than cards raises: it refuses two ranks on one card."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", process_id % torch.cuda.device_count())
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the NCCL backend runs on CUDA devices only")
        host = urlsplit(f"//{coordinator}").hostname if coordinator else None
        if (coordinator is None or host in _LOCAL_HOSTS) \
                and num_processes > torch.cuda.device_count():
            raise ValueError(
                f"NCCL takes one rank a card: {num_processes} local ranks on "
                f"{torch.cuda.device_count()} card(s); use backend='gloo'")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if coordinator is None:
        if num_processes != 1:
            raise ValueError("more than one process needs a coordinator")
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)


class Mesh:
    """A ('data', 'model') grid of ranks: `shape` {axis: size}, this rank's
    `coords` {axis: index} and each axis's process group (None: the
    default group, when the axis spans the whole world), on `device`."""

    def __init__(self, shape: Dict[str, int], coords: Dict[str, int],
                 groups: Dict[str, Optional[dist.ProcessGroup]],
                 device: torch.device):
        self.shape, self.coords, self.groups = shape, coords, groups
        self.device = device

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups[axis]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device=None) -> Mesh:
    """The ('data', 'model') mesh of the joined processes: rank r at
    (r // n_model, r % n_model); n_data * n_model is the world size (all
    ranks on the data axis by default).
    Every rank calls it (making a group is collective). device: this
    rank's device (CUDA unless the caller asks for the CPU)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs init_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh on {world} ranks")
    grid = [[d * n_model + m for m in range(n_model)] for d in range(n_data)]
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    for axis, lines in (("data", [list(c) for c in zip(*grid)]),
                        ("model", grid)):
        for ranks in lines:  # every rank makes every group, in one order
            group = None if len(ranks) == world else dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = group
    return Mesh({"data": n_data, "model": n_model},
                {"data": rank // n_model, "model": rank % n_model}, groups,
                device)
