"""The device mesh of a rank (counterpart of ofasys_tpu/parallel/mesh.py).

ofasys_tpu builds one ``jax.sharding.Mesh`` over every device and lets GSPMD
place each array. The port runs one process a rank, each on its own device
(``cuda:{local_rank % device_count}``, or the CPU when the caller asks), so
its mesh is this rank's view of the same six axes:

  data     — data parallelism (gradients summed here)
  fsdp     — data parallelism that also slices parameters and optimizer
             moments (parallel/sharding.Layout)
  tensor   — Megatron tensor parallelism (parallel/sharding.shard_model)
  sequence — ring attention over the sequence (parallel/ring_attention.py)
  expert   — expert parallelism of the MoE FFN (parallel/moe.py)
  pipe     — GPipe stages (parallel/pipeline.py)

Ranks are laid out row-major over ``MESH_AXES`` (the last axis varies
fastest), as ``np.asarray(devices).reshape(sizes)`` lays out devices. Each
axis has the process group of the ranks that share every other coordinate,
taken from a ``torch.distributed`` ``DeviceMesh``. A world of one (no
process group) gets a mesh without groups, and every collective of
parallel/distributed.py is then the identity.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ofasys_torch.configure.configs import ParallelConfig

MESH_AXES = ("data", "fsdp", "tensor", "sequence", "expert", "pipe")

# logical batch axes: batch rows are split over every data-like axis
BATCH_AXES = ("data", "fsdp")


def resolve_axis_sizes(cfg: ParallelConfig, n_devices: int) -> Tuple[int, ...]:
    sizes = [cfg.data, cfg.fsdp, cfg.tensor, cfg.sequence, cfg.expert, cfg.pipeline]
    n_auto = sum(1 for s in sizes if s == -1)
    if n_auto > 1:
        raise ValueError("at most one mesh axis may be -1")
    fixed = int(np.prod([s for s in sizes if s != -1]))
    if n_auto == 1:
        if n_devices % fixed != 0:
            raise ValueError(f"{n_devices} devices not divisible by fixed axes product {fixed}")
        sizes = [n_devices // fixed if s == -1 else s for s in sizes]
    if int(np.prod(sizes)) != n_devices:
        raise ValueError(f"mesh axes {dict(zip(MESH_AXES, sizes))} do not multiply to {n_devices} devices")
    return tuple(sizes)


class Mesh:
    """One rank's view of the mesh: ``shape`` (axis -> size), ``coords``
    (axis -> this rank's index), ``groups`` (axis -> process group, None in
    a world of one), ``device`` and ``backend`` (None in a world of one)."""

    def __init__(self, shape: Dict[str, int], coords: Dict[str, int],
                 groups: Dict[str, Optional[dist.ProcessGroup]], device: torch.device,
                 backend: Optional[str], rank: int = 0, device_mesh=None):
        self.shape = dict(shape)
        self.coords = dict(coords)
        self.groups = dict(groups)
        self.device = torch.device(device)
        self.backend = backend
        self.rank = rank
        self.device_mesh = device_mesh

    @property
    def world(self) -> int:
        return int(np.prod([self.shape[a] for a in MESH_AXES]))

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups.get(axis)

    def global_rank(self, **coords: int) -> int:
        """The world rank at this rank's coordinates with ``coords`` replaced."""
        c = dict(self.coords, **coords)
        r = 0
        for a in MESH_AXES:
            r = r * self.shape[a] + c[a]
        return r

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, coords={self.coords}, device={self.device}, backend={self.backend})"


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` when the caller names one (the CPU, as
    the tests ask), else ``cuda:{local_rank % device_count}``. Raises where
    CUDA is asked for and absent: nothing falls back to the CPU."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            return rank_device()
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("this rank's device is CUDA and CUDA is not available "
                           "(pass device='cpu' to run on the CPU)")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def build_mesh(cfg: Optional[ParallelConfig] = None, device=None) -> Mesh:
    """The mesh of ``cfg`` over the world of the default process group (a
    world of one when there is none)."""
    cfg = cfg or ParallelConfig()
    world = dist.get_world_size() if dist.is_initialized() else 1
    sizes = resolve_axis_sizes(cfg, world)
    dev = rank_device(device)
    shape = dict(zip(MESH_AXES, sizes))
    if not dist.is_initialized():
        return Mesh(shape, {a: 0 for a in MESH_AXES}, {a: None for a in MESH_AXES}, dev, None)
    from torch.distributed.device_mesh import init_device_mesh

    rank = dist.get_rank()
    coords = dict(zip(MESH_AXES, (int(c) for c in np.unravel_index(rank, sizes))))
    # the groups follow the backend; a 'cuda' DeviceMesh would also set each
    # rank's device from LOCAL_RANK, which names no device where several
    # ranks share one card (gloo)
    dm_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(dm_type, sizes, mesh_dim_names=MESH_AXES)
    groups = {a: dm.get_group(a) for a in MESH_AXES}
    return Mesh(shape, coords, groups, dev, dist.get_backend(), rank=rank, device_mesh=dm)


def single_device_mesh(device=None) -> Mesh:
    """A mesh of one rank on ``device`` (no process group)."""
    dev = rank_device(device)
    return Mesh({a: 1 for a in MESH_AXES}, {a: 0 for a in MESH_AXES},
                {a: None for a in MESH_AXES}, dev, None)


def batch_rows(mesh: Mesh, n_rows: int) -> slice:
    """This rank's rows of a global batch of ``n_rows``: the batch is split
    over data x fsdp (data the outer), as ``batch_sharding`` places it."""
    n = mesh.size("data") * mesh.size("fsdp")
    if n_rows % n != 0:
        raise ValueError(f"batch of {n_rows} rows does not divide over data*fsdp = {n}")
    per = n_rows // n
    i = mesh.index("data") * mesh.size("fsdp") + mesh.index("fsdp")
    return slice(i * per, (i + 1) * per)
