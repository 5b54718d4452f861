"""Process groups, meshes and the block layout of sharded tensors.

PyTorch counterpart of ``enflows_tpu/parallel/mesh.py``. JAX runs one
controller over many devices; the port runs one process per rank (SPMD by
``torch.distributed``), each on ``cuda:{LOCAL_RANK}`` unless the caller
asks for the CPU. A ``Mesh`` is the ranks of the world laid out row-major
over named axes, with one process group per line of each axis, so that a
collective over an axis runs among the ranks that differ only in that
axis's coordinate.

Layout (JAX's ``P(axis)``): a sharded axis is split into contiguous
blocks, rank r of the axis holding rows ``[r * n_local, (r + 1) *
n_local)``; ``shard_chains`` cuts a rank's block out of a global tensor and
``gather_chains`` puts the blocks back together. Entry points take the same
arguments on every rank (the global data, a generator seeded the same);
each rank draws every random tensor at the global size and keeps its block
(``mcmc.hmc.Rows``), so a sharded run follows the single-process run draw
for draw.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def distributed_init(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join the process group (``enflows_tpu/parallel/mesh.py:22-43``).

    A no-op when a group is already up, or when neither the arguments nor
    the environment ask for one. ``torchrun`` sets ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``, which are read as
    JAX reads ``COORDINATOR_ADDRESS``; explicit arguments (``init_method``
    ``tcp://host:port`` or ``file://path``) serve a manual start.
    ``backend``: by default NCCL where the rank's device is a card (the
    card ``cuda:{LOCAL_RANK}`` is made current first), gloo on the CPU.
    """
    if dist.is_initialized():
        return
    env_says_multi = "MASTER_ADDR" in os.environ and \
        "WORLD_SIZE" in os.environ
    if init_method is None and world_size is None and not env_says_multi:
        return
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


def local_device(cpu: bool = False) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` (0 without torchrun), or
    the CPU where the caller asks for it."""
    if cpu:
        return torch.device("cpu")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


class Axis:
    """One mesh axis as this rank sees it: its ``size``, this rank's
    coordinate ``index`` along it, the process ``group`` of the ranks that
    differ only in that coordinate (None for an axis of one rank with no
    group up, whose collectives are identities), those ranks' global ids
    ``ranks`` and the group's ``backend``."""

    def __init__(self, name: str, size: int, index: int, group, ranks):
        self.name, self.size, self.index = name, size, index
        self.group, self.ranks = group, list(ranks)
        self.backend = dist.get_backend(group) if group is not None else None

    def __repr__(self):
        return (f"Axis({self.name!r}, size={self.size}, index={self.index}, "
                f"backend={self.backend})")


class Mesh:
    """The world's ranks over named axes
    (``jax.sharding.Mesh``'s counterpart): ``shape`` an ordered ``{name:
    size}`` dict, ``axis_names`` the names in order, ``axis(name)`` this
    rank's :class:`Axis`, ``device`` the rank's device."""

    def __init__(self, axes: dict, device, axis_objs: dict):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)
        self.device = torch.device(device)
        self._axes = axis_objs

    def axis(self, name: str) -> Axis:
        if name not in self._axes:
            raise KeyError(f"mesh has no axis {name!r}; its axes are "
                           f"{self.axis_names}")
        return self._axes[name]

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def make_mesh(axes: Optional[dict] = None, axis_name: str = "chains",
              device=None) -> Mesh:
    """A mesh over the world (``enflows_tpu/parallel/mesh.py:46-65``).

    ``axes``: an ordered ``{name: size}`` whose sizes multiply to the world
    size; by default every rank on one axis ``axis_name``. Ranks are laid
    out row-major (the last axis varies fastest), as
    ``devices.reshape(sizes)``. Every rank must call this, in the same
    order: it builds a group per line of every axis. Without a process
    group the world is this one process, and a mesh of size 1 runs its
    collectives as identities. ``device``: the rank's device, by default
    its card (``cuda:{LOCAL_RANK}``) where a card is present, else the CPU
    (ranks that share one card pass ``device="cuda:0"``)."""
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    rank = dist.get_rank() if up else 0
    if axes is None:
        axes = {axis_name: world}
    sizes = tuple(int(s) for s in axes.values())
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh axes {axes} do not cover {world} ranks")
    if device is None:
        device = local_device(cpu=not torch.cuda.is_available())
    grid = np.arange(world).reshape(sizes)
    coords = np.unravel_index(rank, sizes)
    objs = {}
    for a, name in enumerate(axes):
        mine = None
        # Every rank creates every group, in one order (new_group is
        # collective over the world).
        lines = np.moveaxis(grid, a, -1).reshape(-1, sizes[a])
        for line in lines:
            ranks = [int(r) for r in line]
            group = dist.new_group(ranks) if up else None
            if rank in ranks:
                mine = (group, ranks)
        objs[name] = Axis(name, sizes[a], int(coords[a]), *mine)
    return Mesh(axes, device, objs)


def block_range(n: int, axis: Axis) -> tuple[int, int]:
    """This rank's rows ``[start, stop)`` of ``n`` global rows split in
    contiguous blocks over ``axis``; ``n`` must divide over it."""
    if n % axis.size:
        raise ValueError(f"{n} rows do not divide over {axis.size} "
                         f"'{axis.name}' shards")
    n_local = n // axis.size
    return axis.index * n_local, (axis.index + 1) * n_local


def shard_chains(x: torch.Tensor, mesh: Mesh, axis: str = "chains",
                 dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of the global tensor ``x`` along ``dim``
    (``shard_chains``/``chains_sharding`` of the JAX package), on the
    mesh's device."""
    lo, hi = block_range(x.shape[dim], mesh.axis(axis))
    return x.narrow(dim, lo, hi - lo).to(mesh.device).contiguous()


def gather_chains(x: torch.Tensor, mesh: Mesh, axis: str = "chains",
                  dim: int = 0) -> torch.Tensor:
    """The global tensor whose block along ``dim`` this rank holds: the
    inverse of ``shard_chains``, an ``all_gather`` over ``axis``."""
    from .collectives import all_gather
    return all_gather(x, mesh.axis(axis), dim=dim)
