"""The data-parallel layout of a training run: a (dp, fsdp) grid of processes.

Counterpart of ``cosyvoice2_eu_tpu/parallel/mesh.py`` (reference:
cosy_repo/cosyvoice/utils/train_utils.py:45,100-152, NCCL DDP and DeepSpeed
ZeRO-2).  The JAX package lays a ('dp', 'fsdp') device mesh over one
controller and lets XLA insert the collectives.  The port runs one process
per GPU: process ``rank`` sits at ``(rank // fsdp, rank % fsdp)``, where
``np.asarray(devices).reshape(dp, fsdp)`` puts device ``rank``, and the
``fsdp`` processes of one row share a process group, over which
``train/optim.py::Optimizer`` shards its state (ZeRO-2: parameters and
gradients stay whole on every process).

Every process is a data-parallel worker: a global batch's rows split over
all ``world`` processes, not over ``dp`` alone.  JAX's ``P("dp")`` placement
does not show in its result, and a zero-length pad row adds nothing to a
masked loss (``parallel/train_step.py::make_step`` weights each process's
loss by its share of the global count).  The trainer pads nothing across
processes (each reads its own shards), so a loss that averages over rows,
DPO's preference term, counts only real rows where the JAX trainer counts
its pad rows too (ROADMAP section 3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from cosyvoice2_eu_torch.parallel.distributed import rank_and_world
from cosyvoice2_eu_torch.train.losses import IGNORE_ID
from cosyvoice2_eu_torch.utils.params import tree_map


@dataclasses.dataclass
class Mesh:
    """This process's place in the (dp, fsdp) grid.

    ``fsdp_group`` is the process group of the grid row (``None`` when
    ``fsdp`` is 1); ``rank`` / ``world`` are the process group's."""

    dp: int
    fsdp: int
    rank: int
    world: int
    fsdp_group: Optional[object] = None

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "fsdp": self.fsdp}

    @property
    def coords(self) -> tuple[int, int]:
        """(dp index, fsdp index) of this process."""
        return self.rank // self.fsdp, self.rank % self.fsdp

    @property
    def fsdp_rank(self) -> int:
        return self.rank % self.fsdp


def make_mesh(dp: int = -1, fsdp: int = 1) -> Mesh:
    """The grid over the process group's ``world`` processes (one process
    without a group); ``dp=-1`` takes ``world // fsdp``.  Raises
    ``ValueError`` unless ``dp * fsdp == world``.  Every process must call
    it, in the same order as its other collectives: it makes the rows'
    process groups."""
    rank, world = rank_and_world()
    if fsdp < 1:
        raise ValueError(f"fsdp must be at least 1, got {fsdp}")
    if dp == -1:
        dp = world // fsdp
    if dp * fsdp != world:
        raise ValueError(f"dp({dp}) * fsdp({fsdp}) != world size ({world})")
    group = None
    if fsdp > 1:
        if fsdp == world:
            group = dist.group.WORLD
        else:
            for row in range(dp):  # every process makes every row's group
                g = dist.new_group(list(range(row * fsdp, (row + 1) * fsdp)))
                if row == rank // fsdp:
                    group = g
    return Mesh(dp, fsdp, rank, world, group)


def param_sharding_spec(shape: Sequence[int] | torch.Tensor, fsdp: int) -> Optional[int]:
    """The axis a leaf's optimizer state shards over ``fsdp`` processes: the
    largest axis that ``fsdp`` divides (the JAX package's ZeRO rule), or
    None (kept whole) for a scalar, ``fsdp`` 1 or no such axis."""
    sizes = list(shape.shape if isinstance(shape, torch.Tensor) else shape)
    if fsdp <= 1 or not sizes:
        return None
    for ax in sorted(range(len(sizes)), key=lambda i: -sizes[i]):
        if sizes[ax] % fsdp == 0 and sizes[ax] >= fsdp:
            return ax
    return None


def pad_rows(batch: dict, multiple: int) -> dict:
    """The rows padded to a multiple of ``multiple`` (numpy arrays or
    tensors): pad rows hold zeros (zero lengths, which every loss masks)
    and IGNORE_ID in the ``*target`` keys."""
    b = next(iter(batch.values())).shape[0]
    pad = (-b) % multiple
    if pad == 0:
        return batch
    out = {}
    for k, v in batch.items():
        fill = IGNORE_ID if k.endswith("target") else 0
        if isinstance(v, torch.Tensor):
            block = torch.full((pad,) + tuple(v.shape[1:]), fill, dtype=v.dtype, device=v.device)
            out[k] = torch.cat([v, block])
        else:
            v = np.asarray(v)
            out[k] = np.concatenate([v, np.full((pad,) + v.shape[1:], fill, v.dtype)])
    return out


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This process's contiguous block of rows of a global batch (every
    process holds the same one), after padding the rows to a multiple of
    ``world``.  Draws made for the padded global batch split the same way
    (``shard_rows``)."""
    return shard_rows(pad_rows(batch, mesh.world), mesh)


def row_block(n: int, mesh: Mesh) -> tuple[int, int]:
    """[start, stop) of this process's rows of ``n``: ``np.array_split``'s
    contiguous blocks, the first ``n % world`` one row longer."""
    base, extra = divmod(n, mesh.world)
    start = mesh.rank * base + min(mesh.rank, extra)
    return start, start + base + (mesh.rank < extra)


def shard_rows(tree, mesh: Mesh):
    """This process's ``row_block`` of every leaf of ``tree`` (a dict, list
    or tuple of arrays that share their leading dimension)."""

    def take(x):
        start, stop = row_block(x.shape[0], mesh)
        return x[start:stop]

    return tree_map(take, tree)

