"""Tensor-parallel speech-LM decode: each process holds a slice of the LM.

Counterpart of ``cosyvoice2_eu_tpu/parallel/tp.py``.  The decode is
bandwidth-bound (every token reads every weight), so splitting the weights
over ``tp`` GPUs splits the bytes each one streams.  The JAX package places
Megatron-style shardings on one controller's arrays and lets GSPMD insert
the reductions.  The port runs one process per GPU (``torchrun``), each
holding its own slices as plain local tensors, and reduces explicitly:

  q/k/v_proj, gate/up_proj, llm_decoder   column-parallel: out dim split, with biases
  o_proj, down_proj                        row-parallel: in dim split; SUM all-reduce
                                           after, then the (whole) bias once
  embeddings, norms                        replicated

as ``lm_tp_specs``' rule, with one constraint of the port's own: q/k/v (and
so o_proj) split only when ``num_heads`` and ``num_kv_heads`` both divide by
``tp``, so that a process's query heads and their kv heads are whole and
local (GSPMD may split mid-head and stay exact; a process's local attention
cannot).  Otherwise attention stays replicated and only the MLP and the
head split.  Qwen2-0.5B (14 heads, 2 kv heads) splits attention at tp 2
only: process r holds query heads 7r..7r+6 and kv head r, the ``h // 7``
grouping; Qwen3-0.6B (16, 8) at tp 2, 4 and 8.  A tensor whose split axis
``tp`` does not divide stays whole.

int8 layers keep ``weight_q``: a process's slice is an ordinary int8
tensor, so kernel K2 runs at the slice's shape (JAX re-keys to
``weight_q_xla`` because a ``pallas_call`` has no GSPMD rule).  The column
slices of the speech head (6564 -> 3282 a process at tp 2) are gathered to
whole logits on every process before sampling, so every process samples
the same token from the same draws; the KV cache holds the local kv heads.

A module with a sliced tensor comes back as a ``Sliced`` dict that carries
the group holding the other slices, which the model code reduces over;
``tree_map`` (and so ``cast_floating`` and the moves between devices)
keeps it.  A row-parallel module or a head whose width is a slice's but
that lost the mark raises instead of computing a partial sum.
Collectives are ``all_reduce`` only (a gather is an all-reduce of a
zero-filled buffer into which each process writes its slice), in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from cosyvoice2_eu_torch.parallel.distributed import rank_and_world

# column-parallel module names: the OUT dim (weight axis 0, bias, scale)
_COL = frozenset({"q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "llm_decoder"})
# row-parallel module names: the IN dim (weight axis 1); bias whole
_ROW = frozenset({"o_proj", "down_proj"})
_ATTN = frozenset({"q_proj", "k_proj", "v_proj", "o_proj"})
_WEIGHTS = ("weight", "weight_q", "weight_q_xla")

@dataclasses.dataclass
class TPMesh:
    """This process's place in its tensor-parallel group of ``tp``
    consecutive processes: ``rank`` within the group, ``group`` the
    process group (the world's when ``tp`` is the world size)."""

    tp: int
    rank: int
    group: Optional[object]


class Sliced(dict):
    """A dense module's leaves on this process, some of them slices, and the
    ``mesh`` whose processes hold the other slices."""

    def __init__(self, leaves: dict, mesh: TPMesh):
        super().__init__(leaves)
        self.mesh = mesh

    def with_leaves(self, leaves: dict) -> "Sliced":
        """New leaves on the same slices (``utils/params.py::tree_map``)."""
        return Sliced(leaves, self.mesh)


def make_tp_mesh(tp: int = -1) -> TPMesh:
    """Groups of ``tp`` consecutive processes (``-1``: the whole world), each
    a replica that shards one LM.  Raises ``ValueError`` when ``tp`` exceeds
    the world size or does not divide it.  Every process must call it."""
    rank, world = rank_and_world()
    if tp == -1:
        tp = world
    if tp < 1 or tp > world:
        raise ValueError(f"tp={tp} exceeds the process group's world size {world}")
    if world % tp:
        raise ValueError(f"tp={tp} does not divide the world size {world}")
    group = None
    if tp > 1:
        if tp == world:
            group = dist.group.WORLD
        else:
            for first in range(0, world, tp):  # every process makes every group
                g = dist.new_group(list(range(first, first + tp)))
                if first == rank - rank % tp:
                    group = g
    return TPMesh(tp, rank % tp, group)


def heads_split(tp: int, num_heads: int, num_kv_heads: int) -> bool:
    """Whether attention splits over ``tp``: every process's query heads and
    their kv heads whole."""
    return num_heads % tp == 0 and num_kv_heads % tp == 0


def _module_specs(module: dict, kind: str, tp: int) -> dict:
    """Specs for one dense module's leaves: ("tp", None) splits axis 0,
    (None, "tp") axis 1, ("tp",) a vector, () keeps it whole."""
    out = {}
    for name, leaf in module.items():
        spec = ()
        if kind == "col":
            if leaf.ndim >= 1 and leaf.shape[0] % tp == 0:
                spec = ("tp",) + (None,) * (leaf.ndim - 1)
        elif kind == "row" and name in _WEIGHTS:
            if leaf.ndim == 2 and leaf.shape[1] % tp == 0:
                spec = (None, "tp")
        out[name] = spec
    return out


def lm_tp_specs(params: dict, tp: int, num_heads: Optional[int] = None,
                num_kv_heads: Optional[int] = None) -> dict:
    """The spec tree of an LM parameter tree (``init_lm``, or its int8
    form): the JAX package's rule, and, given the head counts, attention
    kept whole unless ``heads_split``."""
    attn = num_heads is None or heads_split(tp, num_heads, num_kv_heads)

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for key, val in node.items():
                if key in _ATTN and not attn and isinstance(val, dict):
                    out[key] = {k: () for k in val}
                elif key in _COL and isinstance(val, dict):
                    out[key] = _module_specs(val, "col", tp)
                elif key in _ROW and isinstance(val, dict):
                    out[key] = _module_specs(val, "row", tp)
                else:
                    out[key] = walk(val)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return ()

    return walk(params)


def shard_lm_tp(params: dict, mesh: TPMesh, cfg) -> dict:
    """This process's slices of an LM parameter tree (``cfg``: the LM's
    ``LMConfig``), per ``lm_tp_specs`` with the head constraint; a module
    with a slice comes back ``Sliced``, and int8 layers keep ``weight_q``."""
    bb = cfg.backbone
    specs = lm_tp_specs(params, mesh.tp, bb.num_heads, bb.num_kv_heads)
    if mesh.tp > 1 and not any("tp" in s for s in _spec_leaves(specs)):
        raise ValueError(f"tp={mesh.tp} divides no tensor of the LM")

    def place(node, spec):
        if isinstance(node, dict):
            out = {k: place(v, spec[k]) for k, v in node.items()}
            sliced = any(isinstance(s, tuple) and "tp" in s for s in spec.values())
            return Sliced(out, mesh) if sliced else out
        if isinstance(node, (list, tuple)):
            return type(node)(place(v, s) for v, s in zip(node, spec))
        if "tp" not in spec:
            return node
        ax = spec.index("tp")
        return node.chunk(mesh.tp, ax)[mesh.rank].contiguous()

    return place(params, specs)


def _spec_leaves(specs) -> list:
    if isinstance(specs, dict):
        return [x for v in specs.values() for x in _spec_leaves(v)]
    if isinstance(specs, list):
        return [x for v in specs for x in _spec_leaves(v)]
    return [specs]


def all_reduce_sum(y: torch.Tensor, mesh: TPMesh) -> torch.Tensor:
    """The SUM of ``y`` over ``mesh``'s group, reduced in fp32."""
    buf = y.float()
    if buf is y:
        buf = y.clone()
    dist.all_reduce(buf, group=mesh.group)
    return buf.to(y.dtype)


def gather_columns(y: torch.Tensor, full: int, mesh: TPMesh) -> torch.Tensor:
    """The whole last dimension (``full`` wide) from each process's
    contiguous slice of it."""
    n = y.shape[-1]
    buf = torch.zeros(*y.shape[:-1], full, dtype=torch.float32, device=y.device)
    buf[..., mesh.rank * n:(mesh.rank + 1) * n] = y.float()
    dist.all_reduce(buf, group=mesh.group)
    return buf.to(y.dtype)


def in_dim(p: dict) -> int:
    return next(p[k] for k in _WEIGHTS if k in p).shape[1]


def out_dim(p: dict) -> int:
    return next(p[k] for k in _WEIGHTS if k in p).shape[0]
