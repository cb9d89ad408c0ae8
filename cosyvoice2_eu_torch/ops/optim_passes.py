"""The optimizer's two fused passes over flat state buffers.

``train/optim.py`` keeps the optimizer state (Adam's moments, MultiSteps'
running mean, and without fsdp the parameters; at fsdp > 1 a process's
slices of them) in one flat buffer per tree, each leaf a view at its
``FlatLayout`` offset, and updates it with two passes:

- pass A (``accumulate``), once per micro-step: the running mean
  ``a + (g - a) / (n + 1)`` into a new buffer, with the gradient read where
  autograd left each leaf, and fixed-order sums of ``g^2`` (the
  ``grad_norm`` metric); on the emitting micro-step also of the new mean
  squared (the clip's norm) and a count of its non-finite elements.  With
  ``accum_grad`` 1 it only sums the gradient (``a`` is None);
- pass B (``update``), once per finite emission: optax's clip, Adam's
  moments and bias corrections, AdamW's decay and ``-lr`` into new buffers
  of ``mu``, ``nu`` and the parameters, and the reset ``a * 0``.

On a CUDA tensor each pass launches its kernel in ``csrc/optim_passes.cu``;
on a CPU tensor it runs the plain PyTorch version (``accumulate_reference``,
``adam_update``), and on no other device.  There is no fallback from the
card to the plain version.  No TPU kernel is replaced: the JAX package
leaves the optax chain to XLA, which fuses it; the port's per-leaf
multi-tensor chain paid host time for every leaf and stage.
``accumulate.launches`` and ``update.launches`` count kernel launches,
``adopt.calls`` the states copied into flat buffers.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from cosyvoice2_eu_torch.utils.params import tree_leaves

SOURCE = "optim_passes.cu"
ALIGN_BYTES = 256  # every leaf starts on this boundary: cuBLAS, cp.async and TMA bases
TILE = 8192        # elements a kernel block takes at a time, within one leaf
GRID = 1056        # blocks of either pass (8 per SM of an H100): fixed, so is the sums' order
ACC, EMIT, NORM = 0, 1, 2  # pass A's modes (the kernel's)


class FlatLayout:
    """Where each leaf of a tree of one floating dtype lies in its flat
    buffer: leaf ``i`` at ``offsets[i]``, contiguous, its start on an
    ``ALIGN_BYTES`` boundary; the padding after each leaf holds zeros.
    Leaves of one shape lie next to each other at one stride (a group), in
    the order of their first appearance, so one ``unbind`` cuts a group's
    views: a tree of views costs about a microsecond a leaf on the host.

    ``build`` makes a tree of views of a buffer and remembers it under a
    name; ``flat`` gives back the buffer of a tree that is the one built
    last under that name (its identity and its first leaf, not a walk of
    its leaves: a leaf replaced in place in such a tree is not seen), or of
    any tree whose leaves are views at this layout's offsets."""

    def __init__(self, leaves: list):
        if len({x.dtype for x in leaves}) != 1 or not leaves[0].is_floating_point():
            raise ValueError("the optimizer takes a tree of one floating dtype, got "
                             f"{sorted({str(x.dtype) for x in leaves})}")
        self.dtype, self.device = leaves[0].dtype, leaves[0].device
        self.shapes = [x.shape for x in leaves]
        self.numels = [x.numel() for x in leaves]
        item = leaves[0].element_size()
        align = ALIGN_BYTES // item
        by_shape: dict = {}
        for i, s in enumerate(self.shapes):
            by_shape.setdefault(tuple(s), []).append(i)
        self.offsets, self.groups, self._where, off = [0] * len(leaves), [], {}, 0
        for shape, members in by_shape.items():
            step = -(-self.numels[members[0]] // align) * align
            stride = torch.empty(shape, device="meta").stride()
            self.groups.append(((len(members), *shape), (step, *stride), off))
            for j, i in enumerate(members):
                self.offsets[i] = off + j * step
                self._where[i] = (len(self.groups) - 1, j)
            off += step * len(members)
        self.total = off
        self.byte_offsets = [o * item for o in self.offsets]
        self._tables = None
        self._builders: dict = {}  # tree structure -> builder
        self._last: dict = {}      # name -> (id, first leaf (weak), builder) of the last build

    def matches(self, leaves: list) -> bool:
        """Whether ``leaves`` (a gradient's) have this layout's sizes, dtype
        and device (sizes, not shapes: the passes see each leaf as its
        elements in order, and the sizes are compared five times faster)."""
        x = leaves[0]
        return x.dtype == self.dtype and x.device == self.device and \
            [g.numel() for g in leaves] == self.numels

    def views(self, buf: torch.Tensor) -> list:
        """Each leaf's view of the flat buffer ``buf``, in the tree's order."""
        out = [None] * len(self.numels)
        for g, (size, stride, off) in enumerate(self.groups):
            for j, v in enumerate(buf.as_strided(size, stride, off).unbind(0)):
                out[self._inverse[g][j]] = v
        return out

    @functools.cached_property
    def _inverse(self) -> list:
        out = [[0] * size[0] for size, _, _ in self.groups]
        for i, (g, j) in self._where.items():
            out[g][j] = i
        return out

    def flatten(self, leaves: list) -> torch.Tensor:
        """A new flat buffer holding ``leaves`` (an adoption's copy)."""
        buf = torch.zeros(self.total, dtype=self.dtype, device=self.device)
        torch._foreach_copy_(self.views(buf), leaves)
        return buf

    def flat_of(self, leaves: list) -> Optional[torch.Tensor]:
        """The flat buffer whose views ``leaves`` are, at this layout's
        offsets; None where they are not (a state to adopt)."""
        x = leaves[0]
        if x.dtype != self.dtype or x.device != self.device or x.storage_offset() != 0 \
                or x.untyped_storage().nbytes() < self.total * x.element_size():
            return None
        base = x.data_ptr()
        # views at these offsets inside leaf 0's storage are its views: live
        # allocations do not overlap
        if [y.data_ptr() - base if y.is_contiguous() else -1 for y in leaves] \
                != self.byte_offsets:
            return None
        return x.as_strided((self.total,), (1,), 0)

    def flat(self, name: str, tree) -> Optional[tuple]:
        """(the flat buffer, the builder) of ``tree``, or None where its
        leaves are not views of one flat buffer at this layout's offsets."""
        last = self._last.get(name)
        if last is not None and last[0] == id(tree):
            first = last[1]()
            if first is not None and _first_leaf(tree) is first:
                return first._base, last[2]
        buf = self.flat_of(tree_leaves(tree))
        return None if buf is None else (buf, self.builder(tree))

    def build(self, name: str, builder, buf: torch.Tensor):
        """``builder``'s tree of views of ``buf``, remembered under ``name``."""
        tree = builder(buf)
        self._last[name] = (id(tree), weakref.ref(_first_leaf(tree)), builder)
        return tree

    def builder(self, tree):
        """fn(buf) -> ``tree``'s structure with the views of ``buf`` as its
        leaves: a function generated once a structure, which returns the
        whole tree as one expression after one ``unbind`` a group.  The tree
        is of plain dicts (str or int keys), lists and tuples."""
        sig = _structure(tree)
        if sig is None:
            raise ValueError("the optimizer takes trees of plain dicts (str or int keys), "
                             "lists and tuples")
        if sig not in self._builders:
            leaves = iter(range(len(self.numels)))

            def expr(node) -> str:
                if node == _LEAF:
                    g, j = self._where[next(leaves)]
                    return f"g{g}[{j}]"
                kind, *rest = node
                if kind == "d":
                    return "{" + ", ".join(f"{k!r}: {expr(v)}" for k, v in zip(*rest)) + "}"
                items = "".join(expr(v) + ", " for v in rest[0])
                return f"[{items}]" if kind == "l" else f"({items})"

            body = expr(sig)
            if next(leaves, None) is not None:
                raise ValueError("the tree has fewer leaves than the layout")
            src = ["def build(b, S=S):"]
            src += [f"    g{g} = S(b, {size}, {stride}, {off}).unbind(0)"
                    for g, (size, stride, off) in enumerate(self.groups)]
            src.append(f"    return {body}")
            scope = {"S": torch.Tensor.as_strided}
            exec("\n".join(src), scope)
            self._builders[sig] = scope["build"]
        return self._builders[sig]

    def tables(self) -> dict:
        """The kernels' tables on the card, made once: each tile's (leaf,
        tile within the leaf), each leaf's offset and length, each block's
        partial sums and the count of blocks done (the last block resets it)."""
        if self._tables is None:
            align = ALIGN_BYTES // torch.empty((), dtype=self.dtype).element_size()
            padded = -(-np.array(self.numels, dtype=np.int64) // align) * align
            per = -(-padded // TILE)
            tiles = np.stack([np.repeat(np.arange(len(per), dtype=np.int32), per),
                              np.concatenate([np.arange(k, dtype=np.int32) for k in per])
                              if len(per) else np.zeros(0, np.int32)], axis=1)
            dev = self.device
            self._tables = {
                "tiles": torch.as_tensor(np.ascontiguousarray(tiles)).to(dev),
                "offsets": torch.tensor(self.offsets, dtype=torch.int64, device=dev),
                "numels": torch.tensor(self.numels, dtype=torch.int64, device=dev),
                "partials": torch.zeros(3 * GRID, dtype=torch.float64, device=dev),
                "counter": torch.zeros(1, dtype=torch.int32, device=dev),
            }
        return self._tables


_LEAF = 0


def _structure(tree):
    """A hashable description of a tree of plain dicts, lists and tuples
    (``_LEAF`` for a leaf); None where a container is of another type or a
    key is neither str nor int."""
    kind = type(tree)
    if kind is dict:
        keys, kids = tuple(tree), tuple(_structure(v) for v in tree.values())
        ok = None not in kids and all(type(k) in (str, int) for k in keys)
        return ("d", keys, kids) if ok else None
    if kind is list or kind is tuple:
        kids = tuple(_structure(v) for v in tree)
        return None if None in kids else ("l" if kind is list else "t", kids)
    return None if isinstance(tree, (dict, list, tuple)) else _LEAF


def _first_leaf(tree):
    """The first of ``tree_leaves(tree)``, or None without one."""
    if not isinstance(tree, (dict, list, tuple)):
        return tree
    for v in tree.values() if isinstance(tree, dict) else tree:
        leaf = _first_leaf(v)
        if leaf is not None:
            return leaf
    return None


class Hyper(NamedTuple):
    """One update's numbers: the clip's norm (an fp32 value) and limit,
    Adam's decays and fp32 bias corrections, eps, AdamW's decay (None for
    Adam) and the learning rate (an fp32 value)."""
    norm: float
    max_norm: float
    b1: float
    b2: float
    bc1: float
    bc2: float
    eps: float
    weight_decay: Optional[float]
    lr: float


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def running_mean(g: torch.Tensor, a: torch.Tensor, n: int) -> torch.Tensor:
    """MultiSteps' mean after ``n`` micro-steps: a + (g - a) / (n + 1)."""
    return (g - a) / (n + 1) + a


def adam_update(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, p: torch.Tensor,
                h: Hyper) -> tuple:
    """(mu, nu, p) after clip_by_global_norm, adam|adamw and apply_updates,
    optax's arithmetic step for step, each operation rounded to the dtype."""
    if not h.norm < h.max_norm:
        g = g / h.norm * h.max_norm
    mu = g * (1 - h.b1) + mu * h.b1
    nu = g * g * (1 - h.b2) + nu * h.b2
    u = mu / h.bc1 / (torch.sqrt(nu / h.bc2) + h.eps)
    if h.weight_decay is not None:
        u = u + p * h.weight_decay
    return mu, nu, p + u * -h.lr


def _sums(g: torch.Tensor, checked: torch.Tensor, mean: Optional[torch.Tensor]) -> torch.Tensor:
    """[|g|, the clip's norm (|mean|, or |g| without one), non-finite
    elements of ``checked``] as float32, the squares summed in float64."""
    gn = g.double().square().sum().sqrt()
    clip = gn if mean is None else mean.double().square().sum().sqrt()
    return torch.stack([gn, clip, (~torch.isfinite(checked)).sum().double()]).float()


def accumulate_reference(g: torch.Tensor, a: Optional[torch.Tensor], n: int,
                         emit: bool) -> tuple:
    """Pass A on flat buffers: (the new mean, or None without ``a``; the
    sums).  Only an emitting pass (or one without ``a``) counts non-finite
    elements; an accumulating one gives 0 for the clip's norm and the count."""
    if a is None:
        return None, _sums(g, g, None)
    mean = running_mean(g, a, n)
    if emit:
        return mean, _sums(g, mean, mean)
    gn = g.double().square().sum().sqrt().float()
    return mean, torch.stack([gn, gn.new_zeros(()), gn.new_zeros(())])


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

@functools.cache
def _kernels():
    from cosyvoice2_eu_torch.ops.cuda_build import load_library

    lib = load_library(SOURCE)
    acc = lib.cosy_optim_accumulate
    acc.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p]
    upd = lib.cosy_optim_update
    upd.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p] + [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int] \
        + [ctypes.c_float] * 11 + [ctypes.c_void_p]
    acc.restype = upd.restype = ctypes.c_int
    return acc, upd


def _check(layout: FlatLayout) -> None:
    if layout.device.type != "cuda":
        raise ValueError(f"the optimizer's passes run on a CUDA or CPU tensor, not on "
                         f"{layout.device}")
    if layout.dtype != torch.float32:
        raise ValueError(f"the optimizer's passes take float32 leaves on the card, "
                         f"not {layout.dtype}")


def grad_table(layout: FlatLayout, grads: list) -> tuple:
    """The gradient leaves' addresses on the card (int64, one copy from
    pinned memory), and the contiguous copies in the layout's dtype made of
    leaves that were not (the caller keeps them alive until the launch)."""
    dtype, copies = layout.dtype, []

    def copied(g):
        copies.append(g.contiguous().to(dtype))
        return copies[-1].data_ptr()

    host = torch.tensor([g.data_ptr() if g.is_contiguous() and g.dtype is dtype else copied(g)
                         for g in grads], dtype=torch.int64, pin_memory=True)
    return host.to(layout.device, non_blocking=True), copies


def launch_accumulate(layout: FlatLayout, table: torch.Tensor, a: Optional[torch.Tensor],
                      n: int, mode: int) -> tuple:
    """Pass A's kernel, the gradient read through ``table``: (the new mean
    or None, the sums).  No allocation but the outputs', no sync."""
    t = layout.tables()
    out = torch.empty(3, dtype=torch.float32, device=layout.device)
    mean = None if a is None else torch.empty_like(a)
    err = _kernels()[0](t["tiles"].data_ptr(), t["tiles"].shape[0], t["offsets"].data_ptr(),
                        t["numels"].data_ptr(), table.data_ptr(),
                        None if a is None else a.data_ptr(),
                        None if mean is None else mean.data_ptr(), float(n + 1), mode,
                        t["partials"].data_ptr(), t["counter"].data_ptr(), out.data_ptr(),
                        torch.cuda.current_stream(layout.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"optimizer pass A ({SOURCE}) failed: CUDA error {err}")
    accumulate.launches += 1
    return mean, out


def launch_update(layout: FlatLayout, table: Optional[torch.Tensor], a: Optional[torch.Tensor],
                  mu: torch.Tensor, nu: torch.Tensor, p: torch.Tensor, h: Hyper,
                  reset: bool) -> tuple:
    """Pass B's kernel, the gradient read through ``table`` or from the flat
    mean ``a``: (mu, nu, p, a * 0 or None), all new buffers."""
    t = layout.tables()
    mu2, nu2, p2 = torch.empty_like(mu), torch.empty_like(nu), torch.empty_like(p)
    a0 = torch.empty_like(a) if reset else None
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    decay = h.weight_decay is not None
    err = _kernels()[1](t["tiles"].data_ptr(), t["tiles"].shape[0], t["offsets"].data_ptr(),
                        t["numels"].data_ptr(), ptr(table), ptr(a), mu.data_ptr(),
                        nu.data_ptr(), p.data_ptr(), mu2.data_ptr(), nu2.data_ptr(),
                        p2.data_ptr(), ptr(a0), int(not h.norm < h.max_norm), int(decay),
                        h.norm, h.max_norm, h.b1, 1 - h.b1, h.b2, 1 - h.b2, h.bc1, h.bc2,
                        h.eps, h.weight_decay if decay else 0.0, -h.lr,
                        torch.cuda.current_stream(layout.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"optimizer pass B ({SOURCE}) failed: CUDA error {err}")
    update.launches += 1
    return mu2, nu2, p2, a0


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def accumulate(layout: FlatLayout, grads: list, a: Optional[torch.Tensor], n: int,
               emit: bool) -> tuple:
    """Pass A over the gradient leaves ``grads`` and the flat mean ``a``
    (None: the gradient's sums alone): (the new flat mean or None, float32
    [|g|, the clip's norm, non-finite elements]); see
    ``accumulate_reference``."""
    if layout.device.type == "cpu":
        return accumulate_reference(layout.flatten(grads), a, n, emit)
    _check(layout)
    table, keep = grad_table(layout, grads)
    mode = NORM if a is None else EMIT if emit else ACC
    out = launch_accumulate(layout, table, a, n, mode)
    del keep
    return out


def update(layout: FlatLayout, g, mu: torch.Tensor, nu: torch.Tensor, p: torch.Tensor,
           h: Hyper, reset: bool) -> tuple:
    """Pass B: (mu, nu, p, and with ``reset`` the flat mean times 0), new
    flat buffers, from the flat mean ``g`` or the gradient leaves ``g`` (a
    list; ``accum_grad`` 1)."""
    if layout.device.type == "cpu":
        flat = layout.flatten(g) if isinstance(g, list) else g
        return (*adam_update(flat, mu, nu, p, h), flat * 0.0 if reset else None)
    _check(layout)
    if isinstance(g, list):
        table, keep = grad_table(layout, g)
        out = launch_update(layout, table, None, mu, nu, p, h, False)
        del keep
        return out
    return launch_update(layout, None, g, mu, nu, p, h, reset)


accumulate.launches = 0
update.launches = 0


def adopt(layout: FlatLayout, trees: dict) -> dict:
    """Each of ``trees`` (name -> its leaves) copied into a new flat buffer
    of ``layout``: a state met for the first time (the first step, a
    restored checkpoint, a tree from elsewhere).  ``adopt.calls`` counts
    adoptions."""
    adopt.calls += 1
    return {name: layout.flatten(leaves) for name, leaves in trees.items()}


adopt.calls = 0
