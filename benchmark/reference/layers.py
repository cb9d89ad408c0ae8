"""Functional layers of the benchmark's reference, in plain PyTorch.

Frozen copy of the layers in the port's ``cosyvoice2_eu_torch/utils/params.py``
(dense weight (out, in), conv1d weight (out, in/groups, k), conv_transpose
weight (in, out, k), embedding (num, dim)), without the int8 path.

``lowered(mode)`` computes every dense layer and convolution in a lower
precision, for the control of the output check: ``"fp8"`` rounds the
weight, the input and the output of each to float8 e4m3 (one scale per
tensor), and ``"tf32"`` lets cuBLAS and cuDNN use TF32.  ``"reordered"``
stays in fp32 with TF32 off but sums every dense layer in another order
(its input features in two halves, its rows in two blocks), as a sound
program other than the reference may: the rounding of fp32 alone, for the
lower reading of the output check.  Outside it the reference computes in
fp32 with TF32 off.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_MODE = {"mode": None}  # the precision lowered() sets; None: the input's own


@contextlib.contextmanager
def lowered(mode):
    """Run the block with dense layers and convolutions in ``mode`` (None,
    "fp8", "tf32" or "reordered")."""
    if mode not in (None, "fp8", "tf32", "reordered"):
        raise ValueError(f"unknown precision {mode!r}")
    old = (_MODE["mode"], torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    _MODE["mode"] = mode
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        _MODE["mode"], torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def exact():
    """fp32 with TF32 off: the reference's own precision."""
    return lowered(None)


def _round(x: torch.Tensor) -> torch.Tensor:
    if _MODE["mode"] == "fp8":
        scale = x.detach().abs().amax().clamp_min(1e-12) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x


def tree_map(fn, tree, *rest):
    """``fn`` over every leaf of a dict/list/tuple tree (and the matching
    leaves of ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _reordered_linear(x: torch.Tensor, w: torch.Tensor, b) -> torch.Tensor:
    rows = x.reshape(-1, x.shape[-1])
    h = x.shape[-1] // 2
    y = torch.cat([F.linear(r[:, :h], w[:, :h]) + F.linear(r[:, h:], w[:, h:])
                   for r in rows.split(max(1, (rows.shape[0] + 1) // 2))])
    y = y.reshape(*x.shape[:-1], w.shape[0])
    return y if b is None else y + b


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    linear = _reordered_linear if _MODE["mode"] == "reordered" else F.linear
    return _round(linear(_round(x), _round(p["weight"].to(x.dtype)),
                         p["bias"].to(x.dtype) if "bias" in p else None))


def embedding(p: dict, ids: torch.Tensor) -> torch.Tensor:
    return p["weight"][ids]


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * p["weight"].to(x.dtype) + p["bias"].to(x.dtype)


def rms_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * p["weight"].float()).to(x.dtype)


def conv1d(p: dict, x: torch.Tensor, stride: int = 1, padding=0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """torch.nn.Conv1d with optional asymmetric (left, right) padding."""
    if isinstance(padding, int):
        padding = (padding, padding)
    if padding != (0, 0):
        x = F.pad(x, padding)
    b = p["bias"].to(x.dtype) if "bias" in p else None
    return _round(F.conv1d(_round(x), _round(p["weight"].to(x.dtype)), b, stride=stride,
                           dilation=dilation, groups=groups))


def causal_conv1d(p: dict, x: torch.Tensor, dilation: int = 1, groups: int = 1) -> torch.Tensor:
    k = p["weight"].shape[-1]
    return conv1d(p, x, padding=((k - 1) * dilation, 0), dilation=dilation, groups=groups)


def conv_transpose1d(p: dict, x: torch.Tensor, stride: int, padding: int = 0) -> torch.Tensor:
    b = p["bias"].to(x.dtype) if "bias" in p else None
    return _round(F.conv_transpose1d(_round(x), _round(p["weight"].to(x.dtype)), b,
                                     stride=stride, padding=padding))


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    a = alpha.to(x.dtype)[None, :, None]
    s = torch.sin(a * x)
    return x + s * s / (a + 1e-9)
