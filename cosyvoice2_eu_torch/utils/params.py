"""Functional layers over explicit parameter dicts, in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/utils/params.py``.  Parameters are nested
dicts (and lists) of tensors with torch layouts, the same trees the JAX
package builds:

* dense:          weight (out, in), bias (out,)
* conv1d:         weight (out, in/groups, k), bias (out,)
* conv_transpose: weight (in, out, k), bias (out,)
* embedding:      weight (num, dim)

so a JAX parameter tree crosses over with ``params_from_numpy`` as a plain
tree map, and ``F.conv1d`` / ``F.conv_transpose1d`` take the weights as they
are.  Random initialisers draw from an explicit ``torch.Generator`` on the
target device, with the same distributions as the JAX ``init_*`` helpers.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every leaf of a dict/list/tuple tree (and the matching
    leaves of the trees in ``rest``, which share its structure).  A dict
    that carries state of its own (``parallel/tp.py::Sliced``) comes back
    as its ``with_leaves``."""
    if isinstance(tree, dict):
        out = {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
        rebuild = getattr(tree, "with_leaves", None)
        return rebuild(out) if rebuild is not None else out
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a dict/list/tuple tree, in ``tree_map``'s order."""
    if not isinstance(tree, (dict, list, tuple)):
        return [tree]
    out = []
    _collect(tree, out)
    return out


def _collect(tree, out: list) -> None:
    # tree_leaves without tree_map's new containers, one call a container:
    # the optimizer walks trees of ~1,100 leaves every step
    for v in tree.values() if isinstance(tree, dict) else tree:
        if isinstance(v, (dict, list, tuple)):
            _collect(v, out)
        else:
            out.append(v)


def params_from_numpy(tree, device, dtype: torch.dtype | None = torch.float32):
    """Numpy (or array-like, or tensor) parameter tree -> tensors on ``device``.

    Floating leaves are cast to ``dtype`` (kept as they are when None);
    integer leaves keep their type.
    """

    def leaf(a):
        # numpy leaves are copied: JAX's host views are read-only
        t = a if torch.is_tensor(a) else torch.tensor(np.asarray(a))
        if t.is_floating_point() and dtype is not None:
            t = t.to(dtype)
        return t.to(device)

    return tree_map(leaf, tree)


def cast_floating(tree, dtype: torch.dtype):
    """Cast every floating leaf of a tensor tree to ``dtype``."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


# ---------------------------------------------------------------------------
# initializers (same distributions as the JAX package's init_*)
# ---------------------------------------------------------------------------

def _kaiming_uniform(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    bound = math.sqrt(1.0 / fan_in)
    return torch.empty(shape, device=gen.device).uniform_(-bound, bound, generator=gen)


def init_dense(gen, in_dim: int, out_dim: int, bias: bool = True) -> dict:
    p = {"weight": _kaiming_uniform(gen, (out_dim, in_dim), in_dim)}
    if bias:
        p["bias"] = _kaiming_uniform(gen, (out_dim,), in_dim)
    return p


def init_conv1d(gen, in_ch: int, out_ch: int, k: int, groups: int = 1, bias: bool = True) -> dict:
    fan_in = (in_ch // groups) * k
    p = {"weight": _kaiming_uniform(gen, (out_ch, in_ch // groups, k), fan_in)}
    if bias:
        p["bias"] = _kaiming_uniform(gen, (out_ch,), fan_in)
    return p


def init_conv_transpose1d(gen, in_ch: int, out_ch: int, k: int, bias: bool = True) -> dict:
    fan_in = out_ch * k  # torch uses in_channels of the *transposed* view
    p = {"weight": _kaiming_uniform(gen, (in_ch, out_ch, k), fan_in)}
    if bias:
        p["bias"] = _kaiming_uniform(gen, (out_ch,), fan_in)
    return p


def init_conv2d(gen, in_ch: int, out_ch: int, k: int, bias: bool = True) -> dict:
    fan_in = in_ch * k * k
    p = {"weight": _kaiming_uniform(gen, (out_ch, in_ch, k, k), fan_in)}
    if bias:
        p["bias"] = _kaiming_uniform(gen, (out_ch,), fan_in)
    return p


def init_batch_norm(gen, dim: int) -> dict:
    ones, zeros = torch.ones(dim, device=gen.device), torch.zeros(dim, device=gen.device)
    return {"weight": ones, "bias": zeros, "running_mean": zeros.clone(),
            "running_var": ones.clone()}


def init_layer_norm(gen, dim: int) -> dict:
    return {"weight": torch.ones(dim, device=gen.device),
            "bias": torch.zeros(dim, device=gen.device)}


def init_group_norm(gen, dim: int) -> dict:
    return init_layer_norm(gen, dim)  # the same affine: weight 1, bias 0


def init_rms_norm(gen, dim: int) -> dict:
    return {"weight": torch.ones(dim, device=gen.device)}


def init_embedding(gen, num: int, dim: int) -> dict:
    return {"weight": torch.randn((num, dim), device=gen.device, generator=gen)}


def init_uniform(gen, shape, low: float, high: float) -> torch.Tensor:
    return torch.empty(shape, device=gen.device).uniform_(low, high, generator=gen)


# ---------------------------------------------------------------------------
# functional layers
# ---------------------------------------------------------------------------

def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """y = x W^T + b in the dtype of x.

    An int8 layer (``quantize_dense``) computes y32 = x @ w_q^T in fp32
    through ``int8_matmul`` (kernel K2 on the card, at any K; its plain
    version on the CPU), then ``(y32 * scale).to(x.dtype) + bias``: the
    route the JAX package takes on the TPU.  On the CPU the JAX package
    takes XLA's route instead, ``(x @ w_q^T.astype(x.dtype)) *
    scale.astype(x.dtype)``.  In fp32 the two agree up to the order of the
    sums; in bf16 they round at different places.

    A ``weight_q_xla`` layer (the key of a tree the JAX package sharded for
    tensor parallelism) takes that XLA route, in plain PyTorch on any
    device; the port's own tensor-parallel slices keep ``weight_q`` and K2.
    """
    if "weight_q_xla" in p:
        w_q = p["weight_q_xla"]
        y = (x @ w_q.T.to(x.dtype)) * p["scale"].to(x.dtype)
        return y + p["bias"].to(x.dtype) if "bias" in p else y
    if "weight_q" in p:
        from cosyvoice2_eu_torch.ops.int8_matmul import int8_matmul

        w_q = p["weight_q"]
        y32 = int8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w_q)
        y = (y32 * p["scale"]).to(x.dtype).reshape(*x.shape[:-1], w_q.shape[0])
        return y + p["bias"].to(x.dtype) if "bias" in p else y
    return F.linear(x, p["weight"].to(x.dtype),
                    p["bias"].to(x.dtype) if "bias" in p else None)


def quantize_dense(p: dict) -> dict:
    """Per-output-channel symmetric int8 quantization of a dense layer.

    scale = max(max|w_row|, 1e-8) / 127 in fp32, w_q = clip(round(w /
    scale), -127, 127) with round half to even: the JAX package's numpy
    arithmetic, in torch on the weight's device (bit for bit the same
    codes and scales).  The bias is kept as it is.
    """
    w = p["weight"].float()
    peak = w.abs().amax(dim=1).clamp_min(1e-8)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which rounds differently from numpy's division
    scale = peak / torch.full_like(peak, 127.0)
    w_q = torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8)
    out = {"weight_q": w_q, "scale": scale}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def quantize_lm_params(llm: dict) -> dict:
    """Weight-only int8 on the decode-bound projections: every ``*_proj`` of
    the backbone's layers and the speech head ``llm_decoder``; embeddings
    and norms keep their type.  Used by ``load(lm_quant="int8")``."""
    layers = [{k: quantize_dense(v) if k.endswith("_proj") else v for k, v in lp.items()}
              for lp in llm["backbone"]["layers"]]
    return dict(llm, backbone=dict(llm["backbone"], layers=layers),
                llm_decoder=quantize_dense(llm["llm_decoder"]))


def embedding(p: dict, ids: torch.Tensor) -> torch.Tensor:
    return p["weight"][ids]


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # stats in fp32, affine in the input dtype (as the JAX layer)
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * p["weight"].to(x.dtype) + p["bias"].to(x.dtype)


def group_norm(p: dict, x: torch.Tensor, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """torch.nn.GroupNorm over (B, C, T), stats in the input dtype (as the JAX layer)."""
    b, c, t = x.shape
    xg = x.reshape(b, groups, c // groups, t)
    mean = xg.mean(dim=(2, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(2, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, c, t)
    return y * p["weight"].to(x.dtype)[None, :, None] + p["bias"].to(x.dtype)[None, :, None]


def batch_norm1d(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode torch.nn.BatchNorm1d over (B, C, T) from the running stats, in fp32."""
    mean = p["running_mean"].float()[None, :, None]
    var = p["running_var"].float()[None, :, None]
    y = (x.float() - mean) * torch.rsqrt(var + eps)
    y = y * p["weight"].float()[None, :, None] + p["bias"].float()[None, :, None]
    return y.to(x.dtype)


def rms_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * p["weight"].float()).to(x.dtype)


def conv1d(
    p: dict,
    x: torch.Tensor,
    stride: int = 1,
    padding: int | tuple[int, int] = 0,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """torch.nn.Conv1d semantics with optional asymmetric (left, right) padding."""
    if isinstance(padding, int):
        padding = (padding, padding)
    if padding != (0, 0):
        x = F.pad(x, padding)
    b = p["bias"].to(x.dtype) if "bias" in p else None
    return F.conv1d(x, p["weight"].to(x.dtype), b, stride=stride, dilation=dilation,
                    groups=groups)


def conv2d(p: dict, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """torch.nn.Conv2d semantics.  x: (B, C_in, H, W) -> (B, C_out, H', W')."""
    b = p["bias"].to(x.dtype) if "bias" in p else None
    return F.conv2d(x, p["weight"].to(x.dtype), b, stride=stride, padding=padding)


def causal_conv1d(p: dict, x: torch.Tensor, dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """Left-pad (k-1)*dilation zeros then valid conv."""
    k = p["weight"].shape[-1]
    return conv1d(p, x, padding=((k - 1) * dilation, 0), dilation=dilation, groups=groups)


def conv_transpose1d(p: dict, x: torch.Tensor, stride: int, padding: int = 0) -> torch.Tensor:
    """torch.nn.ConvTranspose1d semantics; weight (in, out, k)."""
    b = p["bias"].to(x.dtype) if "bias" in p else None
    return F.conv_transpose1d(x, p["weight"].to(x.dtype), b, stride=stride, padding=padding)


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + sin^2(ax)/a, channel-wise alpha; x: (B, C, T)."""
    a = alpha.to(x.dtype)[None, :, None]
    s = torch.sin(a * x)
    return x + s * s / (a + 1e-9)
