"""Flash attention with on-the-fly padding/chunk masks: forward (kernel K1)
and backward (kernels K3 and K4).

Counterpart of ``cosyvoice2_eu_tpu/ops/pallas/flash_attention.py::
flash_attention`` and its custom VJP.  On a CUDA tensor each wrapper
launches its hand-written Hopper kernel, all on the tensor cores (K1:
``csrc/flash_attention_sm90.cu`` for bfloat16, by wgmma, and
``csrc/flash_attention.cu`` for float32, in 3xTF32 on mma.sync;
``csrc/flash_attention_bwd.cu`` for K3 and K4, in 3xTF32 on mma.sync; the
3xTF32 tile product is ``csrc/tf32_mma.cuh``); on a CPU tensor it runs its
plain PyTorch version, and on no other device.  There is no fallback from
the card to the plain versions, nor between K1's two designs.

Mask semantics == ``ops.masks.chunk_attention_mask``: key j is visible to
query i iff j < length[b] and, when chunk_size > 0,
j < (i // chunk_size + 1) * chunk_size.  Masked scores are the finite -1e30
of the TPU kernel, so fully masked rows stay finite in the forward; the
backward gives such rows (length[b] == 0 only) zero gradients, as the TPU
kernels do.

``flash_attention`` routes through ``FlashAttentionFunction`` (K1 with LSE,
then K3 and K4 in the backward) when grad mode is on and q, k or v requires
grad; otherwise it launches K1 without LSE.  Under ``torch.export`` it calls
K1 through the operator ``cosyvoice2_eu::flash_attention_fwd`` (registered
when this module is imported; ``runtime/export.py``), which ``torch.export``
can trace and save: ``_launch_fwd`` passes raw pointers through ctypes.
Eager calls launch directly, without the dispatcher.
"""

from __future__ import annotations

import ctypes
import math

import torch

from cosyvoice2_eu_torch.ops.masks import chunk_attention_mask

NEG_INF = -1.0e30
SOURCE = "flash_attention.cu"            # K1, float32 (3xTF32 on mma.sync)
SM90_SOURCE = "flash_attention_sm90.cu"  # K1, bfloat16 (wgmma and TMA)
BWD_SOURCE = "flash_attention_bwd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIM = 64  # the kernels are built for the estimator's head dim


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def flash_attention_reference(q, k, v, lengths, chunk_size: int = 0,
                              sm_scale: float | None = None, return_lse: bool = False):
    """Plain PyTorch version of K1: fp32 scores and softmax, output in q's dtype.

    q/k/v: (B, H, T, D); lengths: (B,).  Returns o, or (o, lse (B, H, T) fp32).
    """
    b, h, t, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    s = (q.float() * sm_scale) @ k.float().transpose(-1, -2)
    mask = chunk_attention_mask(lengths.to(q.device), t, chunk_size)[:, None]
    s = s.masked_fill(~mask, NEG_INF)
    o = (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1)
    return o


def flash_attention_bwd_plain(q, k, v, do, lse, delta, lengths, chunk_size: int = 0,
                              sm_scale: float | None = None, grads: str = "qkv"):
    """Plain versions of K3 (``grads="q"``), K4 (``"kv"``) or both (``"qkv"``).

    fp32 math from the saved LSE and delta = rowsum(dO * O); returns the fp32
    (dq, dk, dv), with None for a gradient not asked for.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    t = q.shape[2]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = (qf * sm_scale) @ kf.transpose(-1, -2)
    mask = chunk_attention_mask(lengths.to(q.device), t, chunk_size)[:, None]
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)   # P under K1's mask
    dp = dof @ vf.transpose(-1, -2)                               # dP = dO V^T
    ds = p * (dp - delta[..., None])                              # dS = P (dP - delta)
    dq = (ds @ kf) * sm_scale if "q" in grads else None
    dk = ds.transpose(-1, -2) @ (qf * sm_scale) if "k" in grads else None
    dv = p.transpose(-1, -2) @ dof if "v" in grads else None
    return dq, dk, dv


def flash_attention_bwd_reference(q, k, v, o, lse, do, lengths, chunk_size: int = 0,
                                  sm_scale: float | None = None):
    """Plain PyTorch version of K3 + K4, fp32 math, gradients in the inputs' dtype.

    q/k/v/o/do: (B, H, T, D); lse: (B, H, T) fp32 natural-log from the
    forward; lengths: (B,).  delta = rowsum(dO * O), P = exp(S - LSE) under
    K1's mask, dP = dO V^T, dS = P (dP - delta); dQ = scale dS K,
    dK = dS^T (Q scale), dV = P^T dO.  Returns (dq, dk, dv).
    """
    delta = (do.float() * o.float()).sum(-1)
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, do, lse, delta, lengths, chunk_size, sm_scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, q, others, lengths, chunk_size):
    """Raise on what the kernels do not take: shapes, types, layout, device."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    b, h, t, d = q.shape
    for other, x in others.items():
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name}: {other} {tuple(x.shape)} {x.dtype} {x.device} "
                             f"does not match q {tuple(q.shape)} {q.dtype} {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} is not float32 or bfloat16")
    if d != _HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} is not {_HEAD_DIM}")
    if not (q.is_contiguous() and all(x.is_contiguous() for x in others.values())):
        raise ValueError(f"{name}: q, k, v (and dO) must be contiguous")
    if lengths.shape != (b,) or lengths.device != q.device:
        raise ValueError(f"{name}: lengths must be ({b},) on {q.device}")
    if chunk_size < 0:
        raise ValueError(f"{name}: chunk_size must be >= 0")


def _check_aligned(name, *xs):
    if any(x.data_ptr() % 16 for x in xs):
        raise ValueError(f"{name}: q, k, v (and dO) must start on 16-byte boundaries "
                         "(the kernels load them by TMA or 16-byte asynchronous copies)")


def _check_rows(name, q, **rows):
    b, h, t, _ = q.shape
    for row, x in rows.items():
        if x.shape != (b, h, t) or x.dtype != torch.float32 or not x.is_contiguous() \
                or x.device != q.device:
            raise ValueError(f"{name}: {row} must be contiguous float32 ({b}, {h}, {t}) "
                             f"on {q.device}")


def _fn(source: str, symbol: str, n_ptrs: int):
    from cosyvoice2_eu_torch.ops.cuda_build import load_library

    fn = getattr(load_library(source), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def fwd_kernel(dtype) -> tuple[str, str]:
    """(source, C entry point) of K1's design for ``dtype``."""
    if dtype == torch.bfloat16:
        return SM90_SOURCE, "cosy_flash_attention_sm90_fwd"
    return SOURCE, "cosy_flash_attention_fwd"


def _launch_fwd(q, k, v, lengths, chunk_size, sm_scale, return_lse):
    """K1 (or its plain version on a CPU tensor)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, lengths, chunk_size, sm_scale, return_lse)
    _check("flash_attention", q, {"k": k, "v": v}, lengths, chunk_size)
    _check_aligned("flash_attention", q, k, v)
    b, h, t, d = q.shape
    lengths = lengths.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), device=q.device, dtype=torch.float32) if return_lse else None
    err = _fn(*fwd_kernel(q.dtype), 6)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), o.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        b * h, h, t, d, chunk_size, sm_scale, _DTYPES[q.dtype], _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel failed: CUDA error {err}")
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


@torch.library.custom_op("cosyvoice2_eu::flash_attention_fwd", mutates_args=())
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: torch.Tensor, chunk_size: int, sm_scale: float,
                        return_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 as a PyTorch operator, the one ``torch.export`` traces: (o, lse),
    lse empty without ``return_lse``.  On a CUDA tensor it launches K1 (and
    counts in ``flash_attention.launches``), on a CPU tensor it runs the
    plain version."""
    out = _launch_fwd(q, k, v, lengths, chunk_size, sm_scale, return_lse)
    return out if return_lse else (out, q.new_empty((0,), dtype=torch.float32))


@flash_attention_fwd.register_fake
def _flash_attention_fwd_shapes(q, k, v, lengths, chunk_size, sm_scale, return_lse):
    b, h, t, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, t) if return_lse else (0,),
                                            dtype=torch.float32)


def flash_attention_dq(q, k, v, do, lse, delta, lengths, chunk_size: int = 0,
                       sm_scale: float | None = None):
    """dQ (kernel K3): scale * sum_k [P (dP - delta)] K, in q's dtype.

    q/k/v/do: (B, H, T, D); lse, delta: (B, H, T) fp32.  Every query row
    below T gets its gradient, pad rows included.
    ``flash_attention_dq.launches`` counts kernel launches.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        dq = flash_attention_bwd_plain(q, k, v, do, lse, delta, lengths, chunk_size, sm_scale, "q")
        return dq[0].to(q.dtype)
    _check("flash_attention_dq", q, {"k": k, "v": v, "do": do}, lengths, chunk_size)
    _check_rows("flash_attention_dq", q, lse=lse, delta=delta)
    _check_aligned("flash_attention_dq", q, k, v, do)
    b, h, t, d = q.shape
    lengths = lengths.to(torch.int32).contiguous()
    dq = torch.empty_like(q)
    err = _fn(BWD_SOURCE, "cosy_flash_attention_dq", 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), lengths.data_ptr(), dq.data_ptr(),
        b * h, h, t, d, chunk_size, sm_scale, _DTYPES[q.dtype], _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention_dq kernel failed: CUDA error {err}")
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, lengths, chunk_size: int = 0,
                        sm_scale: float | None = None):
    """(dK, dV) (kernel K4): dK = sum_q dS^T (Q scale), dV = sum_q P^T dO.

    Shapes as ``flash_attention_dq``.  Keys at or past length[b] get exactly
    zero.  ``flash_attention_dkv.launches`` counts kernel launches.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        _, dk, dv = flash_attention_bwd_plain(q, k, v, do, lse, delta, lengths, chunk_size,
                                              sm_scale, "kv")
        return dk.to(k.dtype), dv.to(v.dtype)
    _check("flash_attention_dkv", q, {"k": k, "v": v, "do": do}, lengths, chunk_size)
    _check_rows("flash_attention_dkv", q, lse=lse, delta=delta)
    _check_aligned("flash_attention_dkv", q, k, v, do)
    b, h, t, d = q.shape
    lengths = lengths.to(torch.int32).contiguous()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _fn(BWD_SOURCE, "cosy_flash_attention_dkv", 9)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), lengths.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b * h, h, t, d, chunk_size, sm_scale, _DTYPES[q.dtype], _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention_dkv kernel failed: CUDA error {err}")
    flash_attention_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, lengths, chunk_size: int = 0,
                        sm_scale: float | None = None):
    """The backward of ``flash_attention``: delta = rowsum(dO * O), then K3 and K4
    (on a CPU tensor, their plain versions in one pass).

    Same arguments and result as ``flash_attention_bwd_reference``.
    """
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, lengths, chunk_size, sm_scale)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_attention_dq(q, k, v, do, lse, delta, lengths, chunk_size, sm_scale)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, lengths, chunk_size, sm_scale)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention: K1 with LSE forward, K3 + K4 backward.

    Counterpart of the JAX package's custom VJP (``_flash`` with
    ``_flash_fwd`` / ``_flash_bwd``).  On CPU tensors both directions run the
    plain versions.  No gradient flows to ``lengths``.
    """

    @staticmethod
    def forward(ctx, q, k, v, lengths, chunk_size: int, sm_scale: float):
        o, lse = _launch_fwd(q, k, v, lengths, chunk_size, sm_scale, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse, lengths)
        ctx.chunk_size, ctx.sm_scale = chunk_size, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, lengths = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), lengths,
                                         ctx.chunk_size, ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, lengths, chunk_size: int = 0,
                    sm_scale: float | None = None, return_lse: bool = False):
    """softmax(Q K^T * sm_scale) V under the length/chunk mask.

    q/k/v: (B, H, T, D) float32 or bfloat16; lengths: (B,) int.  Any T.
    Returns o (B, H, T, D) in q's dtype, or (o, lse (B, H, T) fp32).
    Differentiable in q, k and v (not with ``return_lse``).
    ``flash_attention.launches`` counts K1 launches.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if return_lse:
            raise ValueError("flash_attention: return_lse is for calls without autograd")
        return FlashAttentionFunction.apply(q, k, v, lengths, chunk_size, sm_scale)
    if torch.compiler.is_exporting():  # a traced program holds K1 as one operator
        o, lse = flash_attention_fwd(q, k, v, lengths, chunk_size, sm_scale, return_lse)
        return (o, lse) if return_lse else o
    return _launch_fwd(q, k, v, lengths, chunk_size, sm_scale, return_lse)


flash_attention.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0
