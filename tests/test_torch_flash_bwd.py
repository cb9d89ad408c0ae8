"""The port's differentiable flash attention (K1 with LSE forward, K3 + K4
backward) against the JAX package's custom VJP (Pallas kernels in interpret
mode) and against torch autograd through the plain forward (fp32, CPU);
K3 and K4 against their plain version on the card (``cuda``-marked)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import cuda_device, t  # noqa: F401 (fixture)

from cosyvoice2_eu_torch.ops import flash_attention as port_fa
from cosyvoice2_eu_tpu.ops.pallas.flash_attention import flash_attention as jax_flash


def _inputs(t_len, lengths, seed, b=2, h=2, d=64):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t_len, d)).astype(np.float32) * 0.5 for _ in range(3))
    do = rng.standard_normal((b, h, t_len, d)).astype(np.float32)  # every row, pad rows too
    return q, k, v, do, np.asarray(lengths, np.int32)


def _port_grads(q, k, v, do, lengths, chunk):
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    o = port_fa.flash_attention(qt, kt, vt, t(lengths), chunk_size=chunk)
    return o, torch.autograd.grad(o, (qt, kt, vt), t(do))


@pytest.mark.parametrize("chunk", [0, 50, 64])
@pytest.mark.parametrize("lengths", [[256, 160], [256, 100]])
def test_flash_vjp_matches_pallas_interpret(chunk, lengths):
    """dQ, dK, dV of the port's FlashAttentionFunction (plain versions on the
    CPU) against the JAX custom VJP with the Pallas backward kernels in
    interpret mode, for a cotangent on every row (pad rows included, which
    both backward passes treat alike).  fp32: atol 1e-5, rtol 1e-4."""
    q, k, v, do, lengths = _inputs(256, lengths, seed=5)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, jnp.asarray(lengths), chunk_size=chunk,
                                               block_q=128, block_k=128, interpret=True),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    _, got = _port_grads(q, k, v, do, lengths, chunk)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("t_len,chunk,lengths", [(200, 0, [200, 77]), (200, 50, [130, 200]),
                                                 (130, 64, [130, 5])])
def test_flash_bwd_reference_matches_autograd(t_len, chunk, lengths):
    """flash_attention_bwd_reference against torch autograd through
    flash_attention_reference, at T not a multiple of 64, every row.  fp32:
    atol 2e-6 (the same products summed in another order)."""
    q, k, v, do, lengths = _inputs(t_len, lengths, seed=6)
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    o, lse = port_fa.flash_attention_reference(qt, kt, vt, t(lengths), chunk, return_lse=True)
    want = torch.autograd.grad(o, (qt, kt, vt), t(do))
    got = port_fa.flash_attention_bwd_reference(t(q), t(k), t(v), o.detach(), lse.detach(),
                                                t(do), t(lengths), chunk)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-6, err_msg=f"d{name}")


def test_flash_function_forward_equals_inference_and_counts_nothing_on_cpu():
    """Under autograd the forward is the inference forward, and the CPU path
    launches (and counts) no kernel."""
    q, k, v, do, lengths = _inputs(96, [96, 40], seed=7)
    counts = [f.launches for f in (port_fa.flash_attention, port_fa.flash_attention_dq,
                                   port_fa.flash_attention_dkv)]
    o, grads = _port_grads(q, k, v, do, lengths, 0)
    assert o.requires_grad and o.grad_fn is not None
    assert torch.equal(o.detach(), port_fa.flash_attention(t(q), t(k), t(v), t(lengths)))
    assert all(torch.isfinite(g).all() for g in grads)
    assert counts == [f.launches for f in (port_fa.flash_attention, port_fa.flash_attention_dq,
                                           port_fa.flash_attention_dkv)]
    with pytest.raises(ValueError):
        port_fa.flash_attention(t(q).requires_grad_(), t(k), t(v), t(lengths), return_lse=True)


@pytest.mark.cuda
def test_flash_bwd_kernels_match_plain_on_card(cuda_device):
    """K3 and K4 on the card against their plain version, every row and key,
    dK/dV exactly 0 past the lengths; skipped without a GPU.  fp32 1e-4 x
    max(1, max|want|) (summation order); bf16 one output rounding, 2^-7 of
    the largest output."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for chunk in (0, 50):
            q, k, v, do = (torch.randn((2, 8, 300, 64), generator=gen, device=cuda_device)
                           .to(dtype) for _ in range(4))
            lengths = torch.tensor([300, 123], dtype=torch.int32, device=cuda_device)
            o, lse = port_fa.flash_attention(q, k, v, lengths, chunk, return_lse=True)
            got = port_fa.flash_attention_bwd(q, k, v, o, lse, do, lengths, chunk)
            want = port_fa.flash_attention_bwd_reference(q, k, v, o, lse, do, lengths, chunk)
            for g, w in zip(got, want):
                peak = w.float().abs().max().item()
                tol = 1e-4 * max(1.0, peak) if dtype == torch.float32 else 2.0 ** -7 * peak
                assert (g.float() - w.float()).abs().max().item() <= tol, (dtype, chunk)
            assert not got[1][1, :, 123:].any() and not got[2][1, :, 123:].any()
