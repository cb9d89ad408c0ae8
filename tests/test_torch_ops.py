"""Parity of the port's ops with the JAX package: masks, stft/istft, RAS
sampling, and K1's plain version (fp32, CPU)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import cuda_device, t  # noqa: F401 (fixture)

from cosyvoice2_eu_torch.ops import flash_attention as port_fa
from cosyvoice2_eu_torch.ops import masks as port_masks
from cosyvoice2_eu_torch.ops import sampling as port_sampling
from cosyvoice2_eu_torch.ops import stft as port_stft
from cosyvoice2_eu_tpu.ops import masks as jax_masks
from cosyvoice2_eu_tpu.ops import sampling as jax_sampling
from cosyvoice2_eu_tpu.ops import stft as jax_stft
from cosyvoice2_eu_tpu.ops.pallas.flash_attention import flash_attention as jax_flash


@pytest.mark.parametrize("chunk,left", [(0, -1), (25, -1), (7, 2)])
def test_masks_match_jax(chunk, left):
    """Boolean masks: exact equality."""
    lengths = np.array([50, 13, 1], np.int32)
    np.testing.assert_array_equal(
        port_masks.make_non_pad_mask(t(lengths), 50).numpy(),
        np.asarray(jax_masks.make_non_pad_mask(jnp.asarray(lengths), 50)))
    if chunk:
        np.testing.assert_array_equal(
            port_masks.subsequent_chunk_mask(50, chunk, left).numpy(),
            jax_masks.subsequent_chunk_mask(50, chunk, left))
    np.testing.assert_array_equal(
        port_masks.chunk_attention_mask(t(lengths), 50, chunk, left).numpy(),
        np.asarray(jax_masks.chunk_attention_mask(jnp.asarray(lengths), 50, chunk, left)))


def test_mask_constants_kept_where_they_are():
    """-1e10 on the plain estimator/encoder/LM paths, -1e30 in K1 and the sampler."""
    from cosyvoice2_eu_tpu.ops.pallas import flash_attention as jax_fa

    assert port_masks.NEG_INF == jax_masks.NEG_INF == -1e10
    assert port_fa.NEG_INF == jax_fa.NEG_INF == -1e30
    assert port_sampling.NEG_INF == jax_sampling.NEG_INF == -1e30


@pytest.mark.parametrize("n_fft,hop", [(16, 4), (128, 32)])
def test_stft_istft_match_jax(n_fft, hop):
    """DFT-matrix (n_fft <= 64) and FFT paths, reflect padding, NOLA envelope.
    fp32 sums of up to n_fft terms of O(1): atol 1e-4."""
    x = np.random.default_rng(0).standard_normal((2, 1000)).astype(np.float32)
    win = jax_stft.hann_window(n_fft)
    np.testing.assert_array_equal(port_stft.hann_window(n_fft), win)
    jr, ji = jax_stft.stft(jnp.asarray(x), n_fft, hop, win)
    pr, pi = port_stft.stft(t(x), n_fft, hop, win)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), atol=1e-4)
    np.testing.assert_allclose(pi.numpy(), np.asarray(ji), atol=1e-4)
    want = np.asarray(jax_stft.istft(jr, ji, n_fft, hop, win))
    got = port_stft.istft(pr, pi, n_fft, hop, win).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, x[:, : got.shape[1]], atol=1e-4)  # round trip


@pytest.mark.parametrize("case", ["plain", "ignore_eos", "repetition"])
def test_ras_sample_matches_jax_with_rebuilt_draws(case):
    """The same token as JAX's ras_sample when the port gets the Gumbel draws
    JAX makes from the key (split -> nucleus key, full key).  Exact equality."""
    vocab, eos, top_k = 90, 87, 25
    for seed in range(12):
        rng = np.random.default_rng(seed)
        logits = jax.nn.log_softmax(jnp.asarray(rng.standard_normal(vocab) * 3, jnp.float32))
        if case == "ignore_eos":
            logits = logits.at[eos:].set(5.0)  # stop tokens would win if not banned
        recent = rng.integers(0, vocab, 10).astype(np.int32)
        key = jax.random.key(seed)
        ignore = case == "ignore_eos"
        want = int(jax_sampling.ras_sample(key, logits, jnp.asarray(recent), jnp.asarray(ignore),
                                           eos, top_k=top_k))
        if case == "repetition":
            recent[:] = want  # the nucleus draw repeats -> the full-vocab redraw decides
            want = int(jax_sampling.ras_sample(key, logits, jnp.asarray(recent),
                                               jnp.asarray(ignore), eos, top_k=top_k))
        k_nuc, k_full = jax.random.split(key)
        g_nuc = np.asarray(jax.random.gumbel(k_nuc, (top_k,), jnp.float32))
        g_full = np.asarray(jax.random.gumbel(k_full, (vocab,), jnp.float32))
        got = int(port_sampling.ras_sample(t(logits), t(recent).long(), torch.tensor(ignore),
                                           eos, t(g_nuc), t(g_full), top_k=top_k))
        assert got == want, (case, seed)
        if case == "ignore_eos":
            assert got < eos


def _qkv(t_len, b=2, h=2, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t_len, d)).astype(np.float32) * 0.5 for _ in range(3)]


@pytest.mark.parametrize("t_len,chunk,lengths", [(256, 0, [256, 160]), (256, 64, [256, 100]),
                                                 (384, 0, [384, 300]), (384, 64, [300, 384])])
def test_flash_plain_matches_pallas_interpret(t_len, chunk, lengths):
    """K1's plain version against the Pallas kernel in interpret mode, on
    valid query rows (pad rows are discarded downstream).  fp32, atol 2e-5
    as the JAX package's own kernel test."""
    q, k, v = _qkv(t_len)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(lengths), chunk_size=chunk, block_q=128,
                                block_k=128, interpret=True))
    got = port_fa.flash_attention(t(q), t(k), t(v), t(lengths), chunk_size=chunk).numpy()
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :, :n], want[b, :, :n], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("chunk", [0, 50])
def test_flash_plain_any_length_matches_masked_softmax(chunk):
    """At a T that is not a multiple of 128 (which the Pallas kernel does
    not take): the plain version against the estimator's masked softmax,
    with the LSE against logsumexp.  fp32, atol 1e-5."""
    q, k, v = _qkv(200, seed=1)
    lengths = [200, 77]
    o, lse = port_fa.flash_attention(t(q), t(k), t(v), t(lengths), chunk, return_lse=True)
    mask = np.asarray(jax_masks.chunk_attention_mask(jnp.asarray(lengths), 200, chunk))
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(64) + np.where(mask, 0.0, -1e10)[:, None]
    want_o = np.asarray(jax.nn.softmax(jnp.asarray(s), axis=-1)) @ v
    want_lse = np.asarray(jax.nn.logsumexp(jnp.asarray(s), axis=-1))
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(o.numpy()[b, :, :n], want_o[b, :, :n], atol=1e-5)
        np.testing.assert_allclose(lse.numpy()[b, :, :n], want_lse[b, :, :n], atol=1e-5)


def test_flash_cpu_tensor_takes_plain_version_without_counting():
    """A CPU tensor runs the plain version; only kernel launches are counted."""
    q, k, v = _qkv(64, b=1, h=1)
    before = port_fa.flash_attention.launches
    got = port_fa.flash_attention(t(q), t(k), t(v), t([40]))
    want = port_fa.flash_attention_reference(t(q), t(k), t(v), t([40]))
    assert torch.equal(got, want)
    assert port_fa.flash_attention.launches == before


@pytest.mark.cuda
def test_flash_kernel_matches_plain_on_card(cuda_device):
    """K1 on the card (bf16: the wgmma/TMA design; fp32: the 3xTF32
    mma.sync design) against its plain version on valid rows, O and LSE, at
    T 300 and at T 65 (a partial tile); skipped without a GPU.  fp32 1e-4
    (summation order and 3xTF32's ~2^-21 products); bf16 one output
    rounding, 2^-7 of the largest output (both round nearly the same fp32
    result); the fp32 LSE 1e-5."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for t_len, lens in ((300, (300, 123)), (65, (65, 40))):
        for dtype in (torch.float32, torch.bfloat16):
            for chunk in (0, 50):
                q, k, v = (torch.randn((2, 8, t_len, 64), generator=gen, device=cuda_device)
                           .to(dtype) for _ in range(3))
                lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
                got, got_lse = port_fa.flash_attention(q, k, v, lengths, chunk, return_lse=True)
                want, want_lse = port_fa.flash_attention_reference(q, k, v, lengths, chunk,
                                                                   return_lse=True)
                assert torch.equal(port_fa.flash_attention(q, k, v, lengths, chunk), got)
                for b, n in enumerate(lens):
                    want_b = want[b, :, :n].float()
                    err = (got[b, :, :n].float() - want_b).abs().max().item()
                    tol = 1e-4 if dtype == torch.float32 else \
                        2.0 ** -7 * want_b.abs().max().item()
                    assert err <= tol, (t_len, dtype, chunk, err, tol)
                    lse_err = (got_lse[b, :, :n] - want_lse[b, :, :n]).abs().max().item()
                    assert lse_err <= 1e-5, (t_len, dtype, chunk, lse_err)


def test_library_name_follows_the_shared_headers(tmp_path, monkeypatch):
    """A library is named by its source, every csrc/*.cuh header and the
    flags, so an edit to a header the source includes rebuilds it, and an
    edit to another source does not."""
    from cosyvoice2_eu_torch.ops import cuda_build

    (tmp_path / "a.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "shared.cuh").write_text("int x;\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    before = cuda_build.library_path("a.cu")
    assert before == cuda_build.library_path("a.cu")
    assert before.name.startswith("a_") and before.suffix == ".so"
    (tmp_path / "b.cu").write_text("int b2;\n")
    assert cuda_build.library_path("a.cu") == before
    (tmp_path / "shared.cuh").write_text("int y;\n")
    assert cuda_build.library_path("a.cu") != before
