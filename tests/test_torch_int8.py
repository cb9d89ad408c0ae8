"""Parity of the port's int8 weight-only LM serving with the JAX package:
quantization, the int8 matmul (K2's plain version), the int8 dense, the
no-cache LM forward, HiFT with a source cache, and ``tts`` / ``tts_batch``
end to end (tiny config, fp32, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401 (cuda_device is a fixture)
    cuda_device,
    hift_draws_from_key,
    jax_tts_params,
    lm_draws_from_key,
    t,
    to_numpy,
    to_port,
)

import cosyvoice2_eu_torch as port
from cosyvoice2_eu_torch.config import tiny_test_config as port_tiny
from cosyvoice2_eu_torch.models import hift as port_hift
from cosyvoice2_eu_torch.models import llm as port_llm
from cosyvoice2_eu_torch.models import qwen2 as port_qwen2
from cosyvoice2_eu_torch.ops import int8_matmul as port_i8
from cosyvoice2_eu_torch.runtime import model as port_model
from cosyvoice2_eu_torch.utils import params as port_params
from cosyvoice2_eu_tpu.config import tiny_test_config
from cosyvoice2_eu_tpu.models import hift as jax_hift
from cosyvoice2_eu_tpu.models import llm as jax_llm
from cosyvoice2_eu_tpu.models import qwen2 as jax_qwen2
from cosyvoice2_eu_tpu.ops.pallas.int8_matmul import int8_matmul as jax_int8_matmul
from cosyvoice2_eu_tpu.runtime import model as jax_model
from cosyvoice2_eu_tpu.utils import params as jax_params

CFG = tiny_test_config()
PCFG = port_tiny()


def _dense_params(seed, n=96, k=80, bias=True):
    rng = np.random.default_rng(seed)
    p = {"weight": rng.standard_normal((n, k)).astype(np.float32) * 0.1}
    if bias:
        p["bias"] = rng.standard_normal(n).astype(np.float32)
    return p


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weights", ["float32", "bfloat16-rounded", "zero row"])
def test_quantize_dense_matches_jax_bit_for_bit(weights):
    """Codes and scales equal JAX's exactly: the same fp32 arithmetic (max,
    divide, round half to even, clip); the bias is kept as it is."""
    p = _dense_params(0)
    if weights == "bfloat16-rounded":  # as TTSModel quantizes: after the bf16 cast
        p["weight"] = np.asarray(jnp.asarray(p["weight"], jnp.bfloat16).astype(jnp.float32))
    elif weights == "zero row":  # the 1e-8 floor of the scale
        p["weight"][3] = 0.0
    want = jax_params.quantize_dense({k: jnp.asarray(v) for k, v in p.items()})
    got = port_params.quantize_dense({k: t(v) for k, v in p.items()})
    assert got["weight_q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["weight_q"].numpy(), np.asarray(want["weight_q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    np.testing.assert_array_equal(got["bias"].numpy(), p["bias"])
    assert int(got["weight_q"].abs().max()) == 127


def test_quantize_lm_params_matches_jax():
    """The same tree: every backbone ``*_proj`` and ``llm_decoder`` become
    {weight_q, scale[, bias]}; embeddings and norms stay; leaves equal."""
    jp = jax_llm.init_lm(jax.random.key(0), CFG.llm)
    want = to_numpy(jax_params.quantize_lm_params(jp))
    got = port_params.quantize_lm_params(to_port(jp))
    got_np = jax.tree.map(lambda x: x.numpy(), got, is_leaf=torch.is_tensor)
    assert jax.tree.structure(got_np) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got_np), jax.tree.leaves(want)):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    layer = got["backbone"]["layers"][0]
    assert set(layer["q_proj"]) == {"weight_q", "scale", "bias"}
    assert set(layer["o_proj"]) == {"weight_q", "scale"}
    assert "weight" in layer["input_layernorm"] and "weight" in got["speech_embedding"]


# ---------------------------------------------------------------------------
# the int8 matmul and dense
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,k", [(1, 896, 896), (1, 128, 896), (4, 4864, 896),
                                   (3, 896, 4864), (2, 6564, 896), (576, 896, 896)])
def test_int8_matmul_reference_matches_pallas_interpret(m, n, k):
    """K2's plain version against the Pallas kernel in interpret mode, at the
    shapes of tests/test_pallas_int8.py.  Both sum exact fp32 products in
    fp32, in another order: within 3e-5 x max|want|."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w_q = rng.integers(-127, 128, (n, k)).astype(np.int8)
    want = np.asarray(jax_int8_matmul(jnp.asarray(x), jnp.asarray(w_q), interpret=True))
    got = port_i8.int8_matmul(t(x), t(w_q))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert np.abs(got.numpy() - want).max() <= 3e-5 * np.abs(want).max()


@pytest.mark.parametrize("lead", [(7,), (2, 5)])
def test_dense_int8_matches_jax(lead):
    """The int8 dense with bias on (M, K) and (B, T, K) inputs against the
    JAX package's CPU route, fp32: the same function up to summation order,
    atol 1e-5 on O(1) outputs."""
    p = _dense_params(1)
    x = np.random.default_rng(2).standard_normal((*lead, 80)).astype(np.float32)
    jq = jax_params.quantize_dense({k: jnp.asarray(v) for k, v in p.items()})
    want = np.asarray(jax_params.dense(jq, jnp.asarray(x)))
    pq = port_params.quantize_dense({k: t(v) for k, v in p.items()})
    got = port_params.dense(pq, t(x))
    assert got.shape == (*lead, 96) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    no_bias = port_params.dense({k: v for k, v in pq.items() if k != "bias"}, t(x))
    np.testing.assert_allclose((got - no_bias).numpy(), np.broadcast_to(p["bias"], want.shape),
                               atol=1e-5)


def test_dense_tensor_parallel_int8_raises():
    """The JAX package's tensor-parallel key, ``weight_q_xla``, no longer
    raises: since tensor parallelism is ported, ``dense`` computes JAX's XLA
    route on it, ``(x @ w_q^T.astype(x.dtype)) * scale.astype(x.dtype)`` +
    bias: equal to JAX's on the same codes, fp32 atol 1e-5, and in bf16
    within one bf16 rounding of the output (2^-7 x max|want|)."""
    p = _dense_params(1)
    x = np.random.default_rng(3).standard_normal((2, 5, 80)).astype(np.float32)
    jq = jax_params.quantize_dense({k: jnp.asarray(v) for k, v in p.items()})
    jxla = {("weight_q_xla" if k == "weight_q" else k): v for k, v in jq.items()}
    pq = port_params.quantize_dense({k: t(v) for k, v in p.items()})
    pxla = {("weight_q_xla" if k == "weight_q" else k): v for k, v in pq.items()}
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jax_params.dense(jxla, jnp.asarray(x, jdt)).astype(jnp.float32))
        got = port_params.dense(pxla, t(x).to(dt)).float().numpy()
        tol = 1e-5 if dt == torch.float32 else 2.0**-7 * np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=tol)


def test_int8_matmul_wrapper_checks_device():
    """On the CPU the wrapper runs the plain version; a tensor on another
    device type than the CPU or CUDA is refused, not computed."""
    x, w = torch.ones(2, 16), torch.ones(3, 16, dtype=torch.int8)
    assert torch.equal(port_i8.int8_matmul(x, w), torch.full((2, 3), 16.0))
    with pytest.raises(ValueError, match="GPU"):
        port_i8.int8_matmul(x.to("meta"), w.to("meta"))


@pytest.mark.cuda
def test_int8_matmul_kernel_matches_plain_on_card(cuda_device, monkeypatch):
    """K2 against its plain version on the card, bf16 and fp32 x, ragged M,
    N and K, all three designs as ``design`` routes them (M <= 8 on the
    decode one: 16 channels a block at (4, 6564, 896), 8 elsewhere, and
    clusters of 1, 2, 4 and 8 blocks at (8, 128, 896), (1, 896, 4864),
    (4, 128, 4864) and (2, 33, 8192); bf16 above 8 rows on the wgmma one,
    with 4 and 19 K splits at (130, 896, 896) and (512, 128, 4864); the
    rest on the FMA one): fp32 sums of exact products in another order,
    3e-5 x max|want|.  Two launches of the decode design on the same inputs
    are bit-equal."""
    took = []
    launch = port_i8._launch
    monkeypatch.setattr(port_i8, "_launch",
                        lambda source, *args: took.append(source) or launch(source, *args))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for m, n, k in [(1, 896, 896), (4, 128, 896), (17, 6564, 896), (3, 896, 4864),
                    (5, 33, 100), (130, 896, 896), (512, 128, 4864), (1, 896, 4864),
                    (4, 6564, 896), (8, 128, 896), (4, 128, 4864), (2, 33, 8192)]:
        w_q = torch.randint(-127, 128, (n, k), generator=gen, device=cuda_device,
                            dtype=torch.int8)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((m, k), generator=gen, device=cuda_device).to(dtype)
            before = port_i8.int8_matmul.launches
            got = port_i8.int8_matmul(x, w_q)
            want = port_i8.int8_matmul_reference(x, w_q)
            torch.cuda.synchronize()
            assert port_i8.int8_matmul.launches == before + 1
            assert took[-1] == port_i8.design(dtype, m, k, True)
            expect = (port_i8.SOURCE if k % 16 else port_i8.DECODE_SOURCE if m <= 8
                      else port_i8.SM90_SOURCE if dtype == torch.bfloat16 else port_i8.SOURCE)
            assert took[-1] == expect
            assert (got - want).abs().max().item() <= 3e-5 * want.abs().max().item()
            if took[-1] == port_i8.DECODE_SOURCE:
                assert torch.equal(port_i8.int8_matmul(x, w_q), got)


# ---------------------------------------------------------------------------
# the LM's no-cache forward and the int8 logits band
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_params():
    jp = jax_llm.init_lm(jax.random.key(0), CFG.llm)
    return jp, to_port(jp)


def _packed(seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 100, (2, 24)).astype(np.int32)
    src = rng.integers(0, 3, (2, 24)).astype(np.int32)
    valid = np.ones((2, 24), bool)
    valid[1, 17:] = False  # a padded row
    return ids, src, valid


def test_qwen2_forward_matches_jax(lm_params):
    """Causal attention over valid positions, no cache; fp32, atol 1e-4 on
    O(1) hidden states."""
    jp, pp = lm_params
    ids, src, valid = _packed()
    emb = np.asarray(jax_llm.embed_mixed(jp, jnp.asarray(ids), jnp.asarray(src)))
    want = jax_qwen2.qwen2_forward(jp["backbone"], CFG.llm.backbone, jnp.asarray(emb),
                                   jnp.asarray(valid))
    got = port_qwen2.qwen2_forward(pp["backbone"], PCFG.llm.backbone, t(emb), t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("quant", [False, True])
def test_lm_training_hidden_matches_jax(lm_params, quant):
    """Logits (B, T, full_vocab), unquantized and int8, fp32: atol 1e-4 x
    max|logit| (the int8 speech head's sums run in another order)."""
    jp, pp = lm_params
    if quant:
        jp, pp = jax_params.quantize_lm_params(jp), port_params.quantize_lm_params(pp)
    ids, src, valid = _packed()
    want = np.asarray(jax_llm.lm_training_hidden(jp, CFG.llm, jnp.asarray(ids),
                                                 jnp.asarray(src), jnp.asarray(valid)))
    got = port_llm.lm_training_hidden(pp, PCFG.llm, t(ids).long(), t(src).long(), t(valid))
    assert got.shape == (2, 24, CFG.llm.full_vocab)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_int8_lm_logits_close_to_unquantized(lm_params):
    """The quality pin of tests/test_pallas_int8.py on the port: int8 logits
    within 5% of the largest logit and the argmax kept on > 90% of steps."""
    _, pp = lm_params
    rng = np.random.default_rng(1)
    ids = t(rng.integers(2, 100, (2, 24))).long()
    src = t(rng.integers(0, 3, (2, 24))).long()
    valid = torch.ones((2, 24), dtype=torch.bool)
    logits = port_llm.lm_training_hidden(pp, PCFG.llm, ids, src, valid)
    logits_q = port_llm.lm_training_hidden(port_params.quantize_lm_params(pp), PCFG.llm, ids,
                                           src, valid)
    assert (logits_q - logits).abs().max() / logits.abs().max() < 0.05
    assert (logits_q.argmax(-1) == logits.argmax(-1)).float().mean() > 0.9


# ---------------------------------------------------------------------------
# HiFT with a source cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_len", [None, 300, 0])
def test_hift_inference_source_cache_matches_jax(cache_len):
    """A (B, 1, C) source cache replaces the first cache_len (default C)
    source samples; 0 leaves the source as it is.  fp32, atol 1e-4."""
    jp = jax.jit(jax_hift.init_hift, static_argnums=1)(jax.random.key(3), CFG.hift)
    pp = to_port(jp)
    rng = np.random.default_rng(7)
    mel = rng.standard_normal((2, CFG.hift.in_channels, 4)).astype(np.float32)
    cache = (rng.standard_normal((2, 1, 480)) * 0.1).astype(np.float32)
    key = jax.random.key(17)
    c_len = None if cache_len is None else jnp.asarray(cache_len)
    want, want_s = jax_hift.hift_inference(jp, CFG.hift, jnp.asarray(mel), key,
                                           cache_source=jnp.asarray(cache), cache_len=c_len)
    draws = hift_draws_from_key(key)(2, 4 * CFG.hift.upsample_scale, CFG.hift.nb_harmonics + 1)
    got, got_s = port_hift.hift_inference(pp, PCFG.hift, t(mel), draws=draws,
                                          cache_source=t(cache), cache_len=cache_len)
    n = 480 if cache_len is None else cache_len
    np.testing.assert_array_equal(got_s[:, :, :n].numpy(), cache[:, :, :n])
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tts_params():
    return jax_tts_params(CFG, seed=0)


def _models(params, lm_quant):
    jm = jax_model.TTSModel(CFG, params, seed=7, compute_dtype=None, lm_quant=lm_quant)
    pm = port_model.TTSModel(PCFG, to_numpy(params), seed=7, compute_dtype=None, device="cpu",
                             lm_quant=lm_quant)
    return jm, pm


def _inputs(cls, seed=0, n_text=12, n_sp=6):
    rng = np.random.default_rng(seed)
    return cls(
        text_tokens=rng.integers(2, 200, n_text).astype(np.int32),
        prompt_text_tokens=rng.integers(2, 200, 4).astype(np.int32),
        llm_prompt_speech_tokens=rng.integers(0, CFG.llm.speech_token_size, n_sp).astype(np.int32),
        flow_prompt_speech_tokens=rng.integers(0, CFG.flow.vocab_size, n_sp).astype(np.int32),
        prompt_feat=rng.standard_normal((n_sp * 2, CFG.flow.output_size)).astype(np.float32),
        embedding=rng.standard_normal(CFG.frontend.spk_embed_dim).astype(np.float32),
    )


def _keys(rng, n):
    """The first n keys ``TTSModel._next_rng`` hands out from ``rng``."""
    out = []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        out.append(sub)
    return out


def test_int8_tts_matches_jax_with_rebuilt_draws(tts_params):
    """``TTSModel(lm_quant="int8").tts`` end to end in fp32: the LM draws from
    the first key ``_next_rng`` hands out, the HiFT draws from the second;
    equal tokens and the waveform within atol 1e-3."""
    jm, pm = _models(tts_params, "int8")
    assert "weight_q" in pm.params["llm"]["llm_decoder"]
    jm._rng = jax.random.key(21)
    k_lm, k_hift = _keys(jm._rng, 2)
    want = np.concatenate(list(jm.tts(_inputs(jax_model.PromptInputs, 1), stream=False)))
    inputs = _inputs(port_model.PromptInputs, 1)
    _, _, _, p_bucket, _, max_len = pm._pack_lm_prompt(inputs)
    max_gen = min(((max_len + 63) // 64) * 64, CFG.llm.max_seq_len - p_bucket)
    got = np.concatenate(list(pm.tts(
        inputs, lm_draws=lm_draws_from_key(k_lm, 1, max_gen, CFG.llm.top_k, CFG.llm.full_vocab),
        hift_draws=hift_draws_from_key(k_hift))))
    assert got.shape == want.shape and len(got) == pm.last_n_tokens * 2 * 480
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("lm_quant", [None, "int8"])
def test_tts_batch_matches_jax_with_rebuilt_draws(tts_params, lm_quant, monkeypatch):
    """``tts_batch`` on 3 prompts of different text and prompt lengths: the
    LM draws for batch 3 from the first key, the HiFT draws of each
    sub-batch from the next keys.  The port's tokens equal JAX's, and each
    waveform is within atol 1e-3 (fp32)."""
    jm, pm = _models(tts_params, lm_quant)
    shapes = [(8, 4), (14, 6), (11, 9)]  # (text tokens, prompt speech tokens)
    jm._rng = jax.random.key(31)
    keys = _keys(jm._rng, 4)
    want = jm.tts_batch([_inputs(jax_model.PromptInputs, 10 + i, *s)
                         for i, s in enumerate(shapes)])

    inputs = [_inputs(port_model.PromptInputs, 10 + i, *s) for i, s in enumerate(shapes)]
    packs = [pm._pack_lm_prompt(p) for p in inputs]
    p_bucket = max(pk[3] for pk in packs)
    max_gen = min(((max(pk[5] for pk in packs) + 63) // 64) * 64, CFG.llm.max_seq_len - p_bucket)
    hift_keys = iter(keys[1:])
    decoded, plain_decode = [], port_llm.lm_decode

    def lm_decode(*args, **kwargs):
        decoded.append(plain_decode(*args, **kwargs))
        return decoded[-1]

    monkeypatch.setattr(port_model.llm_mod, "lm_decode", lm_decode)
    got = pm.tts_batch(
        inputs,
        lm_draws=lm_draws_from_key(keys[0], 3, max_gen, CFG.llm.top_k, CFG.llm.full_vocab),
        hift_draws=lambda b, length, h: hift_draws_from_key(next(hift_keys))(b, length, h))

    # JAX's tokens: its decode program again, on the same packed batch and key
    ids = np.zeros((3, p_bucket), np.int32)
    src = np.zeros((3, p_bucket), np.int32)
    for i, pk in enumerate(packs):
        ids[i, : pk[0].shape[1]], src[i, : pk[1].shape[1]] = pk[0][0], pk[1][0]
    toks_j, lens_j = jm._lm_decode_fn(p_bucket, max_gen)(
        jm.params["llm"], jnp.asarray(ids), jnp.asarray(src),
        jnp.asarray([pk[2] for pk in packs]), jnp.asarray([pk[4] for pk in packs]),
        jnp.asarray([pk[5] for pk in packs]), keys[0])
    toks_p, lens_p, _ = decoded[0]
    np.testing.assert_array_equal(lens_p.numpy(), np.asarray(lens_j))
    assert pm.last_batch_tokens == [int(x) for x in np.asarray(lens_j)]
    assert len(set(pm.last_batch_tokens)) > 1  # rows of different lengths
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        n = int(lens_j[i])
        np.testing.assert_array_equal(toks_p[i, :n].numpy(), np.asarray(toks_j)[i, :n])
        assert g.shape == w.shape == (n * 2 * CFG.hift.upsample_scale,)
        np.testing.assert_allclose(g, w, atol=1e-3)


def test_unknown_lm_quant_raises():
    """Only None and "int8" are known; the JAX package ignores any other
    value (ROADMAP §4), the port refuses it."""
    with pytest.raises(ValueError, match="lm_quant"):
        port.load(config=PCFG, device="cpu", lm_quant="int4")
