"""Parity of the port's speech LM with the JAX package (tiny config, fp32, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import lm_draws_from_key, t, to_port

from cosyvoice2_eu_torch.config import tiny_test_config as port_tiny
from cosyvoice2_eu_torch.models import llm as port_llm
from cosyvoice2_eu_torch.models import qwen2 as port_qwen2
from cosyvoice2_eu_tpu.config import tiny_test_config
from cosyvoice2_eu_tpu.models import llm as jax_llm
from cosyvoice2_eu_tpu.models import qwen2 as jax_qwen2

CFG = tiny_test_config()
PCFG = port_tiny()


@pytest.fixture(scope="module")
def params():
    p = jax_llm.init_lm(jax.random.key(0), CFG.llm)
    return p, to_port(p)


def _prompt(seed=0, p_bucket=64):
    """A packed prompt: sos, 12 text ids, task id, 8 speech ids, right-padded."""
    rng = np.random.default_rng(seed)
    n_text, n_sp = 12, 8
    ids = np.zeros((2, p_bucket), np.int32)
    src = np.zeros((2, p_bucket), np.int32)
    ids[:, 1:1 + n_text] = rng.integers(2, CFG.llm.backbone.vocab_size, (2, n_text))
    src[:, 1:1 + n_text] = jax_llm.SRC_TEXT
    ids[:, 1 + n_text] = CFG.llm.task_id
    ids[:, 2 + n_text:2 + n_text + n_sp] = rng.integers(0, CFG.llm.speech_token_size, (2, n_sp))
    src[:, 2 + n_text:2 + n_text + n_sp] = jax_llm.SRC_SPEECH
    prompt_len = np.array([2 + n_text + n_sp, 2 + n_text + 3], np.int32)  # ragged rows
    return ids, src, prompt_len


def test_qwen2_prefill_matches_jax(params):
    """Last hidden state and the (bf16) KV cache after prefill.  fp32
    activations: atol 1e-4 on O(1) hidden states; the cache is bf16 on both
    sides (KVCache.zeros defaults to bf16), so K/V agree to one bf16 step."""
    jp, pp = params
    ids, src, prompt_len = _prompt()
    max_len = ids.shape[1] + 32
    emb_j = jax_llm.embed_mixed(jp, jnp.asarray(ids), jnp.asarray(src))
    last_j, kv_j = jax_qwen2.qwen2_prefill(
        jp["backbone"], CFG.llm.backbone, emb_j, jnp.asarray(prompt_len),
        jax_qwen2.KVCache.zeros(CFG.llm.backbone, 2, max_len))
    emb_p = port_llm.embed_mixed(pp, t(ids).long(), t(src).long())
    np.testing.assert_allclose(emb_p.numpy(), np.asarray(emb_j), atol=1e-6)
    kv_p = port_qwen2.KVCache.zeros(PCFG.llm.backbone, 2, max_len, device="cpu")
    last_p, kv_p = port_qwen2.qwen2_prefill(pp["backbone"], PCFG.llm.backbone, emb_p,
                                            t(prompt_len).long(), kv_p)
    np.testing.assert_allclose(last_p.numpy(), np.asarray(last_j), atol=1e-4)
    assert kv_p.k.dtype == torch.bfloat16
    for got, want in ((kv_p.k, kv_j.k), (kv_p.v, kv_j.v)):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=1e-2)
        assert np.mean(got.float().numpy() == want) > 0.99  # mostly the same bf16 values


def test_lm_decode_tokens_equal_jax_with_rebuilt_draws(params):
    """lm_decode gives JAX's tokens exactly when the port gets the Gumbel
    draws JAX's key chain makes (llm.py _sample_tokens -> sampling.ras_sample)."""
    jp, pp = params
    ids, src, prompt_len = _prompt(seed=1)
    min_len, max_len, max_gen = np.array([5, 20]), np.array([40, 60]), 64
    key = jax.random.key(11)
    fn = jax.jit(jax_llm.lm_decode, static_argnums=(1, 8))
    toks_j, lens_j = fn(jp, CFG.llm, jnp.asarray(ids), jnp.asarray(src), jnp.asarray(prompt_len),
                        jnp.asarray(min_len), jnp.asarray(max_len), key, max_gen)
    draws = lm_draws_from_key(key, 2, max_gen, CFG.llm.top_k, CFG.llm.full_vocab)
    toks_p, lens_p, steps = port_llm.lm_decode(
        pp, PCFG.llm, t(ids).long(), t(src).long(), t(prompt_len).long(), t(min_len).long(),
        t(max_len).long(), max_gen, draws=draws)
    np.testing.assert_array_equal(lens_p.numpy(), np.asarray(lens_j))
    assert int(lens_p.max()) <= steps <= max_gen  # specials and EOS take steps, emit nothing
    for b in range(2):
        n = int(lens_j[b])
        assert n >= min_len[b]
        np.testing.assert_array_equal(toks_p[b, :n].numpy(), np.asarray(toks_j)[b, :n])


def test_lm_decode_generator_draws_are_reproducible(params):
    """Without injected draws the Gumbel noise comes from the generator:
    the same seed gives the same tokens."""
    _, pp = params
    ids, src, prompt_len = _prompt(seed=2)
    args = (pp, PCFG.llm, t(ids).long(), t(src).long(), t(prompt_len).long(),
            t([3, 3]).long(), t([30, 30]).long(), 32)
    a = port_llm.lm_decode(*args, generator=torch.Generator().manual_seed(5))
    b = port_llm.lm_decode(*args, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2]
    with pytest.raises(ValueError):
        port_llm.lm_decode(*args)
