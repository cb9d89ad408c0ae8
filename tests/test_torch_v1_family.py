"""The port's v1 family modules (CosyVoice-300M) against the JAX package's,
on the same numpy parameters, inputs and draws, fp32 on the CPU, at
``tests/test_v1_family.py``'s tiny configs (copied into ``torch_parity.py``):
the configs and registry dispatch, the length regulator, the v1 estimator,
the v1 flow, the v1 LM (training logits, loss, decode) and the four v1
checkpoint converters.  Module outputs are held to 1e-5 absolute (values of
order 1), gradients to 1e-4 x their largest magnitude."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401 (cuda_device: a fixture)
    V1_MELS,
    assert_trees_close,
    cuda_device,
    flow_draws_from_key,
    lm_draws_from_key,
    reference_v1_state_dicts,
    t,
    tiny_v1_bundle,
    tiny_v1_estimator_cfg,
    tiny_v1_flow_cfg,
    tiny_v1_lm_cfg,
    tiny_v1_params,
    to_numpy,
    to_port,
)

from cosyvoice2_eu_torch import config as port_config
from cosyvoice2_eu_torch import registry as port_registry
from cosyvoice2_eu_torch.models import estimator_v1 as port_est
from cosyvoice2_eu_torch.models import flow_v1 as port_flow
from cosyvoice2_eu_torch.models import length_regulator as port_lr
from cosyvoice2_eu_torch.models import llm_v1 as port_lm
from cosyvoice2_eu_torch.runtime import checkpoint_v1 as port_ckpt
from cosyvoice2_eu_tpu import config as jax_config
from cosyvoice2_eu_tpu import registry as jax_registry
from cosyvoice2_eu_tpu.models import estimator_v1 as jax_est
from cosyvoice2_eu_tpu.models import flow_v1 as jax_flow
from cosyvoice2_eu_tpu.models import length_regulator as jax_lr
from cosyvoice2_eu_tpu.models import llm_v1 as jax_lm
from cosyvoice2_eu_tpu.runtime import checkpoint_v1 as jax_ckpt

TOL = 1e-5


def _close(got, want, tol=TOL):
    got, want = got.detach().cpu().numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol, err


def test_v1_configs_match_jax_and_round_trip():
    """The published v1 bundle and the tiny one equal JAX's field for field
    (``config_to_dict``); ``config_from_dict`` rebuilds each, nested
    dataclasses included; the derived streaming constants agree."""
    for build in (lambda c: c.TTSV1Config(), tiny_v1_bundle):
        pc, jc = build(port_config), build(jax_config)
        assert port_config.config_to_dict(pc) == jax_config.config_to_dict(jc)
        assert port_config.config_from_dict(port_config.TTSV1Config,
                                            port_config.config_to_dict(pc)) == pc
        for name in ("sample_rate", "token_min_hop_len", "token_max_hop_len", "mel_overlap_len",
                     "source_cache_len"):
            assert getattr(pc, name) == getattr(jc, name), name
        assert pc.flow.cache_tail == jc.flow.cache_tail
        assert pc.llm.eos_token == jc.llm.eos_token
    cfg = port_config.TTSV1Config()
    assert (cfg.flow.cache_tail, cfg.mel_overlap_len, cfg.hift.upsample_scale) == (34, 34, 256)
    assert port_config.config_from_dict(port_config.TTSConfig, port_config.config_to_dict(
        port_config.tiny_test_config())) == port_config.tiny_test_config()
    assert port_registry.get_model_type(cfg) == jax_registry.get_model_type(
        jax_config.TTSV1Config()) == "cosyvoice1"


def test_length_regulator_matches_jax():
    """Training forward under a mask; inference with the prompt and a short
    generation, with the head/middle/tail split past 40 tokens, and with no
    prompt."""
    jcfg = jax_config.LengthRegulatorConfig(channels=V1_MELS, sampling_ratios=(1, 1))
    pcfg = port_config.LengthRegulatorConfig(channels=V1_MELS, sampling_ratios=(1, 1))
    p = to_numpy(jax_lr.init_length_regulator(jax.random.key(0), jcfg))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 13, V1_MELS)).astype(np.float32)
    mask = np.arange(29)[None, :] < np.array([29, 22])[:, None]
    _close(port_lr.length_regulator_forward(to_port(p), pcfg, t(x), 29, t(mask)),
           jax_lr.length_regulator_forward(p, jcfg, x, 29, mask))
    for t1, t2, mel1, mel2 in ((6, 12, 10, 20), (6, 50, 10, 86), (0, 45, 0, 77)):
        x1 = rng.standard_normal((1, t1, V1_MELS)).astype(np.float32)
        x2 = rng.standard_normal((1, t2, V1_MELS)).astype(np.float32)
        _close(port_lr.length_regulator_inference(to_port(p), pcfg, t(x1), t(x2), mel1, mel2, 50),
               jax_lr.length_regulator_inference(p, jcfg, x1, x2, mel1, mel2, 50))
    # the interpolation itself at ratios up and down, edges included
    for t_in, t_out in ((7, 19), (19, 7), (5, 5), (1, 4)):
        y = rng.standard_normal((1, 3, t_in)).astype(np.float32)
        _close(port_lr.linear_interpolate(t(y), t_out), jax_lr.linear_interpolate(y, t_out))


@pytest.mark.parametrize("t_len", [24, 23])
def test_estimator_v1_matches_jax(t_len):
    """The U-Net velocity at an even and an odd mel length (the half
    resolution rounds up), a B=2 batch with a ragged mask."""
    jcfg, pcfg = tiny_v1_estimator_cfg(jax_config), tiny_v1_estimator_cfg(port_config)
    p = to_numpy(jax_est.init_estimator_v1(jax.random.key(2), jcfg))
    rng = np.random.default_rng(3)
    b = 2
    x, mu, cond = (rng.standard_normal((b, V1_MELS, t_len)).astype(np.float32)
                   for _ in range(3))
    mask = (np.arange(t_len)[None, None, :] < np.array([t_len, t_len - 5])[:, None, None])
    mask = mask.astype(np.float32)
    tt = rng.uniform(size=(b,)).astype(np.float32)
    spks = rng.standard_normal((b, V1_MELS)).astype(np.float32)
    want = jax.jit(jax_est.estimator_v1_forward, static_argnums=1)(p, jcfg, x, mask, mu, tt,
                                                                   spks, cond)
    got = port_est.estimator_v1_forward(to_port(p), pcfg, t(x), t(mask), t(mu), t(tt), t(spks),
                                        t(cond))
    _close(got, want)
    assert port_est.k1_launches_per_call(port_config.EstimatorV1Config()) == 64


def test_flow_v1_inference_matches_jax():
    """Tokens -> mel with JAX's noise (t2 = 50 takes the regulator's split),
    then a second chunk through the z/mu cache the first returned."""
    jcfg, pcfg = tiny_v1_flow_cfg(jax_config), tiny_v1_flow_cfg(port_config)
    p = to_numpy(jax_flow.init_flow_v1(jax.random.key(4), jcfg))
    rng = np.random.default_rng(4)
    t1, t2, mel1 = 6, 50, 10
    token = rng.integers(0, pcfg.vocab_size, (1, t2)).astype(np.int64)
    prompt_token = rng.integers(0, pcfg.vocab_size, (1, t1)).astype(np.int64)
    prompt_feat = rng.standard_normal((1, mel1, V1_MELS)).astype(np.float32)
    emb = rng.standard_normal((1, pcfg.spk_embed_dim)).astype(np.float32)
    assert port_flow.mel_len_for_tokens(pcfg, t2) == jax_flow.mel_len_for_tokens(jcfg, t2)
    key = jax.random.key(5)
    cache_w = cache_g = None
    for chunk in range(2):
        k_z = jax.random.fold_in(key, chunk)
        total = mel1 + port_flow.mel_len_for_tokens(pcfg, t2)
        z = np.asarray(jax.random.normal(k_z, (1, V1_MELS, total), jnp.float32))
        want, cache_w = jax.jit(jax_flow.flow_v1_inference, static_argnums=1)(
            p, jcfg, token, prompt_token, prompt_feat, emb, k_z, flow_cache=cache_w)
        got, cache_g = port_flow.flow_v1_inference(to_port(p), pcfg, t(token), t(prompt_token),
                                                   t(prompt_feat), t(emb), flow_cache=cache_g,
                                                   z=t(z))
        _close(got, want)
        _close(cache_g, cache_w)
    assert cache_g.shape == (1, V1_MELS, mel1 + pcfg.cache_tail, 2)


def _lm_batch(cfg, seed=8):
    rng = np.random.default_rng(seed)
    b, tt, ts = 2, 7, 11
    return {
        "text_token": rng.integers(1, cfg.text_token_size, (b, tt)).astype(np.int64),
        "text_token_len": np.asarray([tt, tt - 2], np.int64),
        "speech_token": rng.integers(0, cfg.speech_token_size, (b, ts)).astype(np.int64),
        "speech_token_len": np.asarray([ts, ts - 4], np.int64),
        "embedding": rng.standard_normal((b, cfg.spk_embed_dim)).astype(np.float32),
    }


def test_lm_v1_training_matches_jax():
    """Training logits, targets, loss and accuracy on a ragged B=2 batch."""
    jcfg, pcfg = tiny_v1_lm_cfg(jax_config), tiny_v1_lm_cfg(port_config)
    p = to_numpy(jax_lm.init_lm_v1(jax.random.key(0), jcfg))
    batch = _lm_batch(pcfg)
    jbatch = {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else v.dtype)
              for k, v in batch.items()}
    pbatch = {k: t(v) for k, v in batch.items()}
    w_logits, w_targets = jax.jit(jax_lm.lm_v1_training_logits, static_argnums=1)(p, jcfg, jbatch)
    g_logits, g_targets = port_lm.lm_v1_training_logits(to_port(p), pcfg, pbatch)
    _close(g_logits, w_logits)
    np.testing.assert_array_equal(g_targets.numpy(), np.asarray(w_targets))
    w_loss, w_acc = jax.jit(jax_lm.lm_v1_loss, static_argnums=1)(p, jcfg, jbatch)
    g_loss, g_acc = port_lm.lm_v1_loss(to_port(p), pcfg, pbatch)
    assert abs(float(g_loss) - float(w_loss)) <= TOL * max(1.0, abs(float(w_loss)))
    assert float(g_acc) == pytest.approx(float(w_acc), abs=1e-7)


@pytest.mark.parametrize("use_spk", [True, False])
def test_lm_v1_decode_matches_jax(use_spk):
    """The whole decode under JAX's draws: equal tokens and lengths, within
    [min_len, max_gen], with and without the speaker slot; the prefix padded
    to a bucket (the decode's relative positions from the padded table)."""
    jcfg, pcfg = tiny_v1_lm_cfg(jax_config), tiny_v1_lm_cfg(port_config)
    p = to_numpy(jax_lm.init_lm_v1(jax.random.key(0), jcfg))
    rng = np.random.default_rng(10)
    tt, ts, pad = 8, 4, 3
    text = np.zeros((1, tt + pad), np.int64)
    text[0, :tt] = rng.integers(1, pcfg.text_token_size, tt)
    prompt = np.zeros((1, ts + pad), np.int64)
    prompt[0, :ts] = rng.integers(0, pcfg.speech_token_size, ts)
    emb = rng.standard_normal((1, pcfg.spk_embed_dim)).astype(np.float32)
    key, max_gen = jax.random.key(3), 40
    w_tok, w_len = jax_lm.lm_v1_decode(p, jcfg, jnp.asarray(text, jnp.int32), jnp.asarray([tt]),
                                       jnp.asarray([2]), jnp.asarray(prompt, jnp.int32),
                                       jnp.asarray([ts]), emb, key, max_gen, use_spk=use_spk)
    draws = lm_draws_from_key(key, 1, max_gen, pcfg.top_k, pcfg.speech_token_size + 1)
    g_tok, g_len, steps = port_lm.lm_v1_decode(to_port(p), pcfg, t(text), t([tt]), t([2]),
                                               t(prompt), t([ts]), t(emb), max_gen,
                                               use_spk=use_spk, draws=draws)
    n = int(w_len[0])
    assert int(g_len[0]) == n and int((tt - 2) * pcfg.min_token_text_ratio) <= n <= max_gen
    np.testing.assert_array_equal(g_tok.numpy()[0, :n], np.asarray(w_tok)[0, :n])
    assert steps >= n


def test_lm_v1_decode_step_matches_the_full_forward():
    """The cached decode (prefill + steps with the projected position table)
    gives the hidden state the full causal forward gives at each position."""
    cfg = tiny_v1_lm_cfg(port_config)
    p = to_port(to_numpy(jax_lm.init_lm_v1(jax.random.key(1), tiny_v1_lm_cfg(jax_config))))
    cfg_llm = cfg.llm
    rng = np.random.default_rng(9)
    L0, n_new = 9, 3
    xs = t(rng.standard_normal((1, L0 + n_new, cfg.llm_input_size)).astype(np.float32))
    full, _ = port_lm.generic_encoder_forward(p["llm"], cfg_llm, xs, torch.tensor([L0 + n_new]))
    k, v, hidden = port_lm._prefill(p["llm"], cfg_llm, xs[:, :L0], torch.tensor([L0]),
                                    L0 + n_new)
    _close(hidden, full[:, :L0].numpy())
    h_heads = cfg_llm.attention_heads
    table = torch.as_tensor(port_lm._pos_table_positive(L0 + n_new, cfg_llm.output_size))
    pos_proj = torch.stack([port_lm.dense(lp["self_attn"]["linear_pos"], table)
                            .reshape(-1, h_heads, cfg_llm.output_size // h_heads)
                            for lp in p["llm"]["encoders"]])
    for i in range(n_new):
        h = port_lm._decode_step(p["llm"], cfg_llm, pos_proj, xs[:, L0 + i:L0 + i + 1], k, v,
                                 torch.tensor([L0]), L0, i)
        _close(h, full[:, L0 + i].numpy())


def test_flow_v1_loss_and_gradients_match_jax():
    """The v1 flow's training loss under JAX's draws, and every parameter's
    gradient (1e-4 x its largest magnitude + 1e-7); K1's backward is not on
    this CPU path (the plain masked softmax is differentiated)."""
    jcfg, pcfg = tiny_v1_flow_cfg(jax_config), tiny_v1_flow_cfg(port_config)
    p = to_numpy(jax_flow.init_flow_v1(jax.random.key(0), jcfg))
    rng = np.random.default_rng(5)
    b, tt, t_mel = 2, 12, 20
    batch = {
        "speech_token": rng.integers(0, pcfg.vocab_size, (b, tt)).astype(np.int32),
        "speech_token_len": np.asarray([tt, tt - 3], np.int32),
        "speech_feat": rng.standard_normal((b, t_mel, V1_MELS)).astype(np.float32),
        "speech_feat_len": np.asarray([t_mel, t_mel - 5], np.int32),
        "embedding": rng.standard_normal((b, pcfg.spk_embed_dim)).astype(np.float32),
    }
    key = jax.random.key(1)
    w_loss, w_grads = jax.jit(jax.value_and_grad(
        lambda q: jax_flow.flow_v1_loss(q, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                                        key)))(p)
    params = to_port(p)
    for leaf in jax.tree.leaves(params):
        leaf.requires_grad_(True)
    draws = flow_draws_from_key(key, b, V1_MELS, t_mel)
    loss = port_flow.flow_v1_loss(params, pcfg, {k: t(v).long() if v.dtype == np.int32 else t(v)
                                                 for k, v in batch.items()}, draws)
    loss.backward()
    assert abs(loss.detach().item() - float(w_loss)) <= 1e-5 * abs(float(w_loss))
    grads = jax.tree.map(lambda x: x.grad, params)
    assert_trees_close(grads, to_numpy(w_grads), rel=1e-4, abs_=1e-7)


def test_checkpoint_v1_converters_match_jax():
    """Reference-layout llm.pt and flow.pt state dicts through the port's
    and JAX's converters (the LM, the flow, the estimator and the length
    regulator on their own): equal trees, equal to the parameters they
    were written from; an unmapped key raises in the port."""
    pcfg, jcfg = tiny_v1_bundle(port_config), tiny_v1_bundle(jax_config)
    params = tiny_v1_params(pcfg)
    sd = reference_v1_state_dicts(params, pcfg)
    pairs = [
        (port_ckpt.convert_llm_v1(sd["llm"], pcfg.llm),
         jax_ckpt.convert_llm_v1(sd["llm"], jcfg.llm), params["llm"]),
        (port_ckpt.convert_flow_v1(sd["flow"], pcfg.flow),
         jax_ckpt.convert_flow_v1(sd["flow"], jcfg.flow), params["flow"]),
    ]
    est = {k[len("decoder.estimator."):]: v for k, v in sd["flow"].items()
           if k.startswith("decoder.estimator.")}
    pairs.append((port_ckpt.convert_estimator_v1(est, pcfg.flow.estimator),
                  jax_ckpt.convert_estimator_v1(est, jcfg.flow.estimator),
                  params["flow"]["estimator"]))
    pairs.append((port_ckpt.convert_length_regulator(sd["flow"], pcfg.flow.length_regulator,
                                                     "length_regulator"),
                  jax_ckpt.convert_length_regulator(sd["flow"], jcfg.flow.length_regulator,
                                                    "length_regulator"),
                  params["flow"]["length_regulator"]))
    for got, want, orig in pairs:
        got = to_port(got)
        assert_trees_close(got, to_numpy(want), rel=0.0, abs_=0.0)
        assert_trees_close(got, orig, rel=0.0, abs_=0.0)
    for name, convert, c in (("llm", port_ckpt.convert_llm_v1, pcfg.llm),
                             ("flow", port_ckpt.convert_flow_v1, pcfg.flow)):
        with pytest.raises(ValueError, match="unmapped"):
            convert(dict(sd[name], **{"stray.weight": np.zeros(2)}), c)
    # the buffers a reference module keeps beside its weights are skipped
    convert = dict(sd["flow"], **{"encoder.embed.pos_enc.pe": np.zeros((1, 4, 16), np.float32)})
    port_ckpt.convert_flow_v1(convert, pcfg.flow)


def test_init_trees_match_jax():
    """The port's ``init_*`` trees have JAX's structure, shapes and dtypes
    at the tiny bundle (JAX's by ``jax.eval_shape``: nothing is computed)."""
    from cosyvoice2_eu_tpu.models.hift import init_hift

    pcfg, jcfg = tiny_v1_bundle(port_config), tiny_v1_bundle(jax_config)
    got = jax.tree.map(lambda x: (x.shape, x.dtype), tiny_v1_params(pcfg))
    want = jax.eval_shape(lambda: {"llm": jax_lm.init_lm_v1(jax.random.key(0), jcfg.llm),
                                   "flow": jax_flow.init_flow_v1(jax.random.key(1), jcfg.flow),
                                   "hift": init_hift(jax.random.key(2), jcfg.hift)})
    assert got == jax.tree.map(lambda x: (tuple(x.shape), np.dtype(x.dtype)), want)


@pytest.mark.cuda
def test_v1_flow_on_the_card_launches_k1_fp32(cuda_device):
    """On a CUDA tensor the v1 flow's estimator launches K1's fp32 design,
    once per transformer block and Euler step, and the mel stays within
    1e-4 of the CPU's (estimator heads of 64, the kernel's head dim)."""
    from cosyvoice2_eu_torch.ops import flash_attention as fa

    pcfg = tiny_v1_flow_cfg(port_config)
    pcfg = dataclasses.replace(pcfg, estimator=tiny_v1_estimator_cfg(port_config, head_dim=64))
    params = port_flow.init_flow_v1(torch.Generator().manual_seed(0), pcfg)
    rng = np.random.default_rng(6)
    token = t(rng.integers(0, pcfg.vocab_size, (1, 30)))
    prompt_token = t(rng.integers(0, pcfg.vocab_size, (1, 5)))
    feat = t(rng.standard_normal((1, 9, V1_MELS)).astype(np.float32))
    emb = t(rng.standard_normal((1, pcfg.spk_embed_dim)).astype(np.float32))
    z = torch.randn((1, V1_MELS, 9 + port_flow.mel_len_for_tokens(pcfg, 30)),
                    generator=torch.Generator().manual_seed(1))
    want, _ = port_flow.flow_v1_inference(params, pcfg, token, prompt_token, feat, emb, z=z)
    on_card = jax.tree.map(lambda x: x.to(cuda_device), params)
    before = fa.flash_attention.launches
    got, _ = port_flow.flow_v1_inference(on_card, pcfg, token.to(cuda_device),
                                         prompt_token.to(cuda_device), feat.to(cuda_device),
                                         emb.to(cuda_device), z=z)
    assert fa.flash_attention.launches - before == (
        port_est.k1_launches_per_call(pcfg.estimator) * pcfg.cfm.n_timesteps)
    _close(got, want.numpy(), tol=1e-4)
