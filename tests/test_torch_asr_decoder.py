"""The port's ASR decoder and MoE FFN (``models/decoder.py``) against the JAX
package's on the CPU, at ``tests/test_asr_decoder.py``'s TINY widths and its
config variants: the batched rescoring forward, the one-step decode with its
layer-output cache, the bi-decoder, ``moe_ffn`` (experts gathered here,
computed densely and masked there) and the three state-dict converters,
within 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_trees_close, to_port

from cosyvoice2_eu_torch.config import AsrDecoderConfig as PortCfg
from cosyvoice2_eu_torch.models import decoder as port_dec
from cosyvoice2_eu_tpu.config import AsrDecoderConfig
from cosyvoice2_eu_tpu.models import decoder as jax_dec

TINY = dict(vocab_size=40, encoder_output_size=32, attention_heads=2, linear_units=48,
            num_blocks=2)
VARIANTS = [dict(), dict(normalize_before=False), dict(src_attention=False),
            dict(use_output_layer=False), dict(key_bias=False, activation_type="swish")]
TOL = 1e-5


def _cfgs(over):
    cfg = AsrDecoderConfig(**TINY, **over)
    return cfg, PortCfg(**dataclasses.asdict(cfg))


def _data(cfg, b=3, l=7, t_mem=11, seed=1):
    rng = np.random.default_rng(seed)
    memory = rng.standard_normal((b, t_mem, cfg.encoder_output_size)).astype(np.float32)
    mem_lens = np.array([t_mem, t_mem - 4, t_mem - 1][:b], np.int32)
    ys = rng.integers(0, cfg.vocab_size, (b, l)).astype(np.int32)
    ys_lens = np.array([l, l - 2, l - 3][:b], np.int32)
    return memory, mem_lens, ys, ys_lens


def _close(got, want, path=""):
    g, w = got.detach().numpy(), np.asarray(want)
    assert g.shape == w.shape, path
    np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL * max(1.0, float(np.abs(w).max())),
                               err_msg=path)


def test_config_defaults_equal_jax():
    assert dataclasses.asdict(PortCfg()) == dataclasses.asdict(AsrDecoderConfig())


@pytest.mark.parametrize("over", VARIANTS)
def test_forward_equals_jax(over):
    cfg, pcfg = _cfgs(over)
    params = jax_dec.init_transformer_decoder(jax.random.key(0), cfg)
    memory, mem_lens, ys, ys_lens = _data(cfg)
    want, want_lens = jax_dec.transformer_decoder_forward(
        params, cfg, jnp.asarray(memory), jnp.asarray(mem_lens), jnp.asarray(ys),
        jnp.asarray(ys_lens))
    got, got_lens = port_dec.transformer_decoder_forward(
        to_port(params), pcfg, torch.tensor(memory), torch.tensor(mem_lens),
        torch.tensor(ys, dtype=torch.long), torch.tensor(ys_lens))
    _close(got, want)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))


@pytest.mark.parametrize("over", [dict(), dict(normalize_before=False)])
def test_one_step_cache_equals_jax(over):
    """Four incremental steps, each from the cache the last one returned:
    the log-probs and every layer's cached output."""
    cfg, pcfg = _cfgs(over)
    params = jax_dec.init_transformer_decoder(jax.random.key(1), cfg)
    memory, mem_lens, ys, _ = _data(cfg, l=6)
    pp = to_port(params)
    jc = pc = None
    for step in range(3, 7):
        want, jc = jax_dec.decoder_forward_one_step(
            params, cfg, jnp.asarray(memory), jnp.asarray(mem_lens), jnp.asarray(ys[:, :step]),
            jc)
        got, pc = port_dec.decoder_forward_one_step(
            pp, pcfg, torch.tensor(memory), torch.tensor(mem_lens),
            torch.tensor(ys[:, :step], dtype=torch.long), pc)
        _close(got, want, f"step {step}")
        assert len(pc) == len(jc) == cfg.num_blocks
        for i, (g, w) in enumerate(zip(pc, jc)):
            assert g.shape[1] == step
            _close(g, w, f"step {step} layer {i}")


@pytest.mark.parametrize("reverse_weight", [0.0, 0.3])
def test_bi_decoder_equals_jax(reverse_weight):
    cfg, pcfg = _cfgs(dict(r_num_blocks=1))
    params = jax_dec.init_bi_transformer_decoder(jax.random.key(2), cfg)
    memory, mem_lens, ys, ys_lens = _data(cfg)
    r_ys = ys[:, ::-1].copy()
    wl, wr, wlens = jax_dec.bi_transformer_decoder_forward(
        params, cfg, jnp.asarray(memory), jnp.asarray(mem_lens), jnp.asarray(ys),
        jnp.asarray(ys_lens), jnp.asarray(r_ys), reverse_weight)
    gl, gr, glens = port_dec.bi_transformer_decoder_forward(
        to_port(params), pcfg, torch.tensor(memory), torch.tensor(mem_lens),
        torch.tensor(ys, dtype=torch.long), torch.tensor(ys_lens),
        torch.tensor(r_ys, dtype=torch.long), reverse_weight)
    _close(gl, wl)
    _close(gr, wr)
    assert len(params["right_decoder"]["decoders"]) == 1
    np.testing.assert_array_equal(glens.numpy(), np.asarray(wlens))


@pytest.mark.parametrize("n_expert,k", [(4, 1), (4, 2), (8, 3)])
def test_moe_ffn_equals_jax(n_expert, k):
    params = jax_dec.init_moe_ffn(jax.random.key(3), n_expert, 16, 24)
    x = np.random.default_rng(4).standard_normal((2, 9, 16)).astype(np.float32)
    want = jax_dec.moe_ffn(params, jnp.asarray(x), k)
    got = port_dec.moe_ffn(to_port(params), torch.tensor(x), k)
    _close(got, want)


def test_init_shapes_equal_jax():
    """The port's initializers build JAX's tree (paths and shapes)."""
    cfg, pcfg = _cfgs(dict(r_num_blocks=1))
    g = torch.Generator().manual_seed(0)
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)  # noqa: E731
    got = port_dec.init_bi_transformer_decoder(g, pcfg)
    want = jax_dec.init_bi_transformer_decoder(jax.random.key(0), cfg)
    assert shapes(jax.tree.map(np.asarray, got, is_leaf=torch.is_tensor)) == shapes(want)
    got = port_dec.init_moe_ffn(g, 4, 16, 24)
    assert shapes(jax.tree.map(np.asarray, got, is_leaf=torch.is_tensor)) == shapes(
        jax_dec.init_moe_ffn(jax.random.key(0), 4, 16, 24))


def _state_dict(tree, prefix=""):
    """A parameter tree as the reference's state dict (``embed`` is the
    reference's ``embed.0``, an nn.Sequential)."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}{'embed.0' if k == 'embed' else k}"
        if isinstance(v, (dict, list)):
            out.update(_state_dict(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


@pytest.mark.parametrize("over", [dict(), dict(src_attention=False, use_output_layer=False)])
def test_converters_equal_jax(over):
    cfg, pcfg = _cfgs(dict(over, r_num_blocks=1))
    bi = jax_dec.init_bi_transformer_decoder(jax.random.key(5), cfg)
    state = _state_dict(bi)
    want = jax_dec.convert_bi_transformer_decoder(state, cfg)
    got = port_dec.convert_bi_transformer_decoder(state, pcfg)
    assert_trees_close(to_port(got), jax.tree.map(np.asarray, want), 0.0, 0.0)
    left = {k[len("left_decoder."):]: v for k, v in state.items() if k.startswith("left_")}
    assert_trees_close(to_port(port_dec.convert_transformer_decoder(left, pcfg)),
                       jax.tree.map(np.asarray, jax_dec.convert_transformer_decoder(left, cfg)),
                       0.0, 0.0)
    moe = jax_dec.init_moe_ffn(jax.random.key(6), 3, 8, 12)
    ms = _state_dict(moe)
    assert_trees_close(to_port(port_dec.convert_moe_ffn(ms, 3)),
                       jax.tree.map(np.asarray, jax_dec.convert_moe_ffn(ms, 3)), 0.0, 0.0)
