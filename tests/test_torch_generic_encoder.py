"""The port's generic Transformer/Conformer encoder
(``cosyvoice2_eu_torch/models/generic_encoder.py``) against the JAX
package's on the same numpy parameters and inputs, fp32 on the CPU
(tolerance 1e-5 absolute on outputs of order 1), at the variants of
``tests/test_generic_encoder.py``."""

import jax
import numpy as np
import pytest
import torch
from torch_parity import reference_encoder_state, t, to_numpy, to_port

from cosyvoice2_eu_torch import config as port_config
from cosyvoice2_eu_torch.models import generic_encoder as port_ge
from cosyvoice2_eu_torch.runtime.checkpoint import _State
from cosyvoice2_eu_tpu import config as jax_config
from cosyvoice2_eu_tpu.models import generic_encoder as jax_ge

TOL = 1e-5
TINY = dict(input_size=16, output_size=32, attention_heads=2, linear_units=48,
            num_blocks=2, max_len=512)

VARIANTS = {
    "conformer_relpos": (dict(input_layer="conv2d"), 37),
    "causal_layernorm_chunked": (dict(input_layer="linear", causal=True,
                                      cnn_module_norm="layer_norm", cnn_module_kernel=7,
                                      static_chunk_size=4), 19),
    "postln_no_cnn": (dict(input_layer="linear_legacy", normalize_before=False,
                           use_cnn_module=False, macaron_style=False,
                           pos_enc_layer_type="rel_pos"), 21),
    "transformer_abs_pos": (dict(arch="transformer", input_layer="linear",
                                 pos_enc_layer_type="abs_pos",
                                 selfattention_layer_type="selfattn",
                                 activation_type="relu"), 23),
    "whisper_style": (dict(arch="transformer", input_layer="conv1d2",
                           pos_enc_layer_type="abs_pos_whisper",
                           selfattention_layer_type="selfattn", activation_type="gelu",
                           key_bias=False), 30),
    "embed_learnable_pe": (dict(arch="transformer", input_layer="embed", vocab_size=50,
                                pos_enc_layer_type="embed_learnable_pe",
                                selfattention_layer_type="selfattn"), 18),
    "conv2d6": (dict(input_layer="conv2d6"), 43),
    "conv2d8": (dict(input_layer="conv2d8"), 51),
    "no_pos": (dict(arch="transformer", input_layer="linear", pos_enc_layer_type="no_pos",
                    selfattention_layer_type="selfattn"), 17),
}


def _cfgs(**kw):
    return (jax_config.GenericEncoderConfig(**TINY, **kw),
            port_config.GenericEncoderConfig(**TINY, **kw))


def _params(jcfg, seed=0):
    """JAX init, with the batch norms' running stats moved off 0 and 1 so
    that the inference-mode norm is exercised."""
    p = to_numpy(jax_ge.init_generic_encoder(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 100)
    for lp in p["encoders"]:
        norm = lp.get("conv_module", {}).get("norm", {})
        if "running_mean" in norm:
            norm["running_mean"] = rng.normal(0.0, 0.1, norm["running_mean"].shape).astype(
                np.float32)
            norm["running_var"] = rng.uniform(0.5, 1.5, norm["running_var"].shape).astype(
                np.float32)
    return p


def _inputs(cfg, b, t_len, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.input_layer == "embed":
        xs = rng.integers(0, cfg.vocab_size, (b, t_len)).astype(np.int64)
    else:
        xs = rng.standard_normal((b, t_len, cfg.input_size)).astype(np.float32)
    lens = np.full((b,), t_len, np.int32)
    lens[-1] = t_len - 3 * port_ge.subsample_info(cfg.input_layer)[0]
    return xs, lens


def _assert_close(got, want, tol=TOL):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol, err


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_matches_jax(name):
    """Every input layer, positional encoding, attention kind, CNN module and
    norm placement: outputs and masks of a B=2 ragged batch equal JAX's,
    full attention and the config's static chunk, and a 4-frame chunk with
    one left chunk."""
    kw, t_len = VARIANTS[name]
    jcfg, pcfg = _cfgs(**kw)
    p = _params(jcfg)
    xs, lens = _inputs(pcfg, 2, t_len)
    for chunk, left in ((0, -1), (-1, -1), (4, 1)):
        want, want_mask = jax_ge.generic_encoder_forward(p, jcfg, xs, lens, chunk, left)
        got, got_mask = port_ge.generic_encoder_forward(to_port(p), pcfg, t(xs), t(lens),
                                                        chunk, left)
        np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
        _assert_close(got, want)


def _chunk_cfgs(**over):
    base = dict(input_layer="linear", pos_enc_layer_type="rel_pos", static_chunk_size=4,
                causal=True, cnn_module_kernel=7)
    base.update(over)
    return _cfgs(**base)


CHUNK_VARIANTS = {
    "conformer_relpos_causal": {},
    "transformer_abspos": dict(arch="transformer", selfattention_layer_type="selfattn",
                               pos_enc_layer_type="abs_pos", activation_type="relu"),
    "conformer_conv2d": dict(input_layer="conv2d"),
}


@pytest.mark.parametrize("name", sorted(CHUNK_VARIANTS))
def test_chunk_by_chunk_matches_jax(name):
    """The KV-cached chunk streaming over 4 chunks with 2 left chunks, and
    one ``generic_encoder_forward_chunk`` step from a fresh state, equal JAX's."""
    jcfg, pcfg = _chunk_cfgs(**CHUNK_VARIANTS[name])
    p = _params(jcfg, seed=2)
    sub, rc = port_ge.subsample_info(pcfg.input_layer)
    t_len = 4 * 4 * sub + rc + 1
    xs = np.random.default_rng(2).standard_normal((1, t_len, pcfg.input_size)).astype(np.float32)
    want, _ = jax_ge.generic_encoder_forward_chunk_by_chunk(p, jcfg, xs, 4, 2)
    got, mask = port_ge.generic_encoder_forward_chunk_by_chunk(to_port(p), pcfg, t(xs), 4, 2)
    _assert_close(got, want)
    assert mask.all() and mask.shape == got.shape[:2]

    window = 3 * sub + rc + 1
    js = jax_ge.init_chunk_state(jcfg, cache_t=8, batch=1)
    ps = port_ge.init_chunk_state(pcfg, cache_t=8, batch=1)
    for cur in (0, 4 * sub):
        wy, js = jax_ge.generic_encoder_forward_chunk(p, jcfg, js, xs[:, cur:cur + window])
        gy, ps = port_ge.generic_encoder_forward_chunk(to_port(p), pcfg, ps,
                                                       t(xs[:, cur:cur + window]))
        _assert_close(gy, wy)
        assert (ps["offset"], ps["filled"]) == (int(js["offset"]), int(js["filled"]))
        _assert_close(ps["att_k"], js["att_k"])


def test_unlimited_left_context_past_16_chunks():
    """-1 left chunks keeps every earlier chunk over 20 chunks, as JAX does."""
    jcfg, pcfg = _chunk_cfgs(**CHUNK_VARIANTS["transformer_abspos"])
    p = _params(jcfg, seed=3)
    t_len = 20 * 4 + 1
    xs = np.random.default_rng(5).standard_normal((1, t_len, pcfg.input_size)).astype(np.float32)
    want, _ = jax_ge.generic_encoder_forward_chunk_by_chunk(p, jcfg, xs, 4, -1)
    got, _ = port_ge.generic_encoder_forward_chunk_by_chunk(to_port(p), pcfg, t(xs), 4, -1)
    _assert_close(got, want)
    # and streaming with every chunk kept equals the full forward at that chunk mask
    full, _ = port_ge.generic_encoder_forward(to_port(p), pcfg, t(xs),
                                              torch.tensor([t_len]), 4, -1)
    _assert_close(got, full[:, :got.shape[1]].numpy(), tol=2e-5)


def test_espnet_relpos_streaming_rejected():
    jcfg, pcfg = _cfgs(input_layer="linear")
    with pytest.raises(ValueError, match="rel_pos_espnet"):
        jax_ge.init_chunk_state(jcfg, cache_t=8)
    with pytest.raises(ValueError, match="rel_pos_espnet"):
        port_ge.init_chunk_state(pcfg, cache_t=8)


@pytest.mark.parametrize("name", ["conformer_relpos", "whisper_style", "embed_learnable_pe",
                                  "conv2d8"])
def test_convert_generic_encoder_matches_jax(name):
    """A reference-layout state dict through both converters: the same tree
    as JAX's conversion and as the parameters it was written from, with
    every key taken."""
    kw, _ = VARIANTS[name]
    jcfg, pcfg = _cfgs(**kw)
    p = _params(jcfg, seed=4)
    sd = reference_encoder_state(p, pcfg)
    state = _State(sd)
    got = port_ge.convert_generic_encoder(state, pcfg)
    state.check_consumed("encoder")
    want = to_numpy(jax_ge.convert_generic_encoder(sd, jcfg))
    for tree in (want, p):
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_want = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert len(flat_got) == len(flat_want)
        for path, leaf in flat_got:
            np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat_want[path]))
