"""The port's name registries (``cosyvoice2_eu_torch/registry.py``) against
the JAX package's (``cosyvoice2_eu_tpu/registry.py``): the same names in
every table, activations equal on the same inputs (1e-6), the same
rejections, the same schedules (1e-6 relative: a few fp32 ulps) and the same model-family
dispatch."""

import dataclasses

import numpy as np
import pytest
import torch

from cosyvoice2_eu_torch import config as port_config
from cosyvoice2_eu_torch import registry as port_registry
from cosyvoice2_eu_torch.models.generic_encoder import init_generic_encoder
from cosyvoice2_eu_tpu import config as jax_config
from cosyvoice2_eu_tpu import registry as jax_registry


def test_activation_table_matches_jax():
    assert set(port_registry.ACTIVATIONS) == set(jax_registry.ACTIVATIONS) == {
        "hardtanh", "tanh", "relu", "selu", "swish", "gelu"}
    x = np.linspace(-3, 3, 25, dtype=np.float32)
    for name, fn in port_registry.ACTIVATIONS.items():
        got = port_registry.get_activation(name)(torch.tensor(x)).numpy()
        want = np.asarray(jax_registry.get_activation(name)(x))
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)
        assert fn is port_registry.get_activation(name)
    for registry in (port_registry, jax_registry):
        with pytest.raises(KeyError, match="unknown activation"):
            registry.get_activation("mish")


def test_component_tables_match_jax():
    for name in ("SUBSAMPLE_KINDS", "POS_ENC_KINDS", "ATTENTION_KINDS"):
        assert getattr(port_registry, name) == getattr(jax_registry, name), name


@pytest.mark.parametrize("field,bad", [("input_layer", "conv3d"),
                                       ("pos_enc_layer_type", "rotary"),
                                       ("selfattention_layer_type", "flash"),
                                       ("activation_type", "mish")])
def test_validate_encoder_names_raises_like_jax(field, bad):
    """A good config validates and builds; each unknown name raises
    ``KeyError`` in both packages, before any parameter is drawn."""
    kw = dict(input_size=8, output_size=8, attention_heads=2, linear_units=16, num_blocks=1,
              arch="transformer", input_layer="linear", pos_enc_layer_type="abs_pos",
              selfattention_layer_type="selfattn", activation_type="relu",
              use_cnn_module=False, macaron_style=False)
    good = port_config.GenericEncoderConfig(**kw)
    port_registry.validate_encoder_names(good)
    init_generic_encoder(torch.Generator().manual_seed(0), good)
    for registry, c in ((port_registry, port_config), (jax_registry, jax_config)):
        with pytest.raises(KeyError, match="unknown"):
            registry.validate_encoder_names(c.GenericEncoderConfig(**dict(kw, **{field: bad})))
    with pytest.raises(KeyError, match="unknown"):
        init_generic_encoder(torch.Generator(), dataclasses.replace(good, **{field: bad}))


def test_schedulers_match_jax():
    for name in ("warmuplr", "constantlr", "noamhold"):
        got, want = port_registry.get_scheduler(name)(1e-3, 10), \
            jax_registry.get_scheduler(name)(1e-3, 10)
        for step in (0, 1, 5, 10, 37):
            g, w = float(got(step)), float(np.asarray(want(step)))
            assert np.isfinite(g) and g == pytest.approx(w, rel=1e-6), (name, step)
    for registry in (port_registry, jax_registry):
        with pytest.raises(KeyError, match="unknown scheduler"):
            registry.get_scheduler("cosine_annealing")


def test_get_model_type_matches_jax():
    for c in (port_config, jax_config):
        registry = port_registry if c is port_config else jax_registry
        cfg = c.tiny_test_config()
        assert registry.get_model_type(cfg) == "cosyvoice2"
        v1_flow = dataclasses.replace(cfg.flow, token_mel_ratio=1)
        assert registry.get_model_type(dataclasses.replace(cfg, flow=v1_flow)) == "cosyvoice1"
        assert registry.get_model_type(c.TTSV1Config()) == "cosyvoice1"
        odd = dataclasses.replace(cfg, flow=dataclasses.replace(cfg.flow, token_mel_ratio=0))
        with pytest.raises(TypeError, match="No valid model type"):
            registry.get_model_type(odd)
