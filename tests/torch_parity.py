"""Shared helpers of the parity tests between the JAX package and the PyTorch port.

Parameters come from the JAX ``init_*`` functions, cross as numpy arrays and
enter the port through ``params_from_numpy``.  Random draws that JAX makes
from a key are rebuilt here from the same key chain and handed to the port,
whose samplers take them as inputs.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice2_eu_torch.utils.params import params_from_numpy

# the suite runs in several pytest-xdist workers: keep each one's torch small
torch.set_num_threads(2)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def to_port(tree):
    """JAX parameter tree -> fp32 CPU tensors for the port."""
    return params_from_numpy(to_numpy(tree), "cpu", torch.float32)


def t(a, dtype=None) -> torch.Tensor:
    x = torch.tensor(np.asarray(a))
    return x if dtype is None else x.to(dtype)


def jax_tts_params(cfg, seed: int = 0) -> dict:
    """The {"llm", "flow", "hift"} tree ``cosyvoice2_eu_tpu.load`` builds from ``seed``."""
    from cosyvoice2_eu_tpu.models.flow import init_flow
    from cosyvoice2_eu_tpu.models.hift import init_hift
    from cosyvoice2_eu_tpu.models.llm import init_lm

    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
    # jit: HiFT's many conv shapes compile faster as one program than op by op
    return {"llm": init_lm(k1, cfg.llm), "flow": init_flow(k2, cfg.flow),
            "hift": jax.jit(init_hift, static_argnums=1)(k3, cfg.hift)}


def lm_draws_from_key(rng, batch: int, steps: int, top_k: int, vocab: int):
    """The Gumbel draws ``lm_decode`` makes from ``rng``, as the port's ``draws(step)``.

    Chain: llm.py ``_sample_tokens`` splits (rng, sub) each step and ``sub``
    into one key per row; ``ras_sample`` splits a row key into the nucleus
    and full-vocabulary keys; ``categorical`` adds ``gumbel(key, shape)``.
    """
    nuc, full = [], []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        keys = jax.random.split(sub, batch)
        pairs = [jax.random.split(k) for k in keys]
        nuc.append(np.stack([np.asarray(jax.random.gumbel(p[0], (top_k,), jnp.float32))
                             for p in pairs]))
        full.append(np.stack([np.asarray(jax.random.gumbel(p[1], (vocab,), jnp.float32))
                              for p in pairs]))
    return lambda step: (torch.tensor(nuc[step]), torch.tensor(full[step]))


def bistream_draws_from_key(rng, top_k: int, vocab: int):
    """The Gumbel draws the bistream decode makes from ``rng`` (the key of
    ``lm_inference_bistream``), as the port's ``draws(step)``, made as the
    steps ask for them.

    Chain: llm.py ``bs_decode`` splits (rng, sub) from the state's key on
    every step (forced fills and special tokens too) and across every call
    of the request, with no per-row split; ``ras_sample`` splits ``sub``
    into the nucleus and full-vocabulary keys.
    """
    key, made = [rng], []

    def draws(step):
        while len(made) <= step:
            key[0], sub = jax.random.split(key[0])
            k_nuc, k_full = jax.random.split(sub)
            nuc = jax.random.gumbel(k_nuc, (top_k,), jnp.float32)
            full = jax.random.gumbel(k_full, (vocab,), jnp.float32)
            made.append((torch.tensor(np.asarray(nuc))[None], torch.tensor(np.asarray(full))[None]))
        return made[step]

    return draws


def hift_draws_from_key(rng):
    """The draws ``hift.sine_source`` makes from ``rng``, as the port's
    ``hift_draws(batch, length, harmonics)``."""

    def draws(batch, length, harmonics):
        k_phase, k_noise = jax.random.split(rng)
        rand_ini = jax.random.uniform(k_phase, (batch, harmonics), jnp.float32)
        noise = jax.random.normal(k_noise, (batch, length, harmonics), jnp.float32)
        return torch.tensor(np.asarray(rand_ini)), torch.tensor(np.asarray(noise))

    return draws


def flow_draws_from_key(rng, batch: int, n_mels: int, t_mel: int) -> dict:
    """The draws JAX's ``flow_loss_fn`` makes from ``rng``, as the port's draws dict.

    Chain: train_step.py ``flow_loss_fn`` splits rng into (k_cond, k_frac,
    k_cfm); losses.py ``cfm_loss`` splits k_cfm into (k_t, k_z, k_cfg).
    """
    k_cond, k_frac, k_cfm = jax.random.split(rng, 3)
    k_t, k_z, k_cfg = jax.random.split(k_cfm, 3)
    draws = {
        "u_cond": jax.random.uniform(k_cond, (batch,)),
        "u_frac": jax.random.uniform(k_frac, (batch,)),
        "u_t": jax.random.uniform(k_t, (batch, 1, 1), jnp.float32),
        "z": jax.random.normal(k_z, (batch, n_mels, t_mel), jnp.float32),
        "u_cfg": jax.random.uniform(k_cfg, (batch,)),
    }
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


def reference_encoder_state(p: dict, cfg) -> dict:
    """The inverse of ``convert_generic_encoder``: a reference
    TransformerEncoder/ConformerEncoder state dict of numpy arrays."""
    sd = {}

    def put(prefix, tree):
        for k, v in tree.items():
            sd[f"{prefix}.{k}"] = np.asarray(v)

    e = p["embed"]
    kind = cfg.input_layer
    if kind in ("linear", "linear_legacy"):
        put("embed.out.0", e["linear"])
        put("embed.out.1", e["norm"])
    elif kind == "embed":
        put("embed.embed", e["embedding"])
    elif kind == "conv1d2":
        put("embed.conv.0", e["conv1"])
        put("embed.conv.2", e["conv2"])
    else:
        put("embed.conv.0", e["conv1"])
        put("embed.conv.2", e["conv2"])
        put("embed.out.0" if kind == "conv2d" else "embed.linear", e["out"])
        if kind == "conv2d8":
            put("embed.conv.4", e["conv3"])
    if "pos_pe" in e:
        sd["embed.pos_enc.pe"] = np.asarray(e["pos_pe"])[None]
    for i, lp in enumerate(p["encoders"]):
        pre = f"encoders.{i}"
        for k, v in lp["self_attn"].items():
            if k.startswith("pos_bias"):
                sd[f"{pre}.self_attn.{k}"] = np.asarray(v)
            else:
                put(f"{pre}.self_attn.{k}", v)
        for ffn in ("feed_forward", "feed_forward_macaron"):
            if ffn in lp:
                put(f"{pre}.{ffn}.w_1", lp[ffn]["w_1"])
                put(f"{pre}.{ffn}.w_2", lp[ffn]["w_2"])
        for k, v in lp.items():
            if k.startswith("norm"):
                put(f"{pre}.{k}", v)
        if "conv_module" in lp:
            for k, v in lp["conv_module"].items():
                put(f"{pre}.conv_module.{k}", v)
    put("after_norm", p["after_norm"])
    return sd


def reference_v1_state_dicts(params: dict, cfg) -> dict:
    """The inverse of ``runtime/checkpoint_v1.py``'s converters: "llm" and
    "flow" of a v1 tree (numpy) as the reference's ``llm.pt`` and
    ``flow.pt`` state dicts, for a ``TTSV1Config`` ``cfg``."""
    out = {}
    if "llm" in params:
        lm = params["llm"]
        sd = {"text_embedding.weight": lm["text_embedding"]["weight"],
              "llm_embedding.weight": lm["llm_embedding"]["weight"],
              "speech_embedding.weight": lm["speech_embedding"]["weight"]}
        for name in ("text_encoder_affine_layer", "spk_embed_affine_layer", "llm_decoder"):
            sd.update({f"{name}.{k}": v for k, v in lm[name].items()})
        for name, ecfg in (("text_encoder", cfg.llm.text_encoder), ("llm", cfg.llm.llm)):
            sd.update({f"{name}.{k}": v
                       for k, v in reference_encoder_state(lm[name], ecfg).items()})
        out["llm"] = {k: np.asarray(v) for k, v in sd.items()}
    if "flow" in params:
        fl = params["flow"]
        sd = {"input_embedding.weight": fl["input_embedding"]["weight"]}
        for name in ("spk_embed_affine_layer", "encoder_proj"):
            sd.update({f"{name}.{k}": v for k, v in fl[name].items()})
        sd.update({f"encoder.{k}": v
                   for k, v in reference_encoder_state(fl["encoder"], cfg.flow.encoder).items()})
        lr = fl["length_regulator"]
        for i, bp in enumerate(lr["blocks"]):
            sd.update({f"length_regulator.model.{3 * i}.{k}": v for k, v in bp["conv"].items()})
            sd.update({f"length_regulator.model.{3 * i + 1}.{k}": v
                       for k, v in bp["norm"].items()})
        sd.update({f"length_regulator.model.{3 * len(lr['blocks'])}.{k}": v
                   for k, v in lr["proj"].items()})
        est, pre = fl["estimator"], "decoder.estimator"

        def put(prefix, tree):
            sd.update({f"{prefix}.{k}": v for k, v in tree.items()})

        def stage(prefix, st):
            rn = st["resnet"]
            for blk in ("block1", "block2"):
                put(f"{prefix}.0.{blk}.block.0", rn[blk]["conv"])
                put(f"{prefix}.0.{blk}.block.1", rn[blk]["norm"])
            put(f"{prefix}.0.mlp.1", rn["mlp"])
            put(f"{prefix}.0.res_conv", rn["res_conv"])
            for j, tb in enumerate(st["transformer"]):
                tp = f"{prefix}.1.{j}"
                for ours, theirs in (("norm1", "norm1"), ("to_q", "attn1.to_q"),
                                     ("to_k", "attn1.to_k"), ("to_v", "attn1.to_v"),
                                     ("to_out", "attn1.to_out.0"), ("norm3", "norm3"),
                                     ("ff_in", "ff.net.0.proj"), ("ff_out", "ff.net.2")):
                    put(f"{tp}.{theirs}", tb[ours])

        put(f"{pre}.time_mlp.linear_1", est["time_mlp"]["linear_1"])
        put(f"{pre}.time_mlp.linear_2", est["time_mlp"]["linear_2"])
        for kind in ("down", "up"):
            n = len(est[kind])
            for i, st in enumerate(est[kind]):
                stage(f"{pre}.{kind}_blocks.{i}", st)
                # Downsample1D / Upsample1D wrap their conv; the last stage's is plain
                put(f"{pre}.{kind}_blocks.{i}.2" + ("" if i == n - 1 else ".conv"), st["conv"])
        for i, st in enumerate(est["mid"]):
            stage(f"{pre}.mid_blocks.{i}", st)
        put(f"{pre}.final_block.block.0", est["final_block"]["conv"])
        put(f"{pre}.final_block.block.1", est["final_block"]["norm"])
        put(f"{pre}.final_proj", est["final_proj"])
        out["flow"] = {k: np.asarray(v) for k, v in sd.items()}
    return out


# ---------------------------------------------------------------------------
# the v1 family's tiny configs (tests/test_v1_family.py's, built from either
# package's config module) and the JAX model's key chain
# ---------------------------------------------------------------------------

V1_MELS = 8


def tiny_v1_lm_cfg(c):
    text_enc = c.GenericEncoderConfig(
        input_size=12, output_size=24, attention_heads=2, linear_units=32, num_blocks=1,
        arch="conformer", input_layer="linear", pos_enc_layer_type="rel_pos_espnet",
        selfattention_layer_type="rel_selfattn", use_cnn_module=False, macaron_style=False,
        static_chunk_size=1, max_len=512)
    llm_enc = c.GenericEncoderConfig(
        input_size=24, output_size=24, attention_heads=2, linear_units=32, num_blocks=2,
        arch="transformer", input_layer="linear_legacy", pos_enc_layer_type="rel_pos_espnet",
        selfattention_layer_type="rel_selfattn", activation_type="relu", static_chunk_size=1,
        max_len=512)
    return c.LMV1Config(text_encoder_input_size=12, llm_input_size=24, llm_output_size=24,
                        text_token_size=40, speech_token_size=16, spk_embed_dim=10,
                        text_encoder=text_enc, llm=llm_enc, top_k=8)


def tiny_v1_estimator_cfg(c, mels: int = V1_MELS, head_dim: int = 4):
    return c.EstimatorV1Config(in_channels=4 * mels, out_channels=mels, channels=(16, 16),
                               attention_head_dim=head_dim, n_blocks=1, num_mid_blocks=2,
                               num_heads=2)


def tiny_v1_flow_cfg(c, mels: int = V1_MELS):
    enc = c.GenericEncoderConfig(
        input_size=16, output_size=16, attention_heads=2, linear_units=32, num_blocks=1,
        arch="conformer", input_layer="linear", pos_enc_layer_type="rel_pos_espnet",
        selfattention_layer_type="rel_selfattn", use_cnn_module=False, macaron_style=False,
        max_len=512)
    return c.FlowV1Config(
        input_size=16, output_size=mels, spk_embed_dim=12, vocab_size=32, encoder=enc,
        length_regulator=c.LengthRegulatorConfig(channels=mels, sampling_ratios=(1, 1)),
        estimator=tiny_v1_estimator_cfg(c, mels), cfm=c.CFMConfig(n_timesteps=2))


def tiny_v1_bundle(c):
    """A tiny TTSV1Config with the v1 geometry: 5 Hz tokens, a 32-sample mel
    hop, HiFT 4 x 2 x 4 = 32, 10-d speaker embeddings shared by LM and flow."""
    mels = V1_MELS
    flow = dataclasses.replace(tiny_v1_flow_cfg(c, mels), input_frame_rate=5, sample_rate=320,
                               mel_hop=32, cache_tail_tokens=4, spk_embed_dim=10)
    hift = c.HiFTConfig(
        in_channels=mels, base_channels=32, nb_harmonics=2, sampling_rate=320,
        upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4), source_resblock_kernel_sizes=(7, 11),
        source_resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
        f0_predictor=c.F0PredictorConfig(in_channels=mels, cond_channels=32))
    cfg = c.TTSV1Config(
        llm=tiny_v1_lm_cfg(c), flow=flow, hift=hift, token_overlap_len=4, mel_cache_len=3,
        mel=c.MelConfig(n_fft=64, num_mels=mels, sampling_rate=320, hop_size=32, win_size=64),
        frontend=c.FrontendConfig(target_sr=320, spk_embed_dim=10))
    assert cfg.hift.upsample_scale == cfg.flow.mel_hop
    return cfg


def tiny_v1_params(cfg, seed: int = 11) -> dict:
    """{"llm", "flow", "hift"} numpy trees for a port ``TTSV1Config``, from
    the port's ``init_*`` (their layout is JAX's:
    ``test_torch_v1_family.py::test_init_trees_match_jax`` holds them to
    ``jax.eval_shape`` of JAX's); both packages then read the same arrays."""
    from cosyvoice2_eu_torch.models.flow_v1 import init_flow_v1
    from cosyvoice2_eu_torch.models.hift import init_hift
    from cosyvoice2_eu_torch.models.llm_v1 import init_lm_v1

    gen = torch.Generator().manual_seed(seed)
    tree = {"llm": init_lm_v1(gen, cfg.llm), "flow": init_flow_v1(gen, cfg.flow),
            "hift": init_hift(gen, cfg.hift)}
    return jax.tree.map(lambda x: x.numpy(), tree)


class V1KeyChain:
    """The keys ``CosyVoice1Model._next_rng`` of the JAX package hands out
    from ``seed``, in order, as the port's draws: ``lm(cfg)`` takes the
    next key for an LM decode, ``flow_noise(shape)`` one for a flow call and
    ``hift_draws(b, L, H)`` one for a HiFT call.  Called in the JAX model's
    order (the LM first, then flow and HiFT a chunk each), they reproduce
    its draws."""

    def __init__(self, seed: int):
        self.rng = jax.random.key(seed)

    def next(self):
        self.rng, sub = jax.random.split(self.rng)
        return sub

    def lm(self, cfg):
        """The LM decode's draws, made as the steps ask for them (the chain
        of ``lm_draws_from_key`` at batch 1)."""
        key, made = [self.next()], []

        def draws(step):
            while len(made) <= step:
                key[0], sub = jax.random.split(key[0])
                k_nuc, k_full = jax.random.split(jax.random.split(sub, 1)[0])
                made.append((
                    torch.tensor(np.asarray(jax.random.gumbel(k_nuc, (cfg.top_k,))))[None],
                    torch.tensor(np.asarray(jax.random.gumbel(
                        k_full, (cfg.speech_token_size + 1,))))[None]))
            return made[step]

        return draws

    def flow_noise(self, shape):
        return torch.tensor(np.asarray(jax.random.normal(self.next(), shape, jnp.float32)))

    def hift_draws(self, batch, length, harmonics):
        return hift_draws_from_key(self.next())(batch, length, harmonics)


def assert_trees_close(got, want, rel: float, abs_: float, path: str = ""):
    """Per leaf: max|got - want| <= rel * max|want| + abs_ (torch tree vs numpy tree)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_trees_close(got[k], want[k], rel, abs_, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, w in enumerate(want):
            assert_trees_close(got[i], w, rel, abs_, f"{path}/{i}")
    else:
        g, w = got.detach().cpu().numpy(), np.asarray(want)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        err, peak = float(np.abs(g - w).max(initial=0.0)), float(np.abs(w).max(initial=0.0))
        assert err <= rel * peak + abs_, (path, err, peak)


@pytest.fixture
def cuda_device():
    """The GPU for tests marked ``cuda``; they skip on a machine without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card")
    return torch.device("cuda")
