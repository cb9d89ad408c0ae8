"""Reference checkpoints (torch ``.pt`` state dicts) -> the port's parameter trees.

Counterpart of ``cosyvoice2_eu_tpu/runtime/checkpoint.py``: maps the
reference's ``llm.pt`` / ``flow.pt`` / ``hift.pt`` state dicts (its
``Qwen2LM``, ``CausalMaskedDiffWithXvec`` and ``HiFTGenerator`` module
trees) onto the trees the ``init_*`` functions build.  The layouts already
agree (torch conventions throughout), so a conversion renames keys and folds
weight norm.  The converters work on host numpy arrays and return numpy
trees with the JAX package's paths; ``load(model_dir=...)`` hands them to
``params_from_numpy`` as ``load(params=...)`` does.  A key that no
converter maps raises ``ValueError``.

``save_pytree`` / ``load_pytree`` are the native checkpoints (the JAX
package's ``:313-327``): a directory per tree, which ``load_pytree`` also
reads when the JAX package's orbax wrote it.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from cosyvoice2_eu_torch.config import FlowConfig, HiFTConfig, LMConfig, TTSConfig
from cosyvoice2_eu_torch.models.flow import make_rand_noise


def load_torch_state(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint as numpy arrays (floating tensors as float32); a
    ``{"state_dict": ...}`` wrapper is unwrapped."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {k: v.float().numpy() if v.is_floating_point() else v.numpy()
            for k, v in state.items() if torch.is_tensor(v)}


def fold_weight_norm(weight_g: np.ndarray, weight_v: np.ndarray) -> np.ndarray:
    """torch weight norm (g * v / ||v||, the norm over every axis but the
    first) as a plain weight, as the reference's ``remove_weight_norm``."""
    axis = tuple(range(1, weight_v.ndim))
    norm = np.sqrt(np.sum(weight_v * weight_v, axis=axis, keepdims=True))
    return weight_g * weight_v / np.maximum(norm, 1e-12)


class _State:
    """A state dict that records which keys were taken."""

    def __init__(self, state: Dict[str, np.ndarray]):
        self.state = state
        self.used: set = set()

    def take(self, key: str) -> np.ndarray:
        self.used.add(key)
        return self.state[key]

    def has(self, key: str) -> bool:
        return key in self.state

    def linear(self, prefix: str, bias: bool = True) -> dict:
        p = {"weight": self.take(f"{prefix}.weight")}
        if bias and self.has(f"{prefix}.bias"):
            p["bias"] = self.take(f"{prefix}.bias")
        return p

    def norm(self, prefix: str) -> dict:
        return {"weight": self.take(f"{prefix}.weight"), "bias": self.take(f"{prefix}.bias")}

    def wn_conv(self, prefix: str) -> dict:
        """A conv, plain or under torch weight norm in either spelling
        (``parametrizations.weight.original0/1``, ``weight_g/weight_v``),
        folded."""
        if self.has(f"{prefix}.weight"):
            p = {"weight": self.take(f"{prefix}.weight")}
        elif self.has(f"{prefix}.parametrizations.weight.original0"):
            p = {"weight": fold_weight_norm(self.take(f"{prefix}.parametrizations.weight.original0"),
                                            self.take(f"{prefix}.parametrizations.weight.original1"))}
        elif self.has(f"{prefix}.weight_g"):
            p = {"weight": fold_weight_norm(self.take(f"{prefix}.weight_g"),
                                            self.take(f"{prefix}.weight_v"))}
        else:
            raise KeyError(f"no weight found for {prefix}")
        if self.has(f"{prefix}.bias"):
            p["bias"] = self.take(f"{prefix}.bias")
        return p

    def check_consumed(self, what: str, ignore_prefixes=()) -> None:
        leftover = [k for k in self.state if k not in self.used
                    and not any(k.startswith(p) for p in ignore_prefixes)]
        if leftover:
            raise ValueError(f"unmapped {what} keys: {leftover[:8]}")


# ---------------------------------------------------------------------------
# LM (llm.pt): Qwen2LM over a Qwen2ForCausalLM backbone
# ---------------------------------------------------------------------------

def convert_llm(state: Dict[str, np.ndarray], cfg: LMConfig) -> dict:
    s = _State(state)
    base = "llm.model.model"
    layers = []
    for i in range(cfg.backbone.num_layers):
        pre = f"{base}.layers.{i}"
        layer = {
            "input_layernorm": {"weight": s.take(f"{pre}.input_layernorm.weight")},
            "q_proj": s.linear(f"{pre}.self_attn.q_proj"),
            "k_proj": s.linear(f"{pre}.self_attn.k_proj"),
            "v_proj": s.linear(f"{pre}.self_attn.v_proj"),
            "o_proj": s.linear(f"{pre}.self_attn.o_proj", bias=False),
            "post_attention_layernorm": {
                "weight": s.take(f"{pre}.post_attention_layernorm.weight")},
            "gate_proj": s.linear(f"{pre}.mlp.gate_proj", bias=False),
            "up_proj": s.linear(f"{pre}.mlp.up_proj", bias=False),
            "down_proj": s.linear(f"{pre}.mlp.down_proj", bias=False),
        }
        if s.has(f"{pre}.self_attn.q_norm.weight"):  # qwen3 backbones
            layer["q_norm"] = {"weight": s.take(f"{pre}.self_attn.q_norm.weight")}
            layer["k_norm"] = {"weight": s.take(f"{pre}.self_attn.k_norm.weight")}
        layers.append(layer)
    params = {
        "backbone": {
            "embed_tokens": {"weight": s.take(f"{base}.embed_tokens.weight")},
            "layers": layers,
            "norm": {"weight": s.take(f"{base}.norm.weight")},
        },
        "llm_embedding": {"weight": s.take("llm_embedding.weight")},
        "speech_embedding": {"weight": s.take("speech_embedding.weight")},
        "llm_decoder": s.linear("llm_decoder"),
    }
    s.check_consumed("llm", ignore_prefixes=("llm.model.lm_head", "criterion_ce"))
    return params


# ---------------------------------------------------------------------------
# Flow (flow.pt): CausalMaskedDiffWithXvec
# ---------------------------------------------------------------------------

def _conformer_layer(s: _State, pre: str) -> dict:
    return {
        "self_attn": {
            "linear_q": s.linear(f"{pre}.self_attn.linear_q"),
            "linear_k": s.linear(f"{pre}.self_attn.linear_k"),
            "linear_v": s.linear(f"{pre}.self_attn.linear_v"),
            "linear_out": s.linear(f"{pre}.self_attn.linear_out"),
            "linear_pos": s.linear(f"{pre}.self_attn.linear_pos", bias=False),
            "pos_bias_u": s.take(f"{pre}.self_attn.pos_bias_u"),
            "pos_bias_v": s.take(f"{pre}.self_attn.pos_bias_v"),
        },
        "ffn_w1": s.linear(f"{pre}.feed_forward.w_1"),
        "ffn_w2": s.linear(f"{pre}.feed_forward.w_2"),
        "norm_mha": s.norm(f"{pre}.norm_mha"),
        "norm_ff": s.norm(f"{pre}.norm_ff"),
    }


def _causal_block(s: _State, pre: str) -> dict:
    # CausalBlock1D.block = Sequential(CausalConv1d, Transpose, LayerNorm, Transpose, Mish)
    return {"conv": s.linear(f"{pre}.block.0"), "norm": s.norm(f"{pre}.block.2")}


def _causal_resnet(s: _State, pre: str) -> dict:
    return {
        "block1": _causal_block(s, f"{pre}.block1"),
        "block2": _causal_block(s, f"{pre}.block2"),
        "mlp": s.linear(f"{pre}.mlp.1"),
        "res_conv": s.linear(f"{pre}.res_conv"),
    }


def _transformer_block(s: _State, pre: str) -> dict:
    return {
        "norm1": s.norm(f"{pre}.norm1"),
        "to_q": s.linear(f"{pre}.attn1.to_q", bias=False),
        "to_k": s.linear(f"{pre}.attn1.to_k", bias=False),
        "to_v": s.linear(f"{pre}.attn1.to_v", bias=False),
        "to_out": s.linear(f"{pre}.attn1.to_out.0"),
        "norm3": s.norm(f"{pre}.norm3"),
        "ff_in": s.linear(f"{pre}.ff.net.0.proj"),
        "ff_out": s.linear(f"{pre}.ff.net.2"),
    }


def convert_flow(state: Dict[str, np.ndarray], cfg: FlowConfig) -> dict:
    s = _State(state)
    enc, est = cfg.encoder, cfg.estimator
    dec = "decoder.estimator"

    def stage(pre_resnet, pre_tf, pre_conv=None):
        st = {"resnet": _causal_resnet(s, pre_resnet),
              "transformer": [_transformer_block(s, f"{pre_tf}.{j}")
                              for j in range(est.n_blocks)]}
        if pre_conv is not None:
            st["conv"] = s.linear(pre_conv)
        return st

    params = {
        "input_embedding": {"weight": s.take("input_embedding.weight")},
        "spk_embed_affine_layer": s.linear("spk_embed_affine_layer"),
        "encoder_proj": s.linear("encoder_proj"),
        "encoder": {
            "embed": {"linear": s.linear("encoder.embed.out.0"),
                      "norm": s.norm("encoder.embed.out.1")},
            "pre_lookahead": {"conv1": s.linear("encoder.pre_lookahead_layer.conv1"),
                              "conv2": s.linear("encoder.pre_lookahead_layer.conv2")},
            "encoders": [_conformer_layer(s, f"encoder.encoders.{i}")
                         for i in range(enc.num_blocks)],
            "up_layer": s.linear("encoder.up_layer.conv"),
            "up_embed": {"linear": s.linear("encoder.up_embed.out.0"),
                         "norm": s.norm("encoder.up_embed.out.1")},
            "up_encoders": [_conformer_layer(s, f"encoder.up_encoders.{i}")
                            for i in range(enc.num_up_blocks)],
            "after_norm": s.norm("encoder.after_norm"),
        },
        "estimator": {
            "time_mlp": {"linear_1": s.linear(f"{dec}.time_mlp.linear_1"),
                         "linear_2": s.linear(f"{dec}.time_mlp.linear_2")},
            "down": stage(f"{dec}.down_blocks.0.0", f"{dec}.down_blocks.0.1",
                          f"{dec}.down_blocks.0.2"),
            "mid": [stage(f"{dec}.mid_blocks.{i}.0", f"{dec}.mid_blocks.{i}.1")
                    for i in range(est.num_mid_blocks)],
            "up": stage(f"{dec}.up_blocks.0.0", f"{dec}.up_blocks.0.1", f"{dec}.up_blocks.0.2"),
            "final_block": _causal_block(s, f"{dec}.final_block"),
            "final_proj": s.linear(f"{dec}.final_proj"),
        },
        # the fixed inference noise is rebuilt, not read (as the JAX package)
        "rand_noise": make_rand_noise(cfg.cfm.rand_noise_frames, cfg.output_size).numpy(),
    }
    s.check_consumed("flow", ignore_prefixes=("decoder.rand_noise",))
    return params


# ---------------------------------------------------------------------------
# HiFT (hift.pt): HiFTGenerator, weight-normed convs folded
# ---------------------------------------------------------------------------

def _hift_resblock(s: _State, pre: str, n: int) -> dict:
    return {
        "convs1": [s.wn_conv(f"{pre}.convs1.{i}") for i in range(n)],
        "convs2": [s.wn_conv(f"{pre}.convs2.{i}") for i in range(n)],
        "alpha1": [s.take(f"{pre}.activations1.{i}.alpha") for i in range(n)],
        "alpha2": [s.take(f"{pre}.activations2.{i}.alpha") for i in range(n)],
    }


def convert_hift(state: Dict[str, np.ndarray], cfg: HiFTConfig) -> dict:
    # a GAN-trained checkpoint holds the generator under 'generator.'
    if any(k.startswith("generator.") for k in state):
        state = {k[len("generator."):]: v for k, v in state.items()
                 if k.startswith("generator.")}
    s = _State(state)
    n_ups = len(cfg.upsample_rates)
    num_kernels = len(cfg.resblock_kernel_sizes)
    params = {
        "f0_predictor": {
            "convs": [s.wn_conv(f"f0_predictor.condnet.{2 * i}")
                      for i in range(cfg.f0_predictor.num_layers)],
            "classifier": s.linear("f0_predictor.classifier"),
        },
        "m_source": {"l_linear": s.linear("m_source.l_linear")},
        "conv_pre": s.wn_conv("conv_pre"),
        "ups": [s.wn_conv(f"ups.{i}") for i in range(n_ups)],
        "source_downs": [s.wn_conv(f"source_downs.{i}") for i in range(n_ups)],
        "source_resblocks": [
            _hift_resblock(s, f"source_resblocks.{i}", len(cfg.source_resblock_dilation_sizes[i]))
            for i in range(n_ups)],
        "resblocks": [
            _hift_resblock(s, f"resblocks.{i * num_kernels + j}",
                           len(cfg.resblock_dilation_sizes[j]))
            for i in range(n_ups) for j in range(num_kernels)],
        "conv_post": s.wn_conv("conv_post"),
    }
    s.check_consumed("hift", ignore_prefixes=("stft_window", "m_source.l_sin_gen"))
    return params


def load_reference_checkpoints(model_dir: str, cfg: TTSConfig) -> dict:
    """llm.pt / flow.pt / hift.pt of a CosyVoice2 model dir, converted."""
    return {
        "llm": convert_llm(load_torch_state(os.path.join(model_dir, "llm.pt")), cfg.llm),
        "flow": convert_flow(load_torch_state(os.path.join(model_dir, "flow.pt")), cfg.flow),
        "hift": convert_hift(load_torch_state(os.path.join(model_dir, "hift.pt")), cfg.hift),
    }


# ---------------------------------------------------------------------------
# native checkpoint directories
# ---------------------------------------------------------------------------

NATIVE_TREE_FILE = "tree.pt"


def save_pytree(path: str, tree) -> None:
    """Write ``tree`` (dicts and lists of tensors, numpy arrays, numbers or
    None) as the port's native checkpoint: a directory ``path`` holding one
    ``torch.save`` file of CPU tensors (``NATIVE_TREE_FILE``)."""
    from cosyvoice2_eu_torch.utils.params import tree_map

    def leaf(x):
        if torch.is_tensor(x):
            return x.detach().cpu()
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.array(x))
        return x

    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, NATIVE_TREE_FILE + ".tmp")
    torch.save(tree_map(leaf, tree), tmp)
    os.replace(tmp, os.path.join(path, NATIVE_TREE_FILE))


def load_pytree(path: str, like=None):
    """The tree in the checkpoint directory ``path``: the port's own
    (``save_pytree``) or the JAX package's orbax directory
    (``runtime/orbax_read.py``), told apart by their files; anything else
    raises ``ValueError`` naming what the directory holds.  Leaves come back
    as CPU tensors; with ``like`` each takes the device and dtype of the
    matching leaf of that tree (as ``train/executor.py::_like``)."""
    from cosyvoice2_eu_torch.runtime.orbax_read import is_orbax_dir, read_orbax

    native = os.path.join(path, NATIVE_TREE_FILE)
    if os.path.isfile(native):
        tree = torch.load(native, map_location="cpu", weights_only=True)
    elif is_orbax_dir(path):
        tree = read_orbax(path)
    else:
        held = sorted(os.listdir(path)) if os.path.isdir(path) else None
        raise ValueError(
            f"{path} is neither a native checkpoint directory ({NATIVE_TREE_FILE}) nor an orbax "
            f"one (_METADATA): it holds {held if held is not None else 'nothing (no directory)'}")
    if like is None:
        return tree
    from cosyvoice2_eu_torch.utils.params import tree_map

    return tree_map(lambda t, r: r.to(device=t.device, dtype=t.dtype)
                    if isinstance(t, torch.Tensor) else r, like, tree)
