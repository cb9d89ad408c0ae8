"""v1 reference checkpoints (torch ``.pt`` state dicts) -> the port's parameter trees.

Counterpart of ``cosyvoice2_eu_tpu/runtime/checkpoint_v1.py``: maps the
CosyVoice-300M ``llm.pt`` (TransformerLM) and ``flow.pt``
(MaskedDiffWithXvec with its InterpolateRegulator and ConditionalDecoder)
onto the trees of ``models/llm_v1.py`` and ``models/flow_v1.py``, as numpy
trees.  ``hift.pt`` is the v2 vocoder's layout at 22.05 kHz and goes through
``runtime/checkpoint.py::convert_hift``.  As the port's v2 converters do, a
key that no converter maps raises ``ValueError``; the positional tables the
reference may keep beside its weights are rebuilt, not read.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from cosyvoice2_eu_torch.config import (
    EstimatorV1Config,
    FlowV1Config,
    LengthRegulatorConfig,
    LMV1Config,
)
from cosyvoice2_eu_torch.models.generic_encoder import convert_generic_encoder
from cosyvoice2_eu_torch.runtime.checkpoint import _State

# buffers a reference module may carry that no parameter of the port holds
_IGNORED = (".pos_enc.pe", "num_batches_tracked")


def _sub_state(state: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    p = prefix + "."
    return {k[len(p):]: v for k, v in state.items() if k.startswith(p)}


def _encoder(state, prefix: str, cfg) -> dict:
    """One generic encoder under ``prefix``; its keys must all be taken."""
    s = _State(_sub_state(state, prefix))
    out = convert_generic_encoder(s, cfg)
    leftover = [k for k in s.state if k not in s.used and not any(i in k for i in _IGNORED)]
    if leftover:
        raise ValueError(f"unmapped {prefix} keys: {leftover[:8]}")
    return out


def _check_top(s: _State, what: str, encoders) -> None:
    """Every key outside the encoders' prefixes was taken."""
    s.check_consumed(what, ignore_prefixes=tuple(p + "." for p in encoders))


def convert_llm_v1(state: Dict[str, np.ndarray], cfg: LMV1Config) -> dict:
    """llm.pt (TransformerLM) -> the ``init_lm_v1`` tree."""
    s = _State(state)
    out = {
        "text_embedding": {"weight": s.take("text_embedding.weight")},
        "text_encoder": _encoder(state, "text_encoder", cfg.text_encoder),
        "text_encoder_affine_layer": s.linear("text_encoder_affine_layer"),
        "llm_embedding": {"weight": s.take("llm_embedding.weight")},
        "speech_embedding": {"weight": s.take("speech_embedding.weight")},
        "spk_embed_affine_layer": s.linear("spk_embed_affine_layer"),
        "llm": _encoder(state, "llm", cfg.llm),
        "llm_decoder": s.linear("llm_decoder"),
    }
    _check_top(s, "llm", ("text_encoder", "llm"))
    return out


def _block1d(s: _State, pre: str) -> dict:
    # Block1D: .block.0 Conv1d, .block.1 GroupNorm
    return {"conv": s.linear(f"{pre}.block.0"), "norm": s.norm(f"{pre}.block.1")}


def _resnet1d(s: _State, pre: str) -> dict:
    # ResnetBlock1D: mlp = Sequential(Mish, Linear)
    return {"block1": _block1d(s, f"{pre}.block1"), "block2": _block1d(s, f"{pre}.block2"),
            "mlp": s.linear(f"{pre}.mlp.1"), "res_conv": s.linear(f"{pre}.res_conv")}


def _basic_transformer(s: _State, pre: str) -> dict:
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


def _updown_conv(s: _State, pre: str) -> dict:
    """Downsample1D / Upsample1D hold their conv under ``.conv``; the last
    stage's plain Conv1d holds its weights directly."""
    return s.linear(f"{pre}.conv") if s.has(f"{pre}.conv.weight") else s.linear(pre)


def convert_estimator_v1(state: Dict[str, np.ndarray], cfg: EstimatorV1Config,
                         prefix: str = "") -> dict:
    """The ConditionalDecoder's keys (under ``prefix``) -> the ``init_estimator_v1`` tree."""
    s = state if isinstance(state, _State) else _State(state)
    p = prefix + "." if prefix else ""

    def stage(pre: str) -> dict:
        return {"resnet": _resnet1d(s, f"{pre}.0"),
                "transformer": [_basic_transformer(s, f"{pre}.1.{j}")
                                for j in range(cfg.n_blocks)]}

    def updown(kind: str) -> list:
        out = []
        for i in range(len(cfg.channels)):
            st = stage(f"{p}{kind}_blocks.{i}")
            st["conv"] = _updown_conv(s, f"{p}{kind}_blocks.{i}.2")
            out.append(st)
        return out

    return {
        "time_mlp": {"linear_1": s.linear(f"{p}time_mlp.linear_1"),
                     "linear_2": s.linear(f"{p}time_mlp.linear_2")},
        "down": updown("down"),
        "mid": [stage(f"{p}mid_blocks.{i}") for i in range(cfg.num_mid_blocks)],
        "up": updown("up"),
        "final_block": _block1d(s, f"{p}final_block"),
        "final_proj": s.linear(f"{p}final_proj"),
    }


def convert_length_regulator(state: Dict[str, np.ndarray], cfg: LengthRegulatorConfig,
                             prefix: str = "") -> dict:
    """InterpolateRegulator.model = Sequential([Conv1d, GroupNorm, Mish] x n
    ++ [Conv1d 1x1]) -> the ``init_length_regulator`` tree."""
    s = state if isinstance(state, _State) else _State(state)
    p = prefix + "." if prefix else ""
    n = len(cfg.sampling_ratios)
    blocks = [{"conv": s.linear(f"{p}model.{3 * i}"), "norm": s.norm(f"{p}model.{3 * i + 1}")}
              for i in range(n)]
    return {"blocks": blocks, "proj": s.linear(f"{p}model.{3 * n}")}


def convert_flow_v1(state: Dict[str, np.ndarray], cfg: FlowV1Config) -> dict:
    """flow.pt (MaskedDiffWithXvec) -> the ``init_flow_v1`` tree."""
    s = _State(state)
    out = {
        "input_embedding": {"weight": s.take("input_embedding.weight")},
        "spk_embed_affine_layer": s.linear("spk_embed_affine_layer"),
        "encoder": _encoder(state, "encoder", cfg.encoder),
        "encoder_proj": s.linear("encoder_proj"),
        "length_regulator": convert_length_regulator(s, cfg.length_regulator,
                                                     "length_regulator"),
        "estimator": convert_estimator_v1(s, cfg.estimator, "decoder.estimator"),
    }
    _check_top(s, "flow", ("encoder",))
    return out
