"""Name registries: yaml-style component names -> implementations, in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/registry.py`` (the reference's
class_utils.py tables): ``ACTIVATIONS`` maps a name to a torch activation,
``SUBSAMPLE_KINDS`` / ``POS_ENC_KINDS`` / ``ATTENTION_KINDS`` hold the legal
names of ``GenericEncoderConfig``'s input layer, positional encoding and
attention (each with the reference class it stands for),
``get_scheduler`` resolves a learning-rate schedule of ``train/optim.py``,
and ``get_model_type`` tells the model family of a config.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

ACTIVATIONS: Dict[str, Callable] = {
    "hardtanh": F.hardtanh,
    "tanh": torch.tanh,
    "relu": F.relu,
    "selu": F.selu,
    "swish": F.silu,
    "gelu": F.gelu,  # erf-exact, as torch.nn.GELU
}


def get_activation(name: str) -> Callable:
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise KeyError(f"unknown activation {name!r}; known: {sorted(ACTIVATIONS)}") from None


SUBSAMPLE_KINDS: Dict[str, str] = {
    "linear": "LinearNoSubsampling",
    "linear_legacy": "LegacyLinearNoSubsampling",
    "embed": "EmbedinigNoSubsampling",
    "conv1d2": "Conv1dSubsampling2",
    "conv2d": "Conv2dSubsampling4",
    "conv2d6": "Conv2dSubsampling6",
    "conv2d8": "Conv2dSubsampling8",
}

POS_ENC_KINDS: Dict[str, str] = {
    "embed": "PositionalEncoding",
    "abs_pos": "PositionalEncoding",
    "rel_pos": "RelPositionalEncoding",
    "rel_pos_espnet": "EspnetRelPositionalEncoding",
    "no_pos": "NoPositionalEncoding",
    "abs_pos_whisper": "WhisperPositionalEncoding",
    "embed_learnable_pe": "LearnablePositionalEncoding",
}

ATTENTION_KINDS: Dict[str, str] = {
    "selfattn": "MultiHeadedAttention",
    "rel_selfattn": "RelPositionMultiHeadedAttention",
}


def validate_encoder_names(cfg) -> None:
    """Raise ``KeyError`` with the legal table on an unknown component name."""
    for field, table in (("input_layer", SUBSAMPLE_KINDS),
                         ("pos_enc_layer_type", POS_ENC_KINDS),
                         ("selfattention_layer_type", ATTENTION_KINDS)):
        name = getattr(cfg, field)
        if name not in table:
            raise KeyError(f"unknown {field} {name!r}; known: {sorted(table)}")
    get_activation(cfg.activation_type)


def _schedulers() -> dict:
    from cosyvoice2_eu_torch.train import optim

    return {"warmuplr": optim.warmup_lr, "constantlr": optim.constant_lr,
            "noamhold": optim.noam_hold_annealing}


def get_scheduler(name: str) -> Callable:
    table = _schedulers()
    try:
        return table[name]
    except KeyError:
        raise KeyError(f"unknown scheduler {name!r}; known: {sorted(table)}") from None


def get_model_type(cfg) -> str:
    """A config -> "cosyvoice2" (the flow upsamples tokens, token_mel_ratio
    >= 2) or "cosyvoice1" (tokens map 1:1 and a length regulator stretches
    them); anything else raises ``TypeError``."""
    flow = cfg.flow
    ratio = getattr(flow, "token_mel_ratio", None)
    if ratio is not None and ratio >= 2:
        return "cosyvoice2"
    if ratio == 1 or hasattr(flow, "length_regulator"):
        return "cosyvoice1"
    raise TypeError("No valid model type found for this config combination")
