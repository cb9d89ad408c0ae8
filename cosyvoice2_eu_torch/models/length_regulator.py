"""InterpolateRegulator of the v1 flow: linear time resampling + a smoothing conv stack.

Counterpart of ``cosyvoice2_eu_tpu/models/length_regulator.py``.  The v1
flow stretches the encoder output (one vector per 50 Hz speech token) to the
mel frame rate by 1-D linear interpolation, then smooths it with
[Conv1d(k3) -> GroupNorm -> Mish] blocks and a 1x1 projection.  Inference
interpolates the prompt and the generated head / middle / tail apart, so the
prompt/generation boundary and the chunk edges land on whole frames.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cosyvoice2_eu_torch.config import LengthRegulatorConfig
from cosyvoice2_eu_torch.utils.params import conv1d, group_norm, init_conv1d, init_group_norm


def _mish(x):
    return x * torch.tanh(F.softplus(x))


def linear_interpolate(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Linear interpolation (align_corners=False) over the last axis, with
    the JAX function's float32 positions and clamps.  x: (B, C, T) ->
    (B, C, out_len)."""
    t_in = x.shape[-1]
    if out_len == 0:
        return x[..., :0]
    scale = t_in / out_len
    pos = (torch.arange(out_len, dtype=torch.float32, device=x.device) + 0.5) * scale - 0.5
    pos = pos.clamp(0.0, t_in - 1)
    lo = torch.floor(pos).long()
    hi = (lo + 1).clamp_max(t_in - 1)
    w = (pos - lo.float()).to(x.dtype)
    return x[..., lo] * (1.0 - w) + x[..., hi] * w


def init_length_regulator(gen, cfg: LengthRegulatorConfig) -> dict:
    blocks = [{"conv": init_conv1d(gen, cfg.channels, cfg.channels, 3),
               "norm": init_group_norm(gen, cfg.channels)}
              for _ in cfg.sampling_ratios]
    return {"blocks": blocks, "proj": init_conv1d(gen, cfg.channels, cfg.channels, 1)}


def _conv_stack(params: dict, cfg: LengthRegulatorConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, C, T)."""
    for bp in params["blocks"]:
        x = _mish(group_norm(bp["norm"], conv1d(bp["conv"], x, padding=1), cfg.groups))
    return conv1d(params["proj"], x)


def length_regulator_forward(params: dict, cfg: LengthRegulatorConfig, x: torch.Tensor,
                             out_len: int, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Training path.  x: (B, T, C) -> (B, out_len, C); mask: (B, out_len) bool or None."""
    out = _conv_stack(params, cfg, linear_interpolate(x.transpose(1, 2), out_len)).transpose(1, 2)
    if mask is not None:
        out = out * mask[..., None].to(out.dtype)
    return out


def length_regulator_inference(params: dict, cfg: LengthRegulatorConfig, x1: torch.Tensor,
                               x2: torch.Tensor, mel_len1: int, mel_len2: int,
                               input_frame_rate: int = 50, sample_rate: int = 22050,
                               mel_hop: int = 256) -> torch.Tensor:
    """Inference path.  x1: (B, T1, C) prompt-token vectors, x2: (B, T2, C)
    generated ones; past 40 generated tokens the first and last 20 are
    interpolated apart (20 = the streaming token overlap).  Returns
    (B, mel_len1 + mel_len2, C)."""
    x2 = x2.transpose(1, 2)
    if x2.shape[-1] > 40:
        edge = int(20 / input_frame_rate * sample_rate / mel_hop)
        x2 = torch.cat([linear_interpolate(x2[..., :20], edge),
                        linear_interpolate(x2[..., 20:-20], mel_len2 - 2 * edge),
                        linear_interpolate(x2[..., -20:], edge)], dim=-1)
    else:
        x2 = linear_interpolate(x2, mel_len2)
    h = (torch.cat([linear_interpolate(x1.transpose(1, 2), mel_len1), x2], dim=-1)
         if x1.shape[1] != 0 else x2)
    return _conv_stack(params, cfg, h).transpose(1, 2)
