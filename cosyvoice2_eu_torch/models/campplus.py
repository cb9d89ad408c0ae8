"""CAM++ speaker-embedding network (x-vector extractor), in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/models/campplus.py``, the replacement for
the reference's ``campplus.onnx`` (consumed at
cosy_repo/cosyvoice/cli/frontend.py:276-283).  Topology of the public
3D-Speaker CAM++ design:

  FCM 2-D front-end: conv3x3 + 2 residual stages (2 BasicResBlocks each,
  frequency stride 2) + conv3x3 stride (2,1)  => (B, 32 * feat/8, T)
  -> TDNN stem (k5, time stride 2)
  -> 3 dense-TDNN blocks (12/24/16 layers, growth 32, bottleneck 128,
     dilations 1/2/2), each layer gated by context-aware masking (CAM:
     sigmoid gate from global mean + 100-frame segment pooling of the
     bottleneck activations), transit 1x1 halving channels after each block
  -> BN+ReLU -> stats pooling (mean ++ unbiased std) -> 1x1 dense + BN
  => 192-d embedding.

Input: 80-bin kaldi fbank with per-utterance mean subtraction (CMN), 16 kHz
(``kaldi_fbank_cmn``).  BatchNorm runs in inference form with the JAX
package's arithmetic, x * (w / sqrt(var + eps)) + (b - mean * w / sqrt(...)).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from cosyvoice2_eu_torch.ops.mel import mel_filterbank
from cosyvoice2_eu_torch.ops.stft import frame
from cosyvoice2_eu_torch.utils.params import conv1d, init_conv1d, init_uniform


@dataclasses.dataclass(frozen=True)
class CAMPPlusConfig:
    feat_dim: int = 80
    embedding_size: int = 192
    fcm_channels: int = 32
    fcm_blocks: tuple = (2, 2)
    init_channels: int = 128
    growth_rate: int = 32
    bn_channels: int = 128  # bottleneck inside dense layers (bn_size 4 x growth)
    block_layers: tuple = (12, 24, 16)
    block_dilations: tuple = (1, 2, 2)
    kernel_size: int = 3
    seg_len: int = 100  # CAM segment pooling window


def tiny_campplus_config() -> CAMPPlusConfig:
    return CAMPPlusConfig(
        feat_dim=16, embedding_size=32, fcm_channels=4, fcm_blocks=(1, 1),
        init_channels=16, growth_rate=8, bn_channels=12,
        block_layers=(2, 2), block_dilations=(1, 2), seg_len=8,
    )


def _init_bn(gen, c):
    dev = gen.device
    return {"weight": torch.ones(c, device=dev), "bias": torch.zeros(c, device=dev),
            "mean": torch.zeros(c, device=dev), "var": torch.ones(c, device=dev)}


def _bn(p, x, eps=1e-5):
    """BatchNorm (inference mode) over channel axis 1 of (B, C, ...)."""
    w = p["weight"] / torch.sqrt(p["var"] + eps)
    b = (p["bias"] - p["mean"] * w).to(x.dtype)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return x * w.to(x.dtype).reshape(shape) + b.reshape(shape)


def _init_conv2d(gen, cin, cout, k, bias=False):
    bound = math.sqrt(1.0 / (cin * k * k))
    p = {"weight": init_uniform(gen, (cout, cin, k, k), -bound, bound)}
    if bias:
        p["bias"] = init_uniform(gen, (cout,), -bound, bound)
    return p


def _conv2d(p, x, stride=(1, 1), padding=(1, 1)):
    b = p["bias"].to(x.dtype) if "bias" in p else None
    return F.conv2d(x, p["weight"].to(x.dtype), b, stride=stride, padding=padding)


def _init_resblock(gen, cin, cout, stride):
    p = {
        "conv1": _init_conv2d(gen, cin, cout, 3),
        "bn1": _init_bn(gen, cout),
        "conv2": _init_conv2d(gen, cout, cout, 3),
        "bn2": _init_bn(gen, cout),
    }
    if stride != 1 or cin != cout:
        p["shortcut_conv"] = _init_conv2d(gen, cin, cout, 1)
        p["shortcut_bn"] = _init_bn(gen, cout)
    return p


def _resblock(p, x, stride):
    """BasicResBlock: frequency-strided 3x3 convs + identity/projection."""
    h = F.relu(_bn(p["bn1"], _conv2d(p["conv1"], x, stride=(stride, 1))))
    h = _bn(p["bn2"], _conv2d(p["conv2"], h))
    if "shortcut_conv" in p:
        x = _bn(p["shortcut_bn"],
                _conv2d(p["shortcut_conv"], x, stride=(stride, 1), padding=(0, 0)))
    return F.relu(h + x)


def init_campplus(gen: torch.Generator, cfg: CAMPPlusConfig) -> dict:
    """Random parameters drawn from ``gen`` on its device (the JAX init's
    distributions; BatchNorm at mean 0, var 1, weight 1, bias 0)."""
    fc = cfg.fcm_channels
    head = {
        "conv1": _init_conv2d(gen, 1, fc, 3),
        "bn1": _init_bn(gen, fc),
        "conv2": _init_conv2d(gen, fc, fc, 3),
        "bn2": _init_bn(gen, fc),
    }
    for li, n_blocks in enumerate(cfg.fcm_blocks):
        head[f"layer{li + 1}"] = [_init_resblock(gen, fc, fc, 2 if bi == 0 else 1)
                                  for bi in range(n_blocks)]
    params = {"head": head}

    stem_in = fc * (cfg.feat_dim // (2 ** (len(cfg.fcm_blocks) + 1)))
    params["tdnn"] = {
        "linear": init_conv1d(gen, stem_in, cfg.init_channels, 5, bias=False),
        "bn": _init_bn(gen, cfg.init_channels),
    }
    channels = cfg.init_channels
    blocks, transits = [], []
    for n_layers in cfg.block_layers:
        layers = []
        for _ in range(n_layers):
            layers.append({
                "bn1": _init_bn(gen, channels),
                "lin1": init_conv1d(gen, channels, cfg.bn_channels, 1, bias=False),
                "bn2": _init_bn(gen, cfg.bn_channels),
                # CAMLayer: local conv + sigmoid gate from context
                "local": init_conv1d(gen, cfg.bn_channels, cfg.growth_rate, cfg.kernel_size,
                                     bias=False),
                "gate1": init_conv1d(gen, cfg.bn_channels, cfg.bn_channels // 2, 1),
                "gate2": init_conv1d(gen, cfg.bn_channels // 2, cfg.growth_rate, 1),
            })
            channels += cfg.growth_rate
        blocks.append({"layers": layers})
        transits.append({
            "bn": _init_bn(gen, channels),
            "lin": init_conv1d(gen, channels, channels // 2, 1, bias=False),
        })
        channels //= 2
    params["blocks"] = blocks
    params["transits"] = transits
    params["out_bn"] = _init_bn(gen, channels)
    params["dense"] = {
        "lin": init_conv1d(gen, channels * 2, cfg.embedding_size, 1, bias=False),
        "bn": _init_bn(gen, cfg.embedding_size),
    }
    return params


def _seg_pool(x: torch.Tensor, seg: int) -> torch.Tensor:
    """avg_pool1d(k=seg, s=seg, ceil_mode) then nearest-expand back to T.

    The partial tail segment averages over its true length (torch avg_pool
    divides by the window's overlap with the input when ceil_mode clips)."""
    b, c, t = x.shape
    xp = F.pad(x, (0, (-t) % seg))
    sums = xp.reshape(b, c, -1, seg).sum(dim=3)
    starts = torch.arange(sums.shape[2], device=x.device) * seg
    counts = torch.clamp(starts + seg, max=t) - starts
    means = sums / counts.to(x.dtype)
    return torch.repeat_interleave(means, seg, dim=2)[:, :, :t]


def _cam_layer(lp, cfg: CAMPPlusConfig, h: torch.Tensor, dilation: int) -> torch.Tensor:
    """CAMLayer: local conv gated by context computed from the INPUT h."""
    pad = dilation * (cfg.kernel_size - 1) // 2
    y = conv1d(lp["local"], h, padding=pad, dilation=dilation)
    context = h.mean(dim=2, keepdim=True) + _seg_pool(h, cfg.seg_len)
    m = torch.sigmoid(conv1d(lp["gate2"], F.relu(conv1d(lp["gate1"], context))))
    return y * m


def campplus_forward(params: dict, cfg: CAMPPlusConfig, fbank: torch.Tensor) -> torch.Tensor:
    """fbank (B, T, feat_dim), already CMN-normalized -> (B, embedding_size)."""
    x = fbank.transpose(1, 2)[:, None]  # (B, 1, F, T)
    head = params["head"]
    x = F.relu(_bn(head["bn1"], _conv2d(head["conv1"], x)))
    for li in range(len(cfg.fcm_blocks)):
        for bi, bp in enumerate(head[f"layer{li + 1}"]):
            x = _resblock(bp, x, stride=2 if bi == 0 else 1)
    x = F.relu(_bn(head["bn2"], _conv2d(head["conv2"], x, stride=(2, 1))))
    b, c, fr, t = x.shape
    x = x.reshape(b, c * fr, t)

    x = conv1d(params["tdnn"]["linear"], x, stride=2, padding=2)
    x = F.relu(_bn(params["tdnn"]["bn"], x))

    for blk, transit, dil in zip(params["blocks"], params["transits"], cfg.block_dilations):
        for lp in blk["layers"]:
            h = F.relu(_bn(lp["bn1"], x))
            h = conv1d(lp["lin1"], h)
            h = F.relu(_bn(lp["bn2"], h))
            h = _cam_layer(lp, cfg, h, dil)
            x = torch.cat([x, h], dim=1)  # dense connection
        x = conv1d(transit["lin"], F.relu(_bn(transit["bn"], x)))

    x = F.relu(_bn(params["out_bn"], x))
    mean = x.mean(dim=2)
    n = x.shape[2]
    var = x.var(dim=2, unbiased=False) * (n / max(n - 1, 1))  # torch std: unbiased
    stats = torch.cat([mean, torch.sqrt(torch.clamp(var, min=1e-12))], dim=1)
    emb = conv1d(params["dense"]["lin"], stats[..., None])
    return _bn(params["dense"]["bn"], emb)[..., 0]


def kaldi_fbank_cmn(wav_16k: torch.Tensor, num_mel_bins: int = 80) -> torch.Tensor:
    """Kaldi-style log-mel fbank (25 ms / 10 ms, povey window, dither off)
    with utterance CMN: the CAM++ input features (reference
    frontend.py:276-283).  wav (B, T) -> (B, frames, bins)."""
    sr, win, hop, pad_to = 16000, 400, 160, 512
    x = wav_16k * 32768.0  # kaldi int16 scaling
    frames = frame(x, win, hop)
    frames = frames - frames.mean(dim=-1, keepdim=True)  # remove DC
    # povey window = hann over win - 1, to the power 0.85
    n = np.arange(win)
    w = (0.5 - 0.5 * np.cos(2 * np.pi * n / (win - 1))) ** 0.85
    frames = frames * torch.as_tensor(w, device=x.device, dtype=x.dtype)
    frames = F.pad(frames, (0, pad_to - win))
    spec = torch.fft.rfft(frames, dim=-1).abs() ** 2
    basis = torch.as_tensor(
        mel_filterbank(sr, pad_to, num_mel_bins, fmin=20.0, htk=True, norm=None),
        device=x.device, dtype=x.dtype)
    mel = torch.einsum("mf,btf->btm", basis, spec)
    logmel = torch.log(torch.clamp(mel, min=1.19209290e-07))
    return logmel - logmel.mean(dim=1, keepdim=True)  # CMN
