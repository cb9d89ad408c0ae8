"""Non-causal multi-scale 1-D U-Net velocity estimator of the v1 flow, in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/models/estimator_v1.py`` (the reference's
ConditionalDecoder): channel concat [x, mu, spks, cond]; down stages with a
stride-2 conv between them, mid stages at half resolution, up stages with a
transpose conv and skip connections; Block1D is conv3 / GroupNorm(8) / Mish
with zero padding (non-causal).  Every stage's transformer blocks are the v2
estimator's ``transformer_block`` with full attention over the valid frames:
on a CUDA tensor each launches kernel K1 (the fp32 design when the model
runs in fp32, as v1 does), on a CPU tensor the plain masked softmax.  With
the published channels (256, 256), 12 mid stages and 4 blocks a stage, one
call launches K1 64 times: 8 at the mel length T, 56 at ceil(T / 2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cosyvoice2_eu_torch.config import EstimatorV1Config
from cosyvoice2_eu_torch.models.estimator import (
    _mish,
    init_transformer_block,
    sinusoidal_time_emb,
    transformer_block,
)
from cosyvoice2_eu_torch.utils.params import (
    conv1d,
    conv_transpose1d,
    dense,
    group_norm,
    init_conv1d,
    init_conv_transpose1d,
    init_dense,
    init_group_norm,
)


def init_block1d(gen, dim, dim_out):
    return {"conv": init_conv1d(gen, dim, dim_out, 3), "norm": init_group_norm(gen, dim_out)}


def block1d(p, x, mask, groups: int = 8):
    """x: (B, C, T); mask: (B, 1, T)."""
    h = conv1d(p["conv"], x * mask, padding=1)
    return _mish(group_norm(p["norm"], h, groups)) * mask


def init_resnet1d(gen, dim, dim_out, time_dim):
    return {
        "block1": init_block1d(gen, dim, dim_out),
        "block2": init_block1d(gen, dim_out, dim_out),
        "mlp": init_dense(gen, time_dim, dim_out),
        "res_conv": init_conv1d(gen, dim, dim_out, 1),
    }


def resnet1d(p, x, mask, temb):
    h = block1d(p["block1"], x, mask)
    h = h + dense(p["mlp"], _mish(temb))[:, :, None]
    h = block1d(p["block2"], h, mask)
    return h + conv1d(p["res_conv"], x * mask)


def k1_launches_per_call(cfg: EstimatorV1Config) -> int:
    """K1 launches of one estimator call: one per transformer block."""
    return cfg.n_blocks * (2 * len(cfg.channels) + cfg.num_mid_blocks)


def init_estimator_v1(gen, cfg: EstimatorV1Config) -> dict:
    time_dim = cfg.channels[0] * 4

    def stage(dim_in, dim_out):
        return {
            "resnet": init_resnet1d(gen, dim_in, dim_out, time_dim),
            "transformer": [init_transformer_block(gen, dim_out, cfg.num_heads,
                                                   cfg.attention_head_dim)
                            for _ in range(cfg.n_blocks)],
        }

    down, out_ch = [], cfg.in_channels
    for ch in cfg.channels:
        s = stage(out_ch, ch)
        # stride 2 between down stages, 1 after the last (applied at call time)
        s["conv"] = init_conv1d(gen, ch, ch, 3)
        down.append(s)
        out_ch = ch
    mid = [stage(cfg.channels[-1], cfg.channels[-1]) for _ in range(cfg.num_mid_blocks)]
    up, rev = [], tuple(reversed(cfg.channels)) + (cfg.channels[0],)
    for i in range(len(rev) - 1):
        s = stage(rev[i] * 2, rev[i + 1])
        s["conv"] = (init_conv1d(gen, rev[i + 1], rev[i + 1], 3) if i == len(rev) - 2
                     else init_conv_transpose1d(gen, rev[i + 1], rev[i + 1], 4))
        up.append(s)
    return {
        "time_mlp": {"linear_1": init_dense(gen, cfg.in_channels, time_dim),
                     "linear_2": init_dense(gen, time_dim, time_dim)},
        "down": down,
        "mid": mid,
        "up": up,
        "final_block": init_block1d(gen, rev[-1], rev[-1]),
        "final_proj": init_conv1d(gen, rev[-1], cfg.out_channels, 1),
    }


def estimator_v1_forward(params: dict, cfg: EstimatorV1Config, x: torch.Tensor,
                         mask: torch.Tensor, mu: torch.Tensor, t: torch.Tensor,
                         spks: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """Predict velocity.  x/mu/cond: (B, 80, T); mask: (B, 1, T); t: (B,); spks: (B, 80)."""
    b, _, T = x.shape
    temb = sinusoidal_time_emb(t, cfg.in_channels, cfg.time_embed_scale).to(x.dtype)
    temb = dense(params["time_mlp"]["linear_1"], temb)
    temb = dense(params["time_mlp"]["linear_2"], F.silu(temb))
    h = torch.cat([x, mu, spks[:, :, None].expand(b, spks.shape[1], T), cond], dim=1)

    def run_blocks(sp, h, m):
        h = resnet1d(sp["resnet"], h, m, temb)
        lengths = m[:, 0].to(torch.int32).sum(-1, dtype=torch.int32)
        ht = h.transpose(1, 2)
        for tp in sp["transformer"]:
            ht = transformer_block(tp, ht, (lengths, 0), cfg.num_heads)
        return ht.transpose(1, 2)

    # down path: the skip is taken before the downsample
    hiddens, masks = [], [mask]
    for i, sp in enumerate(params["down"]):
        m = masks[-1]
        h = run_blocks(sp, h, m)
        hiddens.append(h)
        last = i == len(params["down"]) - 1
        h = conv1d(sp["conv"], h * m, padding=1, stride=1 if last else 2)
        masks.append(m[:, :, ::2])
    masks = masks[:-1]
    for sp in params["mid"]:
        h = run_blocks(sp, h, masks[-1])
    for i, sp in enumerate(params["up"]):
        m = masks.pop()
        skip = hiddens.pop()
        h = torch.cat([h[:, :, :skip.shape[-1]], skip], dim=1)
        h = run_blocks(sp, h, m)
        if i == len(params["up"]) - 1:
            h = conv1d(sp["conv"], h * m, padding=1)
        else:
            h = conv_transpose1d(sp["conv"], h * m, stride=2, padding=1)
        m_up = m
    h = block1d(params["final_block"], h, m_up)
    return conv1d(params["final_proj"], h * m_up) * mask
