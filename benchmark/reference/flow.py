"""Frozen copy of the port's ``cosyvoice2_eu_torch/models/flow.py`` (plain
PyTorch, no kernel), for the benchmark's reference: it imports nothing of
the port, and a later change to the port does not change it."""

from __future__ import annotations

import numpy as np
import torch

from .encoder import upsample_conformer_forward
from .estimator import estimator_forward
from .masks import make_non_pad_mask
from .layers import dense, embedding


def cosine_t_span(n_timesteps: int) -> np.ndarray:
    t = np.linspace(0.0, 1.0, n_timesteps + 1, dtype=np.float32)
    return 1.0 - np.cos(t * 0.5 * np.pi)


def solve_euler_cfg(params: dict, cfg, z, mu, mask, spks, cond,
                    streaming: bool = False) -> torch.Tensor:
    """Fixed-step Euler ODE solve with batch-2 classifier-free guidance.

    z/mu/cond: (B, 80, T); mask: (B, 1, T); spks: (B, 80).
    """
    b = z.shape[0]
    t_span = cosine_t_span(cfg.cfm.n_timesteps)
    rate = cfg.cfm.inference_cfg_rate

    # CFG double batch: [cond | uncond]; uncond zeroes mu/spks/cond
    mu_in = torch.cat([mu, torch.zeros_like(mu)], dim=0)
    spks_in = torch.cat([spks, torch.zeros_like(spks)], dim=0)
    cond_in = torch.cat([cond, torch.zeros_like(cond)], dim=0)
    mask_in = torch.cat([mask, mask], dim=0)

    t_curs = torch.as_tensor(t_span[:-1]).to(z.dtype)
    dts = torch.as_tensor(t_span[1:] - t_span[:-1]).to(z.dtype)
    x = z
    for t_cur, dt in zip(t_curs, dts):
        x_in = torch.cat([x, x], dim=0)
        t_in = torch.full((2 * b,), float(t_cur), dtype=x.dtype, device=x.device)
        dphi = estimator_forward(
            params["estimator"], cfg.estimator, x_in, mask_in, mu_in, t_in, spks_in, cond_in,
            streaming=streaming,
        )
        dphi_c, dphi_u = dphi[:b], dphi[b:]
        v = (1.0 + rate) * dphi_c - rate * dphi_u
        x = (x + dt.to(x.device) * v).to(z.dtype)
    return x


def flow_inference(
    params: dict,
    cfg,
    token: torch.Tensor,
    token_len: torch.Tensor,
    prompt_feat: torch.Tensor,
    prompt_feat_len: torch.Tensor,
    embedding_vec: torch.Tensor,
    streaming: bool = False,
    finalize: bool = True,
) -> torch.Tensor:
    """Generate mel for (prompt + new) speech tokens.

    token: (B, T_tok) right-padded; token_len: (B,); prompt_feat:
    (B, T_mel_max, 80); embedding_vec: (B, 192) raw x-vector.  finalize=False
    feeds the last pre_lookahead_len tokens as encoder right-context.
    Returns mel (B, 80, T_tok * ratio), float32.
    """
    b, t_tok = token.shape
    ratio = cfg.token_mel_ratio
    dtype = params["input_embedding"]["weight"].dtype  # compute dtype follows the params
    dev = token.device

    spk = embedding_vec / torch.linalg.norm(embedding_vec, dim=1, keepdim=True).clamp_min(1e-12)
    spk = dense(params["spk_embed_affine_layer"], spk.to(dtype))

    tok_mask = make_non_pad_mask(token_len, t_tok)[..., None].to(dtype)
    h_tok = embedding(params["input_embedding"], token.clamp_min(0)).to(dtype) * tok_mask

    if finalize:
        h, _ = upsample_conformer_forward(
            params["encoder"], cfg.encoder, h_tok, token_len, streaming=streaming)
    else:
        la = cfg.pre_lookahead_len
        h, _ = upsample_conformer_forward(
            params["encoder"], cfg.encoder, h_tok[:, :-la], token_len - la,
            context=h_tok[:, -la:], streaming=streaming)
        t_tok = t_tok - la
    h = dense(params["encoder_proj"], h)  # (B, T_mel, 80)

    t_mel = t_tok * ratio
    mel_len = token_len * ratio if finalize else (token_len - cfg.pre_lookahead_len) * ratio

    # conds: prompt mel in front, zeros after
    frame_idx = torch.arange(t_mel, device=dev)[None, :, None]
    if prompt_feat.shape[1] >= t_mel:
        pf = prompt_feat[:, :t_mel]
    else:
        pf = torch.nn.functional.pad(prompt_feat, (0, 0, 0, t_mel - prompt_feat.shape[1]))
    conds = torch.where(frame_idx < prompt_feat_len[:, None, None], pf, torch.zeros_like(pf))
    conds = conds.transpose(1, 2).to(h.dtype)  # (B, 80, T_mel)

    mask = make_non_pad_mask(mel_len, t_mel)[:, None].to(h.dtype)  # (B,1,T)
    mu = h.transpose(1, 2) * mask

    noise = params["rand_noise"][:, :, :t_mel].to(h.dtype)
    z = noise.expand(b, cfg.output_size, t_mel) * 1.0

    mel = solve_euler_cfg(params, cfg, z, mu, mask, spk, conds, streaming=streaming)
    return mel.float()
