"""The v1 flow (MaskedDiffWithXvec): speech tokens -> mel through a length regulator, in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/models/flow_v1.py``: tokens pass 1:1
through the plain conformer encoder (``models/generic_encoder.py``), the
InterpolateRegulator stretches them to the 22.05 kHz / 256-hop mel length,
and the non-causal U-Net (``models/estimator_v1.py``) runs the batch-2
classifier-free-guidance Euler solve.  Streaming continuity is the
reference's z/mu flow cache: the prompt's frames and the last
``cfg.cache_tail`` frames of a chunk are pinned into the next one.

The noise ``z`` is an input (the JAX function draws it from a key); without
one it is drawn from a ``torch.Generator``.  ``flow_v1_loss`` takes its
draws as a dict, as the v2 training step does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cosyvoice2_eu_torch.config import FlowV1Config
from cosyvoice2_eu_torch.models.estimator_v1 import estimator_v1_forward, init_estimator_v1
from cosyvoice2_eu_torch.models.flow import cosine_t_span
from cosyvoice2_eu_torch.models.generic_encoder import (
    generic_encoder_forward,
    init_generic_encoder,
)
from cosyvoice2_eu_torch.models.length_regulator import (
    init_length_regulator,
    length_regulator_forward,
    length_regulator_inference,
)
from cosyvoice2_eu_torch.ops.masks import make_non_pad_mask
from cosyvoice2_eu_torch.utils.params import dense, embedding, init_dense, init_embedding


def init_flow_v1(gen, cfg: FlowV1Config) -> dict:
    return {
        "input_embedding": init_embedding(gen, cfg.vocab_size, cfg.input_size),
        "spk_embed_affine_layer": init_dense(gen, cfg.spk_embed_dim, cfg.output_size),
        "encoder": init_generic_encoder(gen, cfg.encoder),
        "encoder_proj": init_dense(gen, cfg.encoder.output_size, cfg.output_size),
        "length_regulator": init_length_regulator(gen, cfg.length_regulator),
        "estimator": init_estimator_v1(gen, cfg.estimator),
    }


def mel_len_for_tokens(cfg: FlowV1Config, n_tokens: int) -> int:
    """Mel frames of ``n_tokens`` generated tokens (truncated)."""
    return int(n_tokens / cfg.input_frame_rate * cfg.sample_rate / cfg.mel_hop)


def _normalized_spk(params, emb: torch.Tensor) -> torch.Tensor:
    emb = emb.float()
    emb = emb / torch.linalg.norm(emb, dim=1, keepdim=True).clamp_min(1e-12)
    return dense(params["spk_embed_affine_layer"], emb)


def _encode_tokens(params, cfg: FlowV1Config, token, token_len):
    """Input embedding -> conformer -> projection to the mel width."""
    mask = make_non_pad_mask(token_len, token.shape[1])[..., None].float()
    emb = embedding(params["input_embedding"], token.clamp_min(0)) * mask
    h, _ = generic_encoder_forward(params["encoder"], cfg.encoder, emb, token_len)
    return dense(params["encoder_proj"], h)


def _solve_euler_cfg_v1(params, cfg: FlowV1Config, z, mu, mask, spks, cond):
    """Batch-2 CFG Euler solve on the v1 estimator (``cfg.cfm.n_timesteps`` calls)."""
    b = z.shape[0]
    t_span = cosine_t_span(cfg.cfm.n_timesteps)
    rate = cfg.cfm.inference_cfg_rate
    mu_in = torch.cat([mu, torch.zeros_like(mu)], dim=0)
    spks_in = torch.cat([spks, torch.zeros_like(spks)], dim=0)
    cond_in = torch.cat([cond, torch.zeros_like(cond)], dim=0)
    mask_in = torch.cat([mask, mask], dim=0)
    t_curs = torch.as_tensor(t_span[:-1]).to(z.dtype)
    dts = torch.as_tensor(t_span[1:] - t_span[:-1]).to(z.dtype)
    x = z
    for t_cur, dt in zip(t_curs, dts):
        t_in = torch.full((2 * b,), float(t_cur), dtype=x.dtype, device=x.device)
        dphi = estimator_v1_forward(params["estimator"], cfg.estimator, torch.cat([x, x], dim=0),
                                    mask_in, mu_in, t_in, spks_in, cond_in)
        v = (1.0 + rate) * dphi[:b] - rate * dphi[b:]
        x = (x + dt.to(x.device) * v).to(z.dtype)
    return x


def flow_v1_inference(
    params: dict,
    cfg: FlowV1Config,
    token: torch.Tensor,
    prompt_token: torch.Tensor,
    prompt_feat: torch.Tensor,
    emb: torch.Tensor,
    flow_cache: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch 1.  token: (1, T2) generated speech tokens; prompt_token:
    (1, T1); prompt_feat: (1, mel_len1, 80); emb: (1, spk_embed_dim);
    flow_cache: (1, 80, cache_t, 2), the z and mu pinned by the previous
    chunk; z: (1, 80, mel_len1 + mel_len2) noise, drawn from ``generator``
    when None.  Returns (mel (1, 80, mel_len2), new flow_cache)."""
    dev = token.device
    t1, t2 = prompt_token.shape[1], token.shape[1]
    spks = _normalized_spk(params, emb.to(dev))
    both = torch.cat([prompt_token, token], dim=1)
    h = _encode_tokens(params, cfg, both, torch.tensor([t1 + t2], device=dev))

    mel_len1 = prompt_feat.shape[1]
    mel_len2 = mel_len_for_tokens(cfg, t2)
    h = length_regulator_inference(params["length_regulator"], cfg.length_regulator,
                                   h[:, :t1], h[:, t1:], mel_len1, mel_len2,
                                   cfg.input_frame_rate, cfg.sample_rate, cfg.mel_hop)
    mu = h.transpose(1, 2)  # (1, 80, T)
    total = mel_len1 + mel_len2
    conds = torch.zeros((1, total, cfg.output_size), dtype=mu.dtype, device=dev)
    conds[:, :mel_len1] = prompt_feat.to(dev, mu.dtype)
    conds = conds.transpose(1, 2)
    mask = torch.ones((1, 1, total), dtype=mu.dtype, device=dev)
    if z is None:
        z = torch.randn((1, cfg.output_size, total), generator=generator, device=dev)
    z = z.to(dev, mu.dtype)
    if flow_cache is not None and flow_cache.shape[2] > 0:
        # pin the prompt and overlap frames of the previous chunk
        cs = flow_cache.shape[2]
        z = torch.cat([flow_cache[:, :, :, 0].to(z.dtype), z[:, :, cs:]], dim=2)
        mu = torch.cat([flow_cache[:, :, :, 1].to(mu.dtype), mu[:, :, cs:]], dim=2)
    tail = cfg.cache_tail
    new_cache = torch.stack([torch.cat([z[:, :, :mel_len1], z[:, :, -tail:]], dim=2),
                             torch.cat([mu[:, :, :mel_len1], mu[:, :, -tail:]], dim=2)], dim=-1)
    feat = _solve_euler_cfg_v1(params, cfg, z, mu, mask, spks, conds)
    return feat[:, :, mel_len1:], new_cache


def flow_v1_loss(params: dict, cfg: FlowV1Config, batch: dict, draws: dict) -> torch.Tensor:
    """The training objective.  batch: speech_token (B, T), speech_token_len
    (B,), speech_feat (B, T_mel, 80), speech_feat_len (B,), embedding
    (B, spk_embed_dim).  draws: u_cond, u_frac (B,) uniform for the random
    prompt prefix (half the rows expose up to 30% of their target as cond);
    u_t (B, 1, 1), z (B, 80, T_mel), u_cfg (B,) for ``cfm_loss``."""
    from cosyvoice2_eu_torch.train.losses import cfm_loss

    token, token_len = batch["speech_token"], batch["speech_token_len"]
    feat, feat_len = batch["speech_feat"], batch["speech_feat_len"]
    t_mel = feat.shape[1]
    spks = _normalized_spk(params, batch["embedding"])
    h = _encode_tokens(params, cfg, token, token_len)
    mel_mask = make_non_pad_mask(feat_len, t_mel)
    h = length_regulator_forward(params["length_regulator"], cfg.length_regulator, h, t_mel,
                                 mel_mask)
    use = draws["u_cond"].to(feat.device) < 0.5
    idx = (draws["u_frac"].to(feat.device) * 0.3 * feat_len.float()).to(torch.int32)
    pos = torch.arange(t_mel, device=feat.device)[None, :]
    cond_mask = use[:, None] & (pos < idx[:, None])
    conds = torch.where(cond_mask[..., None], feat, 0.0).transpose(1, 2)
    mask = mel_mask[:, None, :].to(feat.dtype)
    return cfm_loss(
        lambda y, m, mu, t, s, c: estimator_v1_forward(params["estimator"], cfg.estimator,
                                                       y, m, mu, t, s, c),
        feat.transpose(1, 2), mask, h.transpose(1, 2), spks, conds,
        draws["u_t"].to(feat.device), draws["z"].to(feat.device), draws["u_cfg"].to(feat.device),
        sigma_min=cfg.cfm.sigma_min, training_cfg_rate=cfg.cfm.training_cfg_rate)
