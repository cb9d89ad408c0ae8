"""Frozen copy of the port's ``cosyvoice2_eu_torch/ops/masks.py`` (plain
PyTorch, no kernel), for the benchmark's reference: it imports nothing of
the port, and a later change to the port does not change it."""

from __future__ import annotations

import torch

# additive bias of the plain attention paths (estimator, encoder, LM); the
# flash kernel and the sampler use their own -1e30
NEG_INF = -1.0e10


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """True where padded.  lengths: (B,) -> (B, max_len) bool."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return pos >= lengths[:, None]


def make_non_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """True where valid (non-pad)."""
    return ~make_pad_mask(lengths, max_len)


def subsequent_chunk_mask(size: int, chunk_size: int, num_left_chunks: int = -1,
                          device=None) -> torch.Tensor:
    """(size, size) bool: position i may attend j.

    Position i sees everything up to the end of its own chunk and
    ``num_left_chunks`` chunks of history (-1 = unlimited).
    """
    idx = torch.arange(size, device=device)
    chunk_idx = idx // chunk_size
    max_visible = (chunk_idx + 1) * chunk_size  # exclusive
    mask = idx[None, :] < max_visible[:, None]
    if num_left_chunks >= 0:
        min_visible = ((chunk_idx - num_left_chunks) * chunk_size).clamp_min(0)
        mask &= idx[None, :] >= min_visible[:, None]
    return mask


def chunk_attention_mask(
    lengths: torch.Tensor,
    max_len: int,
    chunk_size: int,
    num_left_chunks: int = -1,
) -> torch.Tensor:
    """(B, T, T) bool mask combining chunk causality and padding.

    chunk_size == 0 means full (non-streaming) attention over valid keys.
    """
    valid = make_non_pad_mask(lengths, max_len)  # (B, T)
    if chunk_size > 0:
        chunk = subsequent_chunk_mask(max_len, chunk_size, num_left_chunks,
                                      device=lengths.device)
        return valid[:, None, :] & chunk[None, :, :]
    return valid[:, None, :].expand(valid.shape[0], max_len, max_len)
