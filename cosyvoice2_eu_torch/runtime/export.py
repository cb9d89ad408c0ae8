"""Ahead-of-time export of the flow's estimator.

Counterpart of ``cosyvoice2_eu_tpu/runtime/export.py``: the CFM estimator
(the module the reference exports to ONNX/TensorRT) is traced once per mel
bucket with ``torch.export`` and saved as ``flow.estimator.mel{T}.pt2``, the
parameters an input, as JAX's ``jax.export`` does.  On the card every
attention of the traced program is kernel K1, one node each
(``cosyvoice2_eu::flash_attention_fwd``, ``ops/flash_attention.py``); on the
CPU the plain masked softmax.  A saved program loads only where that
operator is registered: ``load_exported`` imports it first.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch

from cosyvoice2_eu_torch.utils.params import tree_leaves


class _Estimator(torch.nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg

    def forward(self, p, x, mask, mu, t, spks, cond):
        from cosyvoice2_eu_torch.models.estimator import estimator_forward

        return estimator_forward(p, self.cfg, x, mask, mu, t, spks, cond)


def export_flow_estimator(params, cfg, mel_buckets: Sequence[int], out_dir: str) -> list[str]:
    """Trace and save the estimator for each mel bucket; returns the paths.

    ``params``: the flow's parameter tree (its ``"estimator"`` is traced as
    an input).  The arguments have JAX's shapes, (2, C, T) for x, mu and
    cond, (2, 1, T) for the mask, (2,) for t and (2, C) for spks, in the
    estimator's floating dtype (bfloat16 for a served model, JAX's) on the
    parameters' device."""
    est = params["estimator"]
    first = next(x for x in tree_leaves(est) if torch.is_floating_point(x))
    dtype, dev = first.dtype, first.device
    c = cfg.output_size
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for t_mel in mel_buckets:
        zeros = lambda *s: torch.zeros(s, dtype=dtype, device=dev)  # noqa: E731
        args = (est, zeros(2, c, t_mel), zeros(2, 1, t_mel), zeros(2, c, t_mel), zeros(2),
                zeros(2, c), zeros(2, c, t_mel))
        exported = torch.export.export(_Estimator(cfg.estimator), args, strict=False)
        exported.example_inputs = None  # the file keeps the graph, not the weights it was traced on
        path = os.path.join(out_dir, f"flow.estimator.mel{t_mel}.pt2")
        torch.export.save(exported, path)
        paths.append(path)
    return paths


def load_exported(path: str) -> torch.export.ExportedProgram:
    """A saved program (``.module()(...)`` calls it); the port's K1 operator
    is registered first, so a fresh process can load a program that holds it."""
    import cosyvoice2_eu_torch.ops.flash_attention  # noqa: F401  (registers the K1 operator)

    return torch.export.load(path)


def export_tts_stages(tts_model, out_dir: str, token_buckets=(128, 256)) -> list[str]:
    """Export the flow stages the orchestrator runs: the estimator at the mel
    bucket of each token bucket."""
    return export_flow_estimator(
        tts_model.params["flow"], tts_model.cfg.flow,
        [b * tts_model.cfg.flow.token_mel_ratio for b in token_buckets], out_dir)
