"""The frontend functions that ``load(model_dir=...)`` builds from the
reference's ONNX binaries (``speech_tokenizer_v2.onnx``, ``campplus.onnx``).

Counterpart of ``cosyvoice2_eu_tpu/runtime/onnx_fallback.py::load_frontend_fns``
without its fallback: the JAX package runs a graph its structural converter
cannot map through a numpy graph executor on the host, with a warning
(and always under ``COSY2EU_ONNX_EXECUTOR=1``).  The port has no executor
(ROADMAP item 10) and raises instead, as the JAX package does with
``strict=True``, so prompt extraction never leaves the device quietly.
"""

from __future__ import annotations

import os

import torch


def load_frontend_fns(st_path: str | None, cam_path: str | None,
                      device: str | torch.device = "cuda"):
    """(speech_tokenizer_fn, spk_embedding_fn) on ``device`` from the ONNX
    files that exist (None for a missing one); a graph the structural
    converter (``runtime/onnx_convert.py``) cannot map raises ``ValueError``
    naming the file."""
    from cosyvoice2_eu_torch.frontend.frontend import (
        make_speech_tokenizer_fn,
        make_spk_embedding_fn,
    )
    from cosyvoice2_eu_torch.runtime.onnx_convert import (
        convert_campplus,
        convert_speech_tokenizer,
    )
    from cosyvoice2_eu_torch.runtime.onnx_import import load_onnx

    fns = []
    for path, convert, make in ((st_path, convert_speech_tokenizer, make_speech_tokenizer_fn),
                                (cam_path, convert_campplus, make_spk_embedding_fn)):
        if path is None or not os.path.exists(path):
            fns.append(None)
            continue
        try:
            params, cfg = convert(load_onnx(path))
        except Exception as e:  # any mapping failure: a graph this converter does not know
            raise ValueError(
                f"{path}: the structural ONNX conversion failed ({type(e).__name__}: {e}); the "
                "port has no graph executor to fall back on (ROADMAP item 10)") from e
        fns.append(make(params, cfg, device=device))
    return tuple(fns)
