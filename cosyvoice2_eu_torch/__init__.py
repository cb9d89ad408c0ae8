"""cosyvoice2_eu_torch — the PyTorch/CUDA port of the CosyVoice2-EU framework.

It stands beside the JAX package ``cosyvoice2_eu_tpu`` (the reference) and
imports neither JAX nor that package.  Entry points run on the GPU unless the
caller asks for the CPU:

    import cosyvoice2_eu_torch as cosy
    model = cosy.load(seed=0)                     # random weights, on "cuda"
    wav, sr = model.tts("Bonjour !", prompt)      # prompt: dict of artifacts
    for chunk in model.stream("Bonjour !", prompt):  # (1, t) float32 chunks
        ...
    int8 = cosy.load(seed=0, lm_quant="int8")     # int8 LM projections (kernel K2)

``load`` sets ``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` to False: HiFT's fp32 phase math
does not tolerate TF32.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from cosyvoice2_eu_torch.config import TTSConfig

__version__ = "0.1.0"
__all__ = ["load", "Cosy2EU", "TTSConfig", "__version__"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": None, "none": None}


class Cosy2EU:
    """High-level inference wrapper: ``tts`` returns the whole waveform,
    ``stream`` yields it chunk by chunk."""

    def __init__(self, model, frontend, cfg: TTSConfig):
        self._model = model
        self._frontend = frontend
        self._cfg = cfg

    @property
    def sample_rate(self) -> int:
        return self._cfg.sample_rate

    def _prepare(self, prompt, prompt_text: str = "", **precomputed):
        if isinstance(prompt, dict):
            missing = {"prompt_feat", "speech_tokens", "embedding"} - prompt.keys()
            if missing:
                raise ValueError(
                    f"prompt dict is missing {sorted(missing)}; expected the artifact keys "
                    "prompt_feat, speech_tokens, embedding (and optionally prompt_text)")
            return prompt
        return self._frontend.extract_prompt(prompt, prompt_text, **precomputed)

    def tts(
        self,
        text: str,
        prompt,
        *,
        prompt_text: str = "",
        speed: float = 1.0,
        text_frontend: bool = False,
        mode: str = "cross_lingual",
        **precomputed,
    ) -> Tuple[np.ndarray, int]:
        """Synthesize; returns (waveform (1, T) float32, sample_rate)."""
        chunks = list(self._generate(text, prompt, prompt_text, False, speed, text_frontend,
                                     mode, **precomputed))
        return np.concatenate(chunks)[None], self.sample_rate

    def stream(
        self,
        text: str,
        prompt,
        *,
        prompt_text: str = "",
        speed: float = 1.0,
        text_frontend: bool = False,
        mode: str = "cross_lingual",
        **precomputed,
    ) -> Iterator[np.ndarray]:
        """Yield waveform chunks (1, t) float32 for streaming playback."""
        for chunk in self._generate(text, prompt, prompt_text, True, speed, text_frontend, mode,
                                    **precomputed):
            yield chunk[None]

    def _generate(self, text, prompt, prompt_text, stream, speed, text_frontend, mode,
                  **precomputed):
        prompt_art = self._prepare(prompt, prompt_text, **precomputed)
        segments = (self._frontend.normalize_text(text, split=True) if text_frontend
                    else [text])
        if mode == "instruct2":
            raise NotImplementedError("instruct2 mode is not ported yet: ROADMAP item 5")
        if mode not in ("zero_shot", "cross_lingual"):
            raise ValueError(f"unknown mode {mode!r}")
        build = getattr(self._frontend, f"frontend_{mode}")
        for seg in segments:
            yield from self._model.tts(build(seg, prompt_art), stream=stream, speed=speed)


def load(
    *,
    config: Optional[TTSConfig] = None,
    seed: int = 0,
    params: Optional[dict] = None,
    compute_dtype="bfloat16",
    device: str | torch.device = "cuda",
    model_dir: Optional[str] = None,
    backbone: Optional[str] = None,
    lm_quant: Optional[str] = None,
    tp: int = 0,
) -> Cosy2EU:
    """Build the model once and reuse it for many calls.

    With ``params`` (a {"llm", "flow", "hift"} tree of numpy arrays or
    tensors, e.g. the JAX package's parameters through ``np.asarray``) those
    weights are used; otherwise the weights are random, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``.  ``config``
    defaults to the published widths.  ``device`` defaults to "cuda" and
    raises when there is no GPU; pass "cpu" for the plain PyTorch path.
    ``lm_quant="int8"`` stores the LM's projections as per-channel int8
    (kernel K2 on the card); any value but None and "int8" raises.
    Batched synthesis is ``load(...)._model.tts_batch(prompts)`` over the
    frontend's ``PromptInputs``.
    """
    from cosyvoice2_eu_torch.frontend.frontend import Frontend
    from cosyvoice2_eu_torch.frontend.tokenizer import get_tokenizer
    from cosyvoice2_eu_torch.runtime.model import TTSModel
    from cosyvoice2_eu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if model_dir is not None:
        raise NotImplementedError("loading checkpoints is not ported yet: ROADMAP item 3")
    if backbone is not None:
        raise NotImplementedError(
            "alternative backbones (the v1 family) are not ported yet: ROADMAP item 9")
    cfg = config or TTSConfig()
    if params is None:
        from cosyvoice2_eu_torch.models.flow import init_flow
        from cosyvoice2_eu_torch.models.hift import init_hift
        from cosyvoice2_eu_torch.models.llm import init_lm

        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = {"llm": init_lm(gen, cfg.llm), "flow": init_flow(gen, cfg.flow),
                  "hift": init_hift(gen, cfg.hift)}
    if isinstance(compute_dtype, str):
        compute_dtype = _DTYPES[compute_dtype]
    model = TTSModel(cfg, params, seed=seed, compute_dtype=compute_dtype, device=dev,
                     lm_quant=lm_quant, tp=tp)
    return Cosy2EU(model, Frontend(cfg, tokenizer=get_tokenizer("")), cfg)
