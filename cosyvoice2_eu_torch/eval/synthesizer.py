"""Evaluation synthesizer wrapper.

Re-expression of the reference CosyVoice2Synthesizer
(reference: evaluation/cosyvoice_synthesizer.py:32-366): loads one model per
model-config, warms it up, caches prompts as zero-shot speakers, optionally
prefixes the language hint ``<|fr|><|endofprompt|>`` (:226-228), and runs
batches through a ThreadPool with a per-sample timeout so one hung synthesis
cannot stall the whole run (:260-297).

The PyTorch port's copy of ``cosyvoice2_eu_tpu/eval/synthesizer.py``: it imports
only the port, and gives the same outputs on the same inputs.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Callable, Optional

import numpy as np

logger = logging.getLogger(__name__)


class Synthesizer:
    def __init__(
        self,
        model=None,
        load_kwargs: Optional[dict] = None,
        language: str = "fr",
        mode: str = "cross_lingual",
        add_language_hint: bool = False,
        timeout_s: float = 45.0,
        warmup: bool = True,
        workers: int = 1,
    ):
        if model is None:
            import cosyvoice2_eu_torch as cosy

            model = cosy.load(**(load_kwargs or {}))
        self.model = model
        self.language = language
        self.mode = mode
        self.add_language_hint = add_language_hint
        self.timeout_s = timeout_s
        self.warmup = warmup
        self.workers = workers
        self._warmed = False
        self._spk_cache: dict[str, str] = {}  # prompt path -> spk_id

    @property
    def sample_rate(self) -> int:
        return self.model.sample_rate

    def _text(self, text: str) -> str:
        if self.add_language_hint and self.language in ("fr", "de"):
            return f"<|{self.language}|><|endofprompt|>{text}"
        return text

    def _prompt_for(self, prompt_path: str):
        """Cache each prompt as a zero-shot speaker (cosyvoice_synthesizer.py:105)."""
        if prompt_path not in self._spk_cache:
            spk_id = f"eval_spk_{len(self._spk_cache)}"
            if self.model.add_zero_shot_spk("", prompt_path, spk_id):
                self._spk_cache[prompt_path] = spk_id
        spk_id = self._spk_cache.get(prompt_path)
        if spk_id is not None:
            return self.model._frontend.get_spk(spk_id)
        return prompt_path

    def synthesize(self, text: str, prompt_path: str) -> tuple[np.ndarray, float]:
        """-> (wav float32 (T,), wall seconds)."""
        if self.warmup and not self._warmed:
            self._warmed = True
            try:
                self.model.tts(self._text("Bonjour."), self._prompt_for(prompt_path),
                               mode=self.mode)
            except Exception:  # warmup failures surface on the real sample
                logger.exception("warmup failed")
        t0 = time.time()
        wav, _ = self.model.tts(self._text(text), self._prompt_for(prompt_path),
                                mode=self.mode)
        return wav[0], time.time() - t0

    def synthesize_batch(self, items, on_result: Optional[Callable] = None) -> list:
        """items: iterable of (key, text, prompt_path).  Returns rows of
        {key, wav | error, synthesis_time}; a sample that exceeds timeout_s is
        recorded as a failure row and the run continues."""
        rows = []
        ex = ThreadPoolExecutor(max_workers=self.workers)
        try:
            for key, text, prompt_path in items:
                fut = ex.submit(self.synthesize, text, prompt_path)
                try:
                    wav, secs = fut.result(timeout=self.timeout_s)
                    row = {"key": key, "wav": wav, "synthesis_time": secs}
                except FuturesTimeout:
                    logger.error("timeout synthesizing %s after %.0fs", key, self.timeout_s)
                    row = {"key": key, "error": f"timeout {self.timeout_s}s",
                           "synthesis_time": self.timeout_s}
                    # the hung worker still occupies its thread; hand
                    # subsequent samples a fresh pool so the run continues
                    ex.shutdown(wait=False)
                    ex = ThreadPoolExecutor(max_workers=self.workers)
                except Exception as e:
                    logger.exception("synthesis failed for %s", key)
                    row = {"key": key, "error": str(e), "synthesis_time": 0.0}
                rows.append(row)
                if on_result is not None:
                    on_result(row)
        finally:
            ex.shutdown(wait=False)
        return rows


def test_synthesizer(model=None, device: str = "cuda") -> dict:
    """Smoke test (the reference's test_synthesizer,
    cosyvoice_synthesizer.py:311): synthesize two short sentences on a tiny
    random model on ``device`` and check finite audio comes back."""
    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.config import tiny_test_config

    cfg = tiny_test_config()
    model = model or cosy.load(config=cfg, seed=0, device=device, compute_dtype="float32")
    rng = np.random.default_rng(0)
    n_sp = 6
    prompt = {
        "prompt_feat": rng.standard_normal((n_sp * 2, cfg.flow.output_size)).astype(np.float32),
        "speech_tokens": rng.integers(0, cfg.llm.speech_token_size, n_sp).astype(np.int32),
        "embedding": rng.standard_normal(cfg.frontend.spk_embed_dim).astype(np.float32),
        "prompt_text": "",
    }
    model._frontend.add_zero_shot_spk("smoke", prompt)
    syn = Synthesizer(model=model, warmup=False, timeout_s=600.0)
    syn._spk_cache["smoke"] = "smoke"
    rows = syn.synthesize_batch(
        [("a", "Bonjour le monde.", "smoke"), ("b", "Hallo Welt.", "smoke")]
    )
    ok = all("wav" in r and np.isfinite(r["wav"]).all() for r in rows)
    out = {"ok": ok, "n": len(rows)}
    print(out)
    return out
