"""Reference-compatible API shim of the port: ``CosyVoice2``.

Counterpart of ``cosyvoice2_eu_tpu/compat.py``: the reference's constructor
signature and ``inference_*`` generator methods (reference:
cosy_repo/cosyvoice/cli/cosyvoice.py:142-294) over ``load``, so code written
against the reference (its evaluation pipeline builds ``CosyVoice2(model_dir,
setting=..., final=...)`` and calls ``inference_cross_lingual(text,
prompt_wav, stream=..., speed=...)``) runs on the port.  Outputs are dicts
``{"tts_speech": (1, T) float32 CPU tensor}``, as the reference's.
``device`` (default "cuda") goes to ``load``.  The v1 class ``CosyVoice``
needs ``load_v1``, which is not ported yet (ROADMAP item 9).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Generator, Optional

import numpy as np
import torch

import cosyvoice2_eu_torch as cosy


class CosyVoice2:
    def __init__(
        self,
        model_dir: str,
        load_jit: bool = False,
        load_trt: bool = False,
        load_vllm: bool = False,
        fp16: bool = False,
        setting: str = "llm_flow_hifigan",
        llm_run_id: Optional[str] = None,
        flow_run_id: Optional[str] = None,
        hifigan_run_id: Optional[str] = None,
        final: bool = True,
        backbone: str = "blanken",
        device: str = "cuda",
        **_: dict,
    ):
        # jit/trt/vllm/fp16 select engines of the reference; accepted and ignored
        self._api = cosy.load(
            model_dir=model_dir,
            setting=setting,
            llm_run_id=llm_run_id,
            flow_run_id=flow_run_id,
            hifigan_run_id=hifigan_run_id,
            final=final,
            backbone=backbone,
            device=device,
        )
        self.sample_rate = self._api.sample_rate
        self.frontend = self._api._frontend
        self.model_dir = model_dir

    def save_spkinfo(self):
        """Write the zero-shot speakers added so far to ``spk2info.npz`` in
        the model dir (the reference writes ``spk2info.pt`` there)."""
        if not self.model_dir:
            raise ValueError("save_spkinfo() needs a model_dir to write spk2info.npz to; "
                             "call frontend.save_spk_info(path) with an explicit path")
        self.frontend.save_spk_info(os.path.join(self.model_dir, "spk2info.npz"))

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _as_numpy_prompt(prompt_speech_16k) -> np.ndarray:
        arr = prompt_speech_16k.numpy() if torch.is_tensor(prompt_speech_16k) \
            else np.asarray(prompt_speech_16k)
        return arr.reshape(-1).astype(np.float32)

    def _run(self, mode, tts_text, prompt, prompt_text="", stream=False, speed=1.0,
             text_frontend=True):
        kw = dict(prompt_text=prompt_text, speed=speed, text_frontend=text_frontend, mode=mode)
        start = time.time()
        gen = (self._api.stream(tts_text, prompt, **kw) if stream
               else iter([self._api.tts(tts_text, prompt, **kw)[0]]))
        for chunk in gen:
            speech_len = chunk.shape[1] / self.sample_rate
            logging.info("yield speech len %s, rtf %s", speech_len,
                         (time.time() - start) / max(speech_len, 1e-6))
            yield {"tts_speech": torch.from_numpy(np.asarray(chunk))}
            start = time.time()

    # -- reference API -------------------------------------------------------

    def list_available_spks(self):
        return list(self.frontend.spk_info)

    def add_zero_shot_spk(self, prompt_text, prompt_speech_16k, zero_shot_spk_id) -> bool:
        return self._api.add_zero_shot_spk(prompt_text, self._as_numpy_prompt(prompt_speech_16k),
                                           zero_shot_spk_id)

    def inference_zero_shot(self, tts_text, prompt_text, prompt_speech_16k,
                            zero_shot_spk_id="", stream=False, speed=1.0,
                            text_frontend=True) -> Generator[dict, None, None]:
        # the reference normalizes the prompt transcription (split=False)
        # before it reaches the LM, gated on text_frontend like the text
        if text_frontend:
            prompt_text = self.frontend.normalize_text(prompt_text, split=False)
        prompt = (self.frontend.get_spk(zero_shot_spk_id) if zero_shot_spk_id
                  else self._as_numpy_prompt(prompt_speech_16k))
        yield from self._run("zero_shot", tts_text, prompt, prompt_text, stream, speed,
                             text_frontend)

    def inference_cross_lingual(self, tts_text, prompt_speech_16k, zero_shot_spk_id="",
                                stream=False, speed=1.0, text_frontend=True):
        prompt = (self.frontend.get_spk(zero_shot_spk_id) if zero_shot_spk_id
                  else self._as_numpy_prompt(prompt_speech_16k))
        yield from self._run("cross_lingual", tts_text, prompt, "", stream, speed,
                             text_frontend)

    def inference_instruct2(self, tts_text, instruct_text, prompt_speech_16k,
                            zero_shot_spk_id="", stream=False, speed=1.0,
                            text_frontend=True):
        prompt_art = self._api._prepare(self._as_numpy_prompt(prompt_speech_16k))
        segments = (self.frontend.normalize_text(tts_text, split=True) if text_frontend
                    else [tts_text])
        for seg in segments:
            inputs = self.frontend.frontend_instruct2(seg, instruct_text, prompt_art)
            for chunk in self._api._model.tts(inputs, stream=stream, speed=speed):
                yield {"tts_speech": torch.from_numpy(np.asarray(chunk))[None]}

    def inference_sft(self, tts_text, spk_id, stream=False, speed=1.0, text_frontend=True):
        prompt = self.frontend.get_spk(spk_id)
        yield from self._run("zero_shot", tts_text, prompt, prompt.get("prompt_text", ""),
                             stream, speed, text_frontend)

    def inference_instruct(self, *args, **kwargs):
        raise NotImplementedError("inference_instruct is not implemented for CosyVoice2!")


class CosyVoice:
    """The reference's v1 (CosyVoice-300M) class: its loader ``load_v1`` and
    models are not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the v1 family (CosyVoice, load_v1) is not ported yet: ROADMAP item 9")
