"""Reference-compatible API shim of the port: ``CosyVoice2``.

Counterpart of ``cosyvoice2_eu_tpu/compat.py``: the reference's constructor
signature and ``inference_*`` generator methods (reference:
cosy_repo/cosyvoice/cli/cosyvoice.py:142-294) over ``load``, so code written
against the reference (its evaluation pipeline builds ``CosyVoice2(model_dir,
setting=..., final=...)`` and calls ``inference_cross_lingual(text,
prompt_wav, stream=..., speed=...)``) runs on the port.  Outputs are dicts
``{"tts_speech": (1, T) float32 CPU tensor}``, as the reference's.
``device`` (default "cuda") goes to ``load``.  ``CosyVoice`` is the
reference's v1 (CosyVoice-300M) class over ``load_v1``.
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
        return self._api.add_zero_shot_spk(prompt_text, _as_numpy_wav(prompt_speech_16k),
                                           zero_shot_spk_id)

    def inference_zero_shot(self, tts_text, prompt_text, prompt_speech_16k,
                            zero_shot_spk_id="", stream=False, speed=1.0,
                            text_frontend=True) -> Generator[dict, None, None]:
        # the reference normalizes the prompt transcription (split=False)
        # before it reaches the LM, gated on text_frontend like the text
        if text_frontend:
            prompt_text = self.frontend.normalize_text(prompt_text, split=False)
        prompt = (self.frontend.get_spk(zero_shot_spk_id) if zero_shot_spk_id
                  else _as_numpy_wav(prompt_speech_16k))
        yield from self._run("zero_shot", tts_text, prompt, prompt_text, stream, speed,
                             text_frontend)

    def inference_cross_lingual(self, tts_text, prompt_speech_16k, zero_shot_spk_id="",
                                stream=False, speed=1.0, text_frontend=True):
        prompt = (self.frontend.get_spk(zero_shot_spk_id) if zero_shot_spk_id
                  else _as_numpy_wav(prompt_speech_16k))
        yield from self._run("cross_lingual", tts_text, prompt, "", stream, speed,
                             text_frontend)

    def inference_instruct2(self, tts_text, instruct_text, prompt_speech_16k,
                            zero_shot_spk_id="", stream=False, speed=1.0,
                            text_frontend=True):
        prompt_art = self._api._prepare(_as_numpy_wav(prompt_speech_16k))
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
    """The reference's v1 (CosyVoice-300M family) class over ``load_v1``:
    the constructor flags, the speaker store and the five ``inference_*``
    generators (reference cli/cosyvoice.py:27-141).  jit/trt/fp16 select
    engines of the reference and are accepted and ignored;
    ``config``/``params``/``seed``/``device`` go to ``load_v1``.
    ``inference_instruct`` needs a model dir whose name holds "-Instruct",
    as the reference's."""

    def __init__(self, model_dir: Optional[str] = None, load_jit: bool = False,
                 load_trt: bool = False, fp16: bool = False, trt_concurrent: int = 1,
                 config=None, params=None, seed: int = 0, device: str = "cuda"):
        self.instruct = "-Instruct" in (model_dir or "")
        self.model_dir = model_dir
        self.model, self.frontend, self._cfg = cosy.load_v1(
            model_dir=model_dir, config=config, params=params, seed=seed, device=device)
        self.sample_rate = self._cfg.sample_rate

    # -- helpers -------------------------------------------------------------

    def _extract(self, prompt_speech_16k, prompt_text: str = "") -> dict:
        return self.frontend.extract_prompt(_as_numpy_wav(prompt_speech_16k), prompt_text)

    def _segments(self, tts_text: str, text_frontend: bool):
        return self.frontend.normalize_text(tts_text, split=True) if text_frontend else [tts_text]

    def _emit(self, gen):
        start = time.time()
        for chunk in gen:
            speech_len = chunk.shape[0] / self.sample_rate
            logging.info("yield speech len %s, rtf %s", speech_len,
                         (time.time() - start) / max(speech_len, 1e-6))
            yield {"tts_speech": torch.from_numpy(np.asarray(chunk))[None]}
            start = time.time()

    def _empty(self):
        return (np.zeros((0,), np.int32), np.zeros((0, self._cfg.flow.output_size), np.float32))

    # -- reference API -------------------------------------------------------

    def list_available_spks(self):
        return list(self.frontend.spk_info)

    def add_zero_shot_spk(self, prompt_text, prompt_speech_16k, zero_shot_spk_id) -> bool:
        if zero_shot_spk_id == "":
            raise ValueError("do not use empty zero_shot_spk_id")
        return self.frontend.add_zero_shot_spk(zero_shot_spk_id,
                                               self._extract(prompt_speech_16k, prompt_text))

    def save_spkinfo(self):
        if not self.model_dir:
            raise ValueError("save_spkinfo() needs a model_dir to write spk2info.npz to; "
                             "call frontend.save_spk_info(path) with an explicit path")
        self.frontend.save_spk_info(os.path.join(self.model_dir, "spk2info.npz"))

    def inference_sft(self, tts_text, spk_id, stream=False, speed=1.0, text_frontend=True):
        """The speaker's embedding alone: no prompt text, tokens or mel."""
        art = self.frontend.get_spk(spk_id)
        empty_tok, empty_feat = self._empty()
        for seg in self._segments(tts_text, text_frontend):
            yield from self._emit(self.model.tts(
                self.frontend.text_tokens(seg), empty_tok, empty_tok, empty_feat,
                np.asarray(art["embedding"], np.float32), stream=stream, speed=speed))

    def inference_zero_shot(self, tts_text, prompt_text, prompt_speech_16k, zero_shot_spk_id="",
                            stream=False, speed=1.0, text_frontend=True):
        if text_frontend:
            prompt_text = self.frontend.normalize_text(prompt_text, split=False)
        art = (self.frontend.get_spk(zero_shot_spk_id) if zero_shot_spk_id
               else self._extract(prompt_speech_16k, prompt_text))
        ptext = art.get("prompt_text", prompt_text) or ""
        for seg in self._segments(tts_text, text_frontend):
            if len(seg) < 0.5 * len(ptext):
                logging.warning("synthesis text %s too short than prompt text %s, "
                                "this may lead to bad performance", seg, ptext)
            yield from self._emit(self.model.tts(
                self.frontend.text_tokens(seg), self.frontend.text_tokens(ptext),
                np.asarray(art["speech_tokens"], np.int32),
                np.asarray(art["prompt_feat"], np.float32),
                np.asarray(art["embedding"], np.float32), stream=stream, speed=speed))

    def inference_cross_lingual(self, tts_text, prompt_speech_16k, zero_shot_spk_id="",
                                stream=False, speed=1.0, text_frontend=True):
        """The LM sees neither the prompt text nor its speech tokens; the
        flow keeps them for the timbre."""
        art = (self.frontend.get_spk(zero_shot_spk_id) if zero_shot_spk_id
               else self._extract(prompt_speech_16k))
        empty_tok, _ = self._empty()
        for seg in self._segments(tts_text, text_frontend):
            yield from self._emit(self.model.tts(
                self.frontend.text_tokens(seg), empty_tok,
                np.asarray(art["speech_tokens"], np.int32),
                np.asarray(art["prompt_feat"], np.float32),
                np.asarray(art["embedding"], np.float32), stream=stream, speed=speed,
                llm_prompt_speech_tokens=empty_tok))

    def inference_instruct(self, tts_text, spk_id, instruct_text, stream=False, speed=1.0,
                           text_frontend=True):
        """The instruction becomes the prompt text and the LM's speaker slot
        is dropped."""
        if self.instruct is False:
            raise ValueError(f"{self.model_dir} do not support instruct inference")
        art = self.frontend.get_spk(spk_id)
        instruct = (self.frontend.normalize_text(instruct_text, split=False) if text_frontend
                    else instruct_text)
        if isinstance(instruct, list):
            instruct = " ".join(instruct)
        ptext_tokens = self.frontend.text_tokens(instruct + "<endofprompt>")
        empty_tok, empty_feat = self._empty()
        for seg in self._segments(tts_text, text_frontend):
            yield from self._emit(self.model.tts(
                self.frontend.text_tokens(seg), ptext_tokens, empty_tok, empty_feat,
                np.asarray(art["embedding"], np.float32), stream=stream, speed=speed,
                llm_embedding=None))

    def inference_vc(self, source_speech_16k, prompt_speech_16k, stream=False, speed=1.0):
        """The source's speech tokens straight to token2wav."""
        if self.frontend.speech_tokenizer_fn is None:
            raise ValueError("vc needs the speech tokenizer (speech_tokenizer_v1.onnx in "
                             "model_dir) to tokenize the source audio")
        art = self._extract(prompt_speech_16k)
        source_tokens = np.asarray(
            self.frontend.speech_tokenizer_fn(_as_numpy_wav(source_speech_16k)), np.int32)
        yield from self._emit(self.model.vc(
            source_tokens, np.asarray(art["speech_tokens"], np.int32),
            np.asarray(art["prompt_feat"], np.float32),
            np.asarray(art["embedding"], np.float32), stream=stream, speed=speed))


def _as_numpy_wav(x) -> np.ndarray:
    arr = x.numpy() if torch.is_tensor(x) else np.asarray(x)
    return arr.reshape(-1).astype(np.float32)
