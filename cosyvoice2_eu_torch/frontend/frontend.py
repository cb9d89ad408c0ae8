"""Prompt-side frontend for zero-shot cloning: text tokens and prompt features.

Counterpart of ``cosyvoice2_eu_tpu/frontend/frontend.py`` (the reference's
CosyVoiceFrontEnd, cosy_repo/cosyvoice/cli/frontend.py:173).  Text
normalisation and tokenisation run on the host; prompt feature extraction
from a 16 kHz wav (the 24 kHz prompt mel, the FSQ speech tokens through the
whisper log-mel, the CAM++ x-vector through the kaldi fbank) runs on the
frontend's device, "cuda" unless the caller asks for the CPU.  The
zero-shot / cross-lingual / instruct2 builders pack a prompt dict
``{"prompt_feat", "speech_tokens", "embedding", "prompt_text"}`` into
``PromptInputs``; the cached-speaker store is the reference's
``spk2info.pt``.
"""

from __future__ import annotations

import wave
from math import gcd
from typing import Callable, Optional

import numpy as np
import torch

from cosyvoice2_eu_torch.config import TTSConfig
from cosyvoice2_eu_torch.frontend.text import text_normalize
from cosyvoice2_eu_torch.frontend.tokenizer import get_tokenizer
from cosyvoice2_eu_torch.runtime.model import PromptInputs
from cosyvoice2_eu_torch.utils.device import resolve_device
from cosyvoice2_eu_torch.utils.params import params_from_numpy
from cosyvoice2_eu_torch.utils.profiling import StageTimer

MAX_PROMPT_SAMPLES_16K = 30 * 16000  # the speech tokenizer's 30 s (3000 whisper frames)


def load_wav(path: str, target_sr: int) -> np.ndarray:
    """Read a 16- or 32-bit PCM wav file to mono float32 at ``target_sr``
    (channels averaged, then resampled; on the host)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return resample(data, sr, target_sr)


def resample(x: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling on the host (``scipy.signal.resample_poly``)."""
    if sr == target_sr:
        return x
    from scipy.signal import resample_poly

    g = gcd(sr, target_sr)
    return resample_poly(x, target_sr // g, sr // g).astype(np.float32)


def _wav_tensor(wav: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host waveform (T,) -> a (1, T) float32 tensor on ``device``."""
    return torch.as_tensor(np.asarray(wav, np.float32), device=device)[None]


class Frontend:
    def __init__(
        self,
        cfg: TTSConfig,
        tokenizer=None,
        speech_tokenizer_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        spk_embedding_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        mel_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        device: str | torch.device = "cuda",
    ):
        """speech_tokenizer_fn: 16 kHz wav -> (T_tok,) FSQ codes
        (``make_speech_tokenizer_fn``); spk_embedding_fn: 16 kHz wav -> (192,)
        x-vector (``make_spk_embedding_fn``); mel_fn: 24 kHz wav (T,) ->
        (T_mel, 80) mel, by default ``mel_spectrogram`` on ``device``.
        ``device`` defaults to "cuda" and raises without a GPU."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or get_tokenizer("")
        self.speech_tokenizer_fn = speech_tokenizer_fn
        self.spk_embedding_fn = spk_embedding_fn
        if mel_fn is None:
            from cosyvoice2_eu_torch.ops.mel import mel_spectrogram

            m, dev = cfg.mel, self.device

            @torch.inference_mode()
            def mel_fn(wav_24k: np.ndarray) -> np.ndarray:
                mel = mel_spectrogram(
                    _wav_tensor(wav_24k, dev), n_fft=m.n_fft, num_mels=m.num_mels,
                    sampling_rate=m.sampling_rate, hop_size=m.hop_size, win_size=m.win_size,
                    fmin=m.fmin, fmax=m.fmax, center=m.center)
                return mel[0].T.cpu().numpy()  # (T_mel, 80)

        self.mel_fn = mel_fn
        # per-stage wall time of prompt extraction, synchronised on the card
        self.timer = StageTimer(torch.cuda.synchronize if self.device.type == "cuda" else None)
        # cached zero-shot speakers: spk_id -> prompt artifact dict
        self.spk_info: dict = {}

    # -- text ---------------------------------------------------------------

    def normalize_text(self, text: str, split: bool = True, lang: str | None = None):
        """Per-sentence language id and normalisation, then packing into
        segments of at most ~80 tokens (``frontend/text.py``)."""
        return text_normalize(text, lambda s: len(self.tokenizer.encode(s)), split=split,
                              lang=lang)

    def text_tokens(self, text: str) -> np.ndarray:
        return np.asarray(self.tokenizer.encode(text), np.int32)

    # -- prompt -------------------------------------------------------------

    def extract_prompt(
        self,
        prompt_wav_16k: np.ndarray,
        prompt_text: str = "",
        precomputed_speech_tokens: Optional[np.ndarray] = None,
        precomputed_embedding: Optional[np.ndarray] = None,
    ) -> dict:
        """A 16 kHz prompt waveform -> its artifact dict (the reference's
        frontend_zero_shot, frontend.py:491), with the mel trimmed to twice
        the tokens.  Longer than ``max_prompt_seconds`` raises ``ValueError``."""
        cfg = self.cfg
        max_samples = int(cfg.frontend.max_prompt_seconds * cfg.frontend.prompt_sr)
        if len(prompt_wav_16k) > max_samples:
            raise ValueError(f"prompt must be <= {cfg.frontend.max_prompt_seconds:g} s, got "
                             f"{len(prompt_wav_16k) / cfg.frontend.prompt_sr:.2f} s")

        with self.timer.stage("prompt_mel"):
            wav_24k = resample(prompt_wav_16k, cfg.frontend.prompt_sr, cfg.frontend.target_sr)
            feat = self.mel_fn(wav_24k)  # (T_mel, 80)

        if precomputed_speech_tokens is not None:
            speech_tokens = np.asarray(precomputed_speech_tokens, np.int32)
        elif self.speech_tokenizer_fn is not None:
            with self.timer.stage("prompt_speech_tokens"):
                speech_tokens = np.asarray(self.speech_tokenizer_fn(prompt_wav_16k), np.int32)
        else:
            raise ValueError("no speech tokenizer available; pass precomputed_speech_tokens")

        if precomputed_embedding is not None:
            embedding = np.asarray(precomputed_embedding, np.float32)
        elif self.spk_embedding_fn is not None:
            with self.timer.stage("prompt_embedding"):
                embedding = np.asarray(self.spk_embedding_fn(prompt_wav_16k), np.float32)
        else:
            raise ValueError("no speaker embedding model; pass precomputed_embedding")

        # feat == ratio x tokens (frontend.py:498-502); a ratio of 0 means no trim
        ratio = cfg.token_mel_ratio
        if ratio:
            token_len = min(feat.shape[0] // ratio, len(speech_tokens))
            feat = feat[: ratio * token_len]
            speech_tokens = speech_tokens[:token_len]
        return {
            "prompt_feat": feat.astype(np.float32),
            "speech_tokens": speech_tokens,
            "embedding": embedding,
            "prompt_text": prompt_text,
        }

    def frontend_zero_shot(self, text: str, prompt: dict) -> PromptInputs:
        """Zero-shot: the prompt transcription conditions the LM."""
        return PromptInputs(
            text_tokens=self.text_tokens(text),
            prompt_text_tokens=self.text_tokens(prompt.get("prompt_text", "") or ""),
            llm_prompt_speech_tokens=prompt["speech_tokens"],
            flow_prompt_speech_tokens=prompt["speech_tokens"],
            prompt_feat=prompt["prompt_feat"],
            embedding=prompt["embedding"],
        )

    def frontend_cross_lingual(self, text: str, prompt: dict) -> PromptInputs:
        """Cross-lingual: drop the prompt text and the LM's prompt speech
        tokens; the flow keeps them for timbre."""
        return PromptInputs(
            text_tokens=self.text_tokens(text),
            prompt_text_tokens=np.zeros((0,), np.int32),
            llm_prompt_speech_tokens=np.zeros((0,), np.int32),
            flow_prompt_speech_tokens=prompt["speech_tokens"],
            prompt_feat=prompt["prompt_feat"],
            embedding=prompt["embedding"],
        )

    def frontend_instruct2(self, text: str, instruct_text: str, prompt: dict) -> PromptInputs:
        """Instruct2: the instruction and ``<|endofprompt|>`` as the prompt
        text; the LM gets no prompt speech tokens."""
        return PromptInputs(
            text_tokens=self.text_tokens(text),
            prompt_text_tokens=self.text_tokens(instruct_text + "<|endofprompt|>"),
            llm_prompt_speech_tokens=np.zeros((0,), np.int32),
            flow_prompt_speech_tokens=prompt["speech_tokens"],
            prompt_feat=prompt["prompt_feat"],
            embedding=prompt["embedding"],
        )

    # -- cached speakers --------------------------------------------------

    def add_zero_shot_spk(self, spk_id: str, prompt: dict) -> bool:
        self.spk_info[spk_id] = prompt
        return True

    def get_spk(self, spk_id: str) -> dict:
        return self.spk_info[spk_id]

    def save_spk_info(self, path: str) -> None:
        """Write the store as ``.npz``: one array per (speaker, artifact),
        strings stored as 0-d string arrays."""
        flat = {}
        for spk, art in self.spk_info.items():
            for k, v in art.items():
                if isinstance(v, np.ndarray):
                    flat[f"{spk}::{k}"] = v
                else:
                    flat[f"{spk}::{k}::str"] = np.asarray(str(v))
        np.savez(path, **flat)

    def load_spk_info(self, path: str) -> None:
        """Load a store: this package's ``.npz`` or the reference's
        ``spk2info.pt`` (a dict of per-speaker dicts of tensors, its keys
        mapped onto the artifact names)."""
        if path.endswith(".pt"):
            data = torch.load(path, map_location="cpu", weights_only=True)
            names = {"speech_feat": "prompt_feat", "speech_token": "speech_tokens",
                     "llm_embedding": "embedding", "flow_embedding": "embedding"}
            for spk, art in data.items():
                out = {}
                for k, v in art.items():
                    arr = v.numpy() if torch.is_tensor(v) else v
                    key = names.get(k, k)
                    if key in ("speech_tokens", "embedding") and getattr(arr, "ndim", 0) > 1 \
                            and arr.shape[0] == 1:
                        arr = arr.squeeze(0)
                    if key == "prompt_feat" and getattr(arr, "ndim", 0) == 3:
                        arr = arr[0]
                    out[key] = arr
                out.setdefault("prompt_text", "")
                self.spk_info[spk] = out
            return
        with np.load(path, allow_pickle=False) as data:
            for key in data.files:
                parts = key.split("::")
                art = self.spk_info.setdefault(parts[0], {})
                art[parts[1]] = str(data[key]) if len(parts) == 3 else data[key]


def make_speech_tokenizer_fn(params: dict, cfg=None, device: str | torch.device = "cuda"):
    """16 kHz wav -> FSQ codes through ``models/speech_tokenizer.py`` on
    ``device`` (the role of the reference's speech_tokenizer_v2.onnx session,
    frontend.py:262-274).  ``params``: numpy arrays or tensors, kept in fp32.
    A wav longer than 30 s raises ``ValueError``."""
    from cosyvoice2_eu_torch.models import speech_tokenizer as st
    from cosyvoice2_eu_torch.ops.mel import whisper_log_mel

    dev = resolve_device(device)
    cfg = cfg or st.SpeechTokenizerConfig()
    params = params_from_numpy(params, dev)

    @torch.inference_mode()
    def fn(wav_16k: np.ndarray) -> np.ndarray:
        if len(wav_16k) > MAX_PROMPT_SAMPLES_16K:
            raise ValueError(f"prompt must be <= 30 s, got {len(wav_16k) / 16000:.2f} s")
        mel = whisper_log_mel(_wav_tensor(wav_16k, dev), n_mels=cfg.n_mels)
        t = mel.shape[-1] - mel.shape[-1] % cfg.downsample  # downsample alignment
        codes, code_len = st.encode(params, cfg, mel[:, :, :t],
                                    torch.tensor([t], device=dev))
        return codes[0, : int(code_len[0])].cpu().numpy()

    return fn


def make_spk_embedding_fn(params: dict, cfg=None, device: str | torch.device = "cuda"):
    """16 kHz wav -> x-vector through ``models/campplus.py`` on ``device``
    (the role of the reference's campplus.onnx session, frontend.py:276-283).
    ``params``: numpy arrays or tensors, kept in fp32."""
    from cosyvoice2_eu_torch.models import campplus as cam

    dev = resolve_device(device)
    cfg = cfg or cam.CAMPPlusConfig()
    params = params_from_numpy(params, dev)

    @torch.inference_mode()
    def fn(wav_16k: np.ndarray) -> np.ndarray:
        fbank = cam.kaldi_fbank_cmn(_wav_tensor(wav_16k, dev), cfg.feat_dim)
        return cam.campplus_forward(params, cfg, fbank)[0].cpu().numpy()

    return fn
