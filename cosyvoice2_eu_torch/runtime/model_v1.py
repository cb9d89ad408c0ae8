"""The v1 (CosyVoice-300M) inference orchestrator, in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/runtime/model_v1.py`` (the reference's
CosyVoiceModel).  It differs from the v2 ``TTSModel`` in three ways: the flow
is MaskedDiffWithXvec with a z/mu cache pinned across chunks
(``models/flow_v1.py``); chunk boundaries are crossfaded in mel space with a
Hamming window before HiFT, besides the source-cache splice both share; and
streaming takes a growing token hop (2 to 4 x the frame rate) with a 20-token
overlap.  The whole model runs in fp32, so on the card the v1 estimator
launches K1's fp32 design, 64 times an estimator call.

As in the JAX package, the LM decodes every token first (bucketed on
``GEN_BUCKETS`` and the prompt buckets of ``runtime/model.py``); streaming
then yields token2wav chunks, chunk for chunk what the reference's scheduler
makes.  HiFT runs on the mel padded by its last frame to a ``HIFT_BUCKETS``
length.  Random draws come from ``self.generator`` unless the caller passes
them: ``lm_draws(step)``, ``flow_noise(shape)`` once per flow call and
``hift_draws(batch, length, harmonics)`` once per HiFT call.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np
import torch

from cosyvoice2_eu_torch.config import TTSV1Config
from cosyvoice2_eu_torch.models.flow_v1 import flow_v1_inference, mel_len_for_tokens
from cosyvoice2_eu_torch.models.hift import hift_inference
from cosyvoice2_eu_torch.models.llm_v1 import lm_v1_decode
from cosyvoice2_eu_torch.runtime.model import HiftDraws, bucket_for
from cosyvoice2_eu_torch.utils.device import resolve_device
from cosyvoice2_eu_torch.utils.params import params_from_numpy
from cosyvoice2_eu_torch.utils.profiling import StageTimer

HIFT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)
GEN_BUCKETS = (64, 128, 256, 512, 1024, 2048)

FlowNoise = Callable[[tuple], torch.Tensor]


def _fade_last_axis(fade_in: np.ndarray, fade_out: np.ndarray, window: np.ndarray) -> np.ndarray:
    """Hamming crossfade over the trailing axis."""
    ov = window.shape[0] // 2
    out = fade_in.copy()
    out[..., :ov] = fade_in[..., :ov] * window[:ov] + fade_out[..., -ov:] * window[ov:]
    return out


class CosyVoice1Model:
    """llm.pt + flow.pt + hift.pt (v1) -> waveform, streaming or not.

    params: {"llm", "flow", "hift"} trees of numpy arrays or tensors (from
    ``runtime/checkpoint_v1.py``'s converters and ``convert_hift``, or the
    ``init_*`` functions), moved to ``device`` in fp32.  ``device`` defaults
    to "cuda" and raises without a GPU; "cpu" runs the plain path.
    """

    def __init__(self, cfg: TTSV1Config, params: dict, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params_from_numpy(params, self.device, torch.float32)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.mel_window = np.hamming(2 * cfg.mel_overlap_len)
        self.speech_window = np.hamming(2 * cfg.source_cache_len)
        self.timer = StageTimer(
            sync=torch.cuda.synchronize if self.device.type == "cuda" else None)
        self.last_n_tokens = 0  # speech tokens of the last lm_decode
        self.last_decode_steps = 0

    def _tensor(self, a, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device, dtype)

    # -- stages ------------------------------------------------------------

    @torch.inference_mode()
    def lm_decode(self, text_tokens: np.ndarray, prompt_text_tokens: np.ndarray,
                  prompt_speech_tokens: np.ndarray, embedding: Optional[np.ndarray],
                  max_gen: int = 0, lm_draws=None) -> np.ndarray:
        """Speech tokens for prompt_text ++ text.  ``embedding`` None drops
        the LM's speaker slot (v1 instruct mode)."""
        cfg = self.cfg.llm
        use_spk = embedding is not None
        if embedding is None:
            embedding = np.zeros(cfg.spk_embed_dim, np.float32)
        text = np.concatenate([prompt_text_tokens, text_tokens]).astype(np.int64)
        # JAX's embedding gather fills NaN past a table's end; torch's indexing fails
        for ids, size, what in ((text, cfg.text_token_size, "text"),
                                (prompt_speech_tokens, cfg.speech_token_size, "speech")):
            if len(ids) and int(np.max(ids)) >= size:
                raise ValueError(f"{what} token {int(np.max(ids))} is outside the LM's "
                                 f"{what} vocabulary of {size}")
        tt, ts = len(text), len(prompt_speech_tokens)
        if not max_gen:
            max_gen = min(int(len(text_tokens) * cfg.max_token_text_ratio) + 1, 2048)
        # the decode's capacity is the bucket; the per-text cap is inside
        # lm_v1_decode (max_token_text_ratio) and in the trim below
        gen_b = bucket_for(max_gen, buckets=GEN_BUCKETS)
        tt_b, ts_b = bucket_for(tt), bucket_for(max(ts, 1))
        text_arr = np.zeros((1, tt_b), np.int64)
        text_arr[0, :tt] = text
        sp_arr = np.zeros((1, ts_b), np.int64)
        sp_arr[0, :ts] = prompt_speech_tokens
        with self.timer.stage("lm_decode"):
            tokens, lengths, steps = lm_v1_decode(
                self.params["llm"], cfg, self._tensor(text_arr), self._tensor([tt]),
                self._tensor([len(prompt_text_tokens)]), self._tensor(sp_arr), self._tensor([ts]),
                self._tensor(np.asarray(embedding, np.float32)[None], torch.float32), gen_b,
                use_spk=use_spk, generator=self.generator, draws=lm_draws)
            n = min(int(lengths[0]), max_gen)
            out = tokens[0, :n].cpu().numpy().astype(np.int32)
        self.last_n_tokens, self.last_decode_steps = n, steps
        return out

    @torch.inference_mode()
    def token2wav(self, token: np.ndarray, prompt_token: np.ndarray, prompt_feat: np.ndarray,
                  embedding: np.ndarray, session: dict, finalize: bool = False,
                  speed: float = 1.0, flow_noise: Optional[FlowNoise] = None,
                  hift_draws: Optional[HiftDraws] = None) -> np.ndarray:
        """One flow + HiFT chunk; ``session`` carries the flow cache, the mel
        overlap and the HiFT cache between chunks."""
        cfg = self.cfg
        cache = session.get("flow_cache")
        total = prompt_feat.shape[0] + mel_len_for_tokens(cfg.flow, len(token))
        z = None if flow_noise is None else flow_noise((1, cfg.flow.output_size, total))
        with self.timer.stage("flow"):
            mel, new_cache = flow_v1_inference(
                self.params["flow"], cfg.flow, self._tensor(token[None]),
                self._tensor(prompt_token[None]), self._tensor(prompt_feat[None], torch.float32),
                self._tensor(np.asarray(embedding, np.float32)[None], torch.float32),
                flow_cache=None if cache is None else self._tensor(cache, torch.float32),
                z=z, generator=self.generator)
            tts_mel = mel.float().cpu().numpy()  # (1, 80, mel_len2)
        session["flow_cache"] = new_cache.float().cpu().numpy()

        # mel-space crossfade with the previous chunk's tail
        overlap = session.get("mel_overlap")
        if overlap is not None and overlap.shape[2]:
            tts_mel = _fade_last_axis(tts_mel, overlap, self.mel_window)
        hift_cache = session.get("hift_cache")
        if hift_cache is not None:
            tts_mel = np.concatenate([hift_cache["mel"], tts_mel], axis=2)
            cache_source = hift_cache["source"]
        else:
            cache_source = np.zeros((1, 1, 0), np.float32)
        if not finalize:
            session["mel_overlap"] = tts_mel[:, :, -cfg.mel_overlap_len:]
            tts_mel = tts_mel[:, :, :-cfg.mel_overlap_len]
        elif speed != 1.0:
            if hift_cache is not None:
                raise ValueError("speed change only supports non-stream mode")
            n_mel = tts_mel.shape[2]
            xq = np.linspace(0, n_mel - 1, int(n_mel / speed))
            xp = np.arange(n_mel)
            tts_mel = np.stack([np.stack([np.interp(xq, xp, row) for row in ch])
                                for ch in tts_mel]).astype(np.float32)

        # HiFT on the mel padded by its last frame to a bucket
        n_mel = tts_mel.shape[2]
        h_bucket = bucket_for(n_mel, buckets=HIFT_BUCKETS)
        mel_in = np.concatenate([tts_mel, np.repeat(tts_mel[:, :, -1:], h_bucket - n_mel, axis=2)],
                                axis=2)
        c_len = cache_source.shape[2]
        cache_buf = np.zeros((1, 1, cfg.source_cache_len), np.float32)
        cache_buf[:, :, :c_len] = cache_source
        length = h_bucket * cfg.hift.upsample_scale
        draws = None if hift_draws is None else tuple(
            x.to(self.device) for x in hift_draws(1, length, cfg.hift.nb_harmonics + 1))
        with self.timer.stage("hift"):
            audio, source = hift_inference(
                self.params["hift"], cfg.hift, self._tensor(mel_in, torch.float32),
                generator=self.generator, draws=draws,
                cache_source=self._tensor(cache_buf, torch.float32), cache_len=c_len)
            n = n_mel * cfg.hift.upsample_scale
            audio = audio.float().cpu().numpy()[0, :n]
            source = source.float().cpu().numpy()[:, :, :n]

        if not finalize:
            if hift_cache is not None:
                audio = _fade_last_axis(audio, hift_cache["speech"], self.speech_window)
            session["hift_cache"] = {"mel": tts_mel[:, :, -cfg.mel_cache_len:],
                                     "source": source[:, :, -cfg.source_cache_len:],
                                     "speech": audio[-cfg.source_cache_len:]}
            audio = audio[:-cfg.source_cache_len]
        elif hift_cache is not None:
            audio = _fade_last_axis(audio, hift_cache["speech"], self.speech_window)
        return audio

    # -- public API ----------------------------------------------------------

    def _chunks(self, speech_tokens, prompt_token, prompt_feat, embedding, speed,
                flow_noise, hift_draws) -> Iterator[np.ndarray]:
        """The reference's streaming schedule: a growing hop, a 20-token
        overlap, one finalizing tail."""
        cfg = self.cfg
        session: dict = {}
        hop, pos = cfg.token_min_hop_len, 0
        while len(speech_tokens) - pos >= hop + cfg.token_overlap_len:
            chunk = speech_tokens[pos: pos + hop + cfg.token_overlap_len]
            yield self.token2wav(chunk, prompt_token, prompt_feat, embedding, session,
                                 finalize=False, flow_noise=flow_noise, hift_draws=hift_draws)
            pos += hop
            hop = min(cfg.token_max_hop_len, int(hop * cfg.stream_scale_factor))
        yield self.token2wav(speech_tokens[pos:], prompt_token, prompt_feat, embedding, session,
                             finalize=True, speed=speed, flow_noise=flow_noise,
                             hift_draws=hift_draws)

    def _synthesize(self, tokens, prompt_token, prompt_feat, embedding, stream, speed,
                    flow_noise, hift_draws) -> Iterator[np.ndarray]:
        prompt_token = np.asarray(prompt_token, np.int64)
        prompt_feat = np.asarray(prompt_feat, np.float32)
        embedding = np.asarray(embedding, np.float32)
        if stream:
            yield from self._chunks(tokens, prompt_token, prompt_feat, embedding, speed,
                                    flow_noise, hift_draws)
        else:
            yield self.token2wav(tokens, prompt_token, prompt_feat, embedding, {}, finalize=True,
                                 speed=speed, flow_noise=flow_noise, hift_draws=hift_draws)

    def tts(self, text_tokens: np.ndarray, prompt_text_tokens: np.ndarray,
            prompt_speech_tokens: np.ndarray, prompt_feat: np.ndarray, embedding: np.ndarray,
            stream: bool = False, speed: float = 1.0, max_gen: int = 0, *,
            llm_prompt_speech_tokens: Optional[np.ndarray] = None, llm_embedding="shared",
            lm_draws=None, flow_noise: Optional[FlowNoise] = None,
            hift_draws: Optional[HiftDraws] = None) -> Iterator[np.ndarray]:
        """Text -> LM -> flow -> HiFT.  Returns an iterator of waveform
        chunks (one when ``stream`` is False); the LM runs before it returns.

        ``llm_prompt_speech_tokens`` replaces the LM's prompt tokens (cross
        lingual passes an empty array while the flow keeps them);
        ``llm_embedding`` is the LM's speaker embedding: "shared" reuses
        ``embedding``, None drops the speaker slot (instruct mode)."""
        lm_emb = embedding if isinstance(llm_embedding, str) else llm_embedding
        lm_prompt = (prompt_speech_tokens if llm_prompt_speech_tokens is None
                     else llm_prompt_speech_tokens)
        tokens = self.lm_decode(np.asarray(text_tokens), np.asarray(prompt_text_tokens),
                                np.asarray(lm_prompt), lm_emb, max_gen, lm_draws)
        return self._synthesize(tokens, prompt_speech_tokens, prompt_feat, embedding, stream,
                                speed, flow_noise, hift_draws)

    def vc(self, source_speech_tokens: np.ndarray, prompt_speech_tokens: np.ndarray,
           prompt_feat: np.ndarray, embedding: np.ndarray, stream: bool = False,
           speed: float = 1.0, *, flow_noise: Optional[FlowNoise] = None,
           hift_draws: Optional[HiftDraws] = None) -> Iterator[np.ndarray]:
        """Voice conversion: the source's speech tokens straight to token2wav."""
        return self._synthesize(np.asarray(source_speech_tokens, np.int64), prompt_speech_tokens,
                                prompt_feat, embedding, stream, speed, flow_noise, hift_draws)
