"""TTS pipeline orchestrator: LM decode -> flow mel -> HiFT waveform, in PyTorch.

Counterpart of the non-streaming path of ``cosyvoice2_eu_tpu/runtime/model.py``.
Prompts and token streams are right-padded to the same buckets as the JAX
package, so the same inputs take the same shapes (and, with injected random
draws, give the same tokens and waveform).  Dtype policy: bf16 for the LM and
the flow, fp32 for HiFT and for the flow's fixed noise.

``lm_quant="int8"`` quantizes the LM's projections per output channel
after the cast to the compute dtype; on the card they run through kernel K2.
``tts_batch`` synthesizes several prompts in one batched LM decode, flow and
HiFT call.

Not ported yet, and raising ``NotImplementedError``: streaming
(``stream=True``, ROADMAP item 7), synthesis past the largest flow bucket
(the JAX package's windowed fallback, item 7), bistream decode (item 11)
and tensor-parallel decode (item 13).  ``vc`` (item 9) has no counterpart
yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Generator, Optional

import numpy as np
import torch

from cosyvoice2_eu_torch.config import TTSConfig
from cosyvoice2_eu_torch.models import llm as llm_mod
from cosyvoice2_eu_torch.models.flow import flow_inference
from cosyvoice2_eu_torch.models.hift import hift_inference
from cosyvoice2_eu_torch.utils.device import resolve_device
from cosyvoice2_eu_torch.utils.params import cast_floating, quantize_lm_params, tree_map
from cosyvoice2_eu_torch.utils.profiling import StageTimer

TOKEN_BUCKETS = (64, 128, 256, 512, 1024)
# finer buckets for the flow: the estimator's attention cost is quadratic in
# the mel bucket
FLOW_TOKEN_BUCKETS = (64, 128, 192, 256, 384, 512, 640, 768, 896, 1024)
HIFT_MEL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)

# hift_draws(batch, length, harmonics) -> (rand_ini (B, H), noise (B, L, H))
HiftDraws = Callable[[int, int, int], "tuple[torch.Tensor, torch.Tensor]"]


def bucket_for(n: int, buckets=TOKEN_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds max bucket {buckets[-1]}")


@dataclass
class PromptInputs:
    """Host-side prompt artifacts (produced by the frontend)."""

    text_tokens: np.ndarray  # (T_text,) target text -> backbone ids
    prompt_text_tokens: np.ndarray  # (T_ptext,) prompt transcription ids
    llm_prompt_speech_tokens: np.ndarray  # (T_sp,) speech codes for the LM
    flow_prompt_speech_tokens: np.ndarray  # (T_sp,) speech codes for the flow
    prompt_feat: np.ndarray  # (T_mel, 80) prompt mel (2x speech tokens)
    embedding: np.ndarray  # (192,) x-vector


def _to_device(tree, device):
    return tree_map(lambda a: (a if torch.is_tensor(a) else torch.tensor(np.asarray(a)))
                    .to(device), tree)


class TTSModel:
    def __init__(self, cfg: TTSConfig, params: dict, seed: int = 0,
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                 device: str | torch.device = "cuda", lm_quant: Optional[str] = None,
                 use_bistream: bool = False, tp: int = 0):
        """params: {"llm", "flow", "hift"} trees of tensors or numpy arrays.
        compute_dtype: dtype of the LM and flow (None keeps the parameters'
        own); HiFT and the flow's fixed noise stay fp32.
        lm_quant: None, or "int8" for per-channel int8 LM projections, taken
        from the weights after the cast to compute_dtype (fp32 scales)."""
        if lm_quant not in (None, "int8"):
            raise ValueError(f"unknown lm_quant {lm_quant!r}: expected None or 'int8'")
        if use_bistream:
            raise NotImplementedError("bistream decode is not ported yet: ROADMAP item 11")
        if tp:
            raise NotImplementedError("tensor-parallel decode is not ported yet: ROADMAP item 13")
        self.cfg = cfg
        self.device = resolve_device(device)
        params = _to_device(params, self.device)
        if compute_dtype is not None:
            flow = cast_floating({k: v for k, v in params["flow"].items() if k != "rand_noise"},
                                 compute_dtype)
            flow["rand_noise"] = params["flow"]["rand_noise"].float()
            params = {"llm": cast_floating(params["llm"], compute_dtype), "flow": flow,
                      "hift": params["hift"]}
        if lm_quant == "int8":
            params = dict(params, llm=quantize_lm_params(params["llm"]))
        self.params = params
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.timer = StageTimer(
            sync=torch.cuda.synchronize if self.device.type == "cuda" else None)
        self.last_n_tokens = 0  # speech tokens generated by the last tts call
        self.last_batch_tokens: list = []  # per prompt, by the last tts_batch call
        self.last_decode_steps = 0  # decode steps of the last tts or tts_batch call
        self.pre_lookahead_len = cfg.stream.pre_lookahead_len

    # ------------------------------------------------------------------
    # host-side helpers
    # ------------------------------------------------------------------

    def _pack_lm_prompt(self, p: PromptInputs):
        """[sos, prompt_text, text, task_id, prompt_speech] as (ids, src)."""
        cfg = self.cfg.llm
        text = np.concatenate([p.prompt_text_tokens, p.text_tokens]).astype(np.int32)
        n_text, n_sp = len(text), len(p.llm_prompt_speech_tokens)
        total = 1 + n_text + 1 + n_sp
        p_bucket = bucket_for(total)
        ids = np.zeros((1, p_bucket), np.int32)
        src = np.zeros((1, p_bucket), np.int32)
        ids[0, 0], src[0, 0] = cfg.sos_eos, llm_mod.SRC_SPECIAL
        ids[0, 1: 1 + n_text], src[0, 1: 1 + n_text] = text, llm_mod.SRC_TEXT
        ids[0, 1 + n_text], src[0, 1 + n_text] = cfg.task_id, llm_mod.SRC_SPECIAL
        if n_sp:
            ids[0, 2 + n_text: total] = p.llm_prompt_speech_tokens
            src[0, 2 + n_text: total] = llm_mod.SRC_SPEECH
        n_target_text = len(p.text_tokens)
        min_len = int(n_target_text * cfg.min_token_text_ratio)
        max_len = int(n_target_text * cfg.max_token_text_ratio)
        return ids, src, total, p_bucket, min_len, max_len

    def _tensor(self, a, dtype=torch.long):
        return torch.as_tensor(np.asarray(a)).to(self.device, dtype)

    def _finalize_full(self, tokens: np.ndarray, p: PromptInputs, session: dict,
                       speed: float = 1.0, hift_draws: Optional[HiftDraws] = None) -> np.ndarray:
        """One-shot non-streaming synthesis of the generated tokens."""
        n_prompt = len(p.flow_prompt_speech_tokens)
        if n_prompt + len(tokens) > FLOW_TOKEN_BUCKETS[-1]:
            raise NotImplementedError(
                f"{n_prompt} prompt + {len(tokens)} generated tokens exceed the largest flow "
                f"bucket ({FLOW_TOKEN_BUCKETS[-1]}); the windowed streaming fallback is not "
                "ported yet: ROADMAP item 7")
        return self._token2wav(tokens, p, 0, session, False, True, speed, hift_draws)

    def _token2wav(self, all_tokens: np.ndarray, p: PromptInputs, token_offset: int,
                   session: dict, stream: bool, finalize: bool, speed: float = 1.0,
                   hift_draws: Optional[HiftDraws] = None) -> np.ndarray:
        """flow + hift for one chunk."""
        cfg = self.cfg
        ratio = cfg.flow.token_mel_ratio
        prompt_tok = p.flow_prompt_speech_tokens.astype(np.int32)
        tokens = np.concatenate([prompt_tok, all_tokens.astype(np.int32)])
        total = len(tokens)
        tok_bucket = bucket_for(total, buckets=FLOW_TOKEN_BUCKETS)
        tok_arr = np.zeros((1, tok_bucket), np.int32)
        tok_arr[0, :total] = tokens

        prompt_mel_len = p.prompt_feat.shape[0]
        mel_bucket = tok_bucket * ratio
        feat = np.zeros((1, mel_bucket, cfg.flow.output_size), np.float32)
        feat[0, :prompt_mel_len] = p.prompt_feat

        with self.timer.stage("flow"):
            mel = flow_inference(
                self.params["flow"], cfg.flow,
                self._tensor(tok_arr), self._tensor([total]),
                self._tensor(feat, torch.float32), self._tensor([prompt_mel_len]),
                self._tensor(np.asarray(p.embedding)[None], torch.float32),
                streaming=stream, finalize=finalize,
            )
            mel_valid = total * ratio if finalize else (total - self.pre_lookahead_len) * ratio
            tts_mel = mel[:, :, prompt_mel_len + token_offset * ratio: mel_valid]
        return self._hift_chunk(tts_mel, session, finalize, speed, hift_draws)

    def _hift_chunk(self, tts_mel: torch.Tensor, session: dict, finalize: bool,
                    speed: float = 1.0, hift_draws: Optional[HiftDraws] = None) -> np.ndarray:
        """Vocode one mel chunk: edge-replicate to the HiFT bucket, run HiFT,
        cut to the valid samples."""
        if not finalize or session.get("hift_cache") is not None:
            raise NotImplementedError("streaming vocoder caches are not ported yet: "
                                      "ROADMAP item 7")
        if speed != 1.0:
            # linear mel interpolation for speed control
            mel_np = tts_mel.float().cpu().numpy()
            T = mel_np.shape[2]
            xp = np.linspace(0, T - 1, T)
            xq = np.linspace(0, T - 1, int(T / speed))
            mel_np = np.stack(
                [np.stack([np.interp(xq, xp, row) for row in ch]) for ch in mel_np]
            ).astype(np.float32)
            tts_mel = torch.as_tensor(mel_np, device=self.device)

        t_mel = int(tts_mel.shape[2])
        h_bucket = bucket_for(t_mel, buckets=HIFT_MEL_BUCKETS)
        edge = tts_mel[:, :, t_mel - 1:t_mel].expand(-1, -1, h_bucket - t_mel)
        mel_in = torch.cat([tts_mel, edge], dim=2).float()
        hcfg = self.cfg.hift
        draws = None
        if hift_draws is not None:
            draws = hift_draws(1, h_bucket * hcfg.upsample_scale, hcfg.nb_harmonics + 1)
        with self.timer.stage("hift"):
            audio, _ = hift_inference(self.params["hift"], hcfg, mel_in,
                                      generator=self.generator, draws=draws)
            audio = audio[0, : t_mel * hcfg.upsample_scale].cpu().numpy()
        return audio

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def tts(
        self,
        prompt: PromptInputs,
        stream: bool = False,
        speed: float = 1.0,
        lm_draws: Optional[llm_mod.Draws] = None,
        hift_draws: Optional[HiftDraws] = None,
    ) -> Generator[np.ndarray, None, None]:
        """Yield waveform chunks (float32 at cfg.sample_rate).

        lm_draws / hift_draws inject the random draws (see ``lm_decode`` and
        ``sine_source``); by default they come from ``self.generator``.
        """
        if stream:
            raise NotImplementedError("stream=True is not ported yet: ROADMAP item 7")
        ids, src, prompt_len, p_bucket, min_len, max_len = self._pack_lm_prompt(prompt)
        # round up to a multiple of 64, capped by the KV-cache capacity
        max_gen = min(((max_len + 63) // 64) * 64, self.cfg.llm.max_seq_len - p_bucket)
        session: dict = {"hift_cache": None}

        with self.timer.stage("lm_decode"):
            tokens, lengths, self.last_decode_steps = llm_mod.lm_decode(
                self.params["llm"], self.cfg.llm, self._tensor(ids), self._tensor(src),
                self._tensor([prompt_len]), self._tensor([min_len]), self._tensor([max_len]),
                max_gen, generator=self.generator, draws=lm_draws,
            )
            n = int(lengths[0])
            tokens = tokens[0, :n].cpu().numpy()
        self.last_n_tokens = n
        yield self._finalize_full(tokens, prompt, session, speed, hift_draws)

    def tts_batch(
        self,
        prompts: list,
        speed: float = 1.0,
        lm_draws: Optional[llm_mod.Draws] = None,
        hift_draws: Optional[HiftDraws] = None,
    ) -> list:
        """Batched non-streaming synthesis: one float32 waveform per prompt.

        The prompts pack into a shared LM bucket and decode together; the
        flow runs once on a shared token bucket with per-row prompt and feat
        lengths, HiFT on the shared mel bucket in sub-batches padded with
        the last row.  As in the JAX package, ``speed`` reaches only the
        per-row path taken when a row exceeds the largest flow bucket.
        ``lm_draws`` serves the whole batch as in ``tts``; ``hift_draws`` is
        called once per HiFT sub-batch, in order.
        """
        cfg = self.cfg
        n = len(prompts)
        packs = [self._pack_lm_prompt(p) for p in prompts]
        p_bucket = max(pk[3] for pk in packs)
        ids = np.zeros((n, p_bucket), np.int32)
        src = np.zeros((n, p_bucket), np.int32)
        prompt_len, min_len, max_len = (np.zeros((n,), np.int32) for _ in range(3))
        for i, (pi, si, total, _, mn, mx) in enumerate(packs):
            ids[i, : pi.shape[1]], src[i, : si.shape[1]] = pi[0], si[0]
            prompt_len[i], min_len[i], max_len[i] = total, mn, mx
        max_gen = min(((int(max_len.max()) + 63) // 64) * 64, cfg.llm.max_seq_len - p_bucket)
        with self.timer.stage("lm_decode"):
            tokens, lengths, self.last_decode_steps = llm_mod.lm_decode(
                self.params["llm"], cfg.llm, self._tensor(ids), self._tensor(src),
                self._tensor(prompt_len), self._tensor(min_len), self._tensor(max_len),
                max_gen, generator=self.generator, draws=lm_draws,
            )
            tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
        self.last_batch_tokens = [int(x) for x in lengths]

        ratio = cfg.flow.token_mel_ratio
        totals = [len(p.flow_prompt_speech_tokens) + int(lengths[i]) for i, p in enumerate(prompts)]
        if max(totals) > FLOW_TOKEN_BUCKETS[-1]:
            # per-row synthesis, which raises past the largest flow bucket
            return [self._finalize_full(tokens[i, : lengths[i]], prompts[i], {"hift_cache": None},
                                        speed, hift_draws) for i in range(n)]
        tok_bucket = bucket_for(max(totals), buckets=FLOW_TOKEN_BUCKETS)
        tok_arr = np.zeros((n, tok_bucket), np.int32)
        feat = np.zeros((n, tok_bucket * ratio, cfg.flow.output_size), np.float32)
        feat_len = np.zeros((n,), np.int32)
        emb = np.stack([np.asarray(p.embedding, np.float32) for p in prompts])
        for i, p in enumerate(prompts):
            sp = p.flow_prompt_speech_tokens
            tok_arr[i, : len(sp)] = sp
            tok_arr[i, len(sp): totals[i]] = tokens[i, : lengths[i]]
            feat[i, : p.prompt_feat.shape[0]] = p.prompt_feat
            feat_len[i] = p.prompt_feat.shape[0]
        with self.timer.stage("flow"):
            mel = flow_inference(
                self.params["flow"], cfg.flow, self._tensor(tok_arr), self._tensor(totals),
                self._tensor(feat, torch.float32), self._tensor(feat_len),
                self._tensor(emb, torch.float32), streaming=False, finalize=True,
            )

        # HiFT on the shared mel bucket, each row edge-replicated on the device
        mel_lens = [totals[i] * ratio - int(feat_len[i]) for i in range(n)]
        h_bucket = bucket_for(max(mel_lens), buckets=HIFT_MEL_BUCKETS)
        rows = []
        for i in range(n):
            seg = mel[i, :, int(feat_len[i]): totals[i] * ratio]
            rows.append(torch.cat([seg, seg[:, -1:].expand(-1, h_bucket - seg.shape[1])], dim=1))
        mel_in = torch.stack(rows)
        hcfg = cfg.hift
        # the vocoder's activations grow with the bucket: sub-batches bound the memory
        sub = max(1, min(n, int(4 * 2048 / h_bucket)))
        cache = torch.zeros((sub, 1, cfg.stream.source_cache_len), device=self.device)
        out = []
        for lo in range(0, n, sub):
            hi = min(lo + sub, n)
            mel_g = mel_in[lo:hi]
            if hi - lo < sub:
                mel_g = torch.cat([mel_g, mel_g[-1:].expand(sub - (hi - lo), -1, -1)])
            draws = None
            if hift_draws is not None:
                draws = hift_draws(sub, h_bucket * hcfg.upsample_scale, hcfg.nb_harmonics + 1)
            with self.timer.stage("hift"):
                audio, _ = hift_inference(self.params["hift"], hcfg, mel_g,
                                          generator=self.generator, draws=draws,
                                          cache_source=cache, cache_len=0)
                out.extend(audio[i - lo, : mel_lens[i] * hcfg.upsample_scale].cpu().numpy()
                           for i in range(lo, hi))
        return out


def _fade_in_out(fade_in: np.ndarray, fade_out: np.ndarray, window: np.ndarray) -> np.ndarray:
    """Hamming crossfade of chunk boundaries (used by streaming, ROADMAP item 7)."""
    ov = window.shape[0] // 2
    out = fade_in.copy()
    out[:ov] = fade_in[:ov] * window[:ov] + fade_out[-ov:] * window[ov:]
    return out
