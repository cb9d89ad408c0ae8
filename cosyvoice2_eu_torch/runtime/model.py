"""TTS pipeline orchestrator: LM decode -> flow mel -> HiFT waveform, in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/runtime/model.py``.  Prompts and token
streams are right-padded to the same buckets as the JAX package, so the same
inputs take the same shapes (and, with injected random draws, give the same
tokens and waveform).  Dtype policy: bf16 for the LM and the flow, fp32 for
HiFT and for the flow's fixed noise.

``lm_quant="int8"`` quantizes the LM's projections per output channel
after the cast to the compute dtype; on the card they run through kernel K2.
``tts_batch`` synthesizes several prompts in one batched LM decode, flow and
HiFT call.

Streaming (``tts(stream=True)``) decodes the LM hop by hop
(``lm_decode_chunk``) and vocodes each chunk with the reference's vocoder
cache (mel and source tails, Hamming crossfade).  ``cached_stream=True``
feeds the chunk-cached flow (``models/flow_streaming.py``, O(T) per chunk);
``cached_stream=False`` recomputes the whole prefix per chunk, as the
reference does.  The final chunk is a full recompute on either path.

Past the largest flow bucket, synthesis runs the streaming schedule and
joins its chunks: under ``cached_stream=True`` through the serving path's
``StreamSession`` (``serving/engine.py``), otherwise through the windowed
recompute loop.  ``_stream_chunk_batch`` is the serving engine's steady
chunk over several sessions at once.  ``vc`` re-synthesizes source speech
tokens in the prompt's voice without the LM.

``use_bistream=True`` routes ``tts`` through the LM's fill-token protocol
(``lm_inference_bistream``), feeding the target text in ``mix_ratio[0]``-token
pieces, as the reference does for backbones other than BlankEN;
``tts_stream_text`` takes text pieces as they arrive.  As in the JAX
package, ``tts_batch``, ``vc`` and the serving engine do not route through
it.

Not ported yet, and raising ``NotImplementedError``: tensor-parallel decode
(ROADMAP item 8g).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Generator, Optional

import numpy as np
import torch

from cosyvoice2_eu_torch.config import TTSConfig
from cosyvoice2_eu_torch.models import llm as llm_mod
from cosyvoice2_eu_torch.models.flow import flow_inference
from cosyvoice2_eu_torch.models.flow_streaming import (
    FlowStreamState,
    flow_chunk,
    init_flow_stream_state,
    prepare_stream_params,
    stack_states,
    unstack_states,
)
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
    # feed sizes for priming the prompt through the cached flow
    PRIME_SIZES = (400, 200, 100, 50, 25)

    def __init__(self, cfg: TTSConfig, params: dict, seed: int = 0,
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                 device: str | torch.device = "cuda", lm_quant: Optional[str] = None,
                 cached_stream: bool = True, stream_max_tokens: int = 768,
                 use_bistream: bool = False, stream_rollover: bool = True,
                 stream_rollover_window: int = 200, tp: int = 0):
        """params: {"llm", "flow", "hift"} trees of tensors or numpy arrays.
        compute_dtype: dtype of the LM and flow (None keeps the parameters'
        own); HiFT and the flow's fixed noise stay fp32.
        lm_quant: None, or "int8" for per-channel int8 LM projections, taken
        from the weights after the cast to compute_dtype (fp32 scales).
        cached_stream: stream through the chunk-cached flow (O(T) a chunk)
        instead of recomputing the whole prefix per chunk; a session's
        caches hold ``stream_max_tokens`` tokens.  stream_rollover: when a
        session reaches that cap, re-prime a fresh state over the prompt and
        the last ``stream_rollover_window`` generated tokens and go on
        streaming (False ends the cached schedule there and vocodes the rest
        in the final recompute)."""
        if lm_quant not in (None, "int8"):
            raise ValueError(f"unknown lm_quant {lm_quant!r}: expected None or 'int8'")
        if tp:
            raise NotImplementedError("tensor-parallel decode is not ported yet: ROADMAP item 8g")
        self.cfg = cfg
        self.seed = seed
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
        self.cached_stream = cached_stream
        self.use_bistream = use_bistream
        self.stream_max_tokens = stream_max_tokens
        self.stream_rollover = stream_rollover
        self.stream_rollover_window = stream_rollover_window
        self._stream_params: Optional[dict] = None  # rel-pos tables, built at first use
        self._primed_cache: dict = {}  # prompt -> FlowStreamState primed over it
        stream = cfg.stream
        self.token_hop_len = stream.token_hop_len
        self.pre_lookahead_len = stream.pre_lookahead_len
        self.mel_cache_len = stream.mel_cache_len
        self.source_cache_len = stream.source_cache_len
        self.speech_window = np.hamming(2 * self.source_cache_len)

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

    def _lm_draws(self, batch: int) -> llm_mod.Draws:
        """The Gumbel draws of one call's LM, from a generator of its own
        seeded by one draw of ``self.generator``: HiFT calls interleaved with
        the decode (streaming) then leave the tokens as they are, so one seed
        gives the same tokens with and without streaming."""
        seed = int(torch.randint(0, 2**62, (1,), generator=self.generator, device=self.device))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return llm_mod.generator_draws(gen, batch, self.cfg.llm)

    def _finalize_full(self, tokens: np.ndarray, p: PromptInputs, session: dict,
                       speed: float = 1.0, hift_draws: Optional[HiftDraws] = None) -> np.ndarray:
        """One-shot non-streaming synthesis; past the largest flow bucket it
        runs the streaming schedule (``StreamSession`` under
        ``cached_stream=True``, else the windowed recompute loop) and joins
        its chunks.  With ``speed != 1.0`` the recompute loop stretches only
        the final chunk, and the session renders everything in one flow call,
        which raises past the largest bucket (as in the JAX package)."""
        if len(p.flow_prompt_speech_tokens) + len(tokens) <= FLOW_TOKEN_BUCKETS[-1]:
            return self._token2wav(tokens, p, 0, session, False, True, speed, hift_draws)
        return np.concatenate(list(self._wav_from_token_gen(iter(tokens), p, True, speed,
                                                            hift_draws)))

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

    def _vocode(self, mel_in: torch.Tensor, hift_draws: Optional[HiftDraws],
                cache_source: Optional[torch.Tensor] = None, cache_len=None):
        """One HiFT call on (B, 80, bucket) fp32 mel; ``hift_draws`` is
        called once, for this call's shapes."""
        hcfg = self.cfg.hift
        draws = None
        if hift_draws is not None:
            draws = hift_draws(mel_in.shape[0], mel_in.shape[2] * hcfg.upsample_scale,
                               hcfg.nb_harmonics + 1)
        return hift_inference(self.params["hift"], hcfg, mel_in, generator=self.generator,
                              draws=draws, cache_source=cache_source, cache_len=cache_len)

    def _hift_chunk(self, tts_mel: torch.Tensor, session: dict, finalize: bool,
                    speed: float = 1.0, hift_draws: Optional[HiftDraws] = None) -> np.ndarray:
        """Vocode one mel chunk with the session's vocoder cache: the cached
        mel tail goes in front, the cached source tail replaces the first
        source samples, the first ``source_cache_len`` samples crossfade
        (Hamming) with the previous chunk's withheld tail, and a chunk that
        is not final withholds its own last ``source_cache_len`` samples."""
        cache = session.get("hift_cache")
        sc, mc = self.source_cache_len, self.mel_cache_len
        if cache is not None:
            tts_mel = torch.cat([cache["mel"], tts_mel.float()], dim=2)
        if finalize and speed != 1.0 and cache is not None:
            raise ValueError("speed change only supports non-stream inference mode")
        if finalize and speed != 1.0:
            # linear mel interpolation for speed control
            mel_np = tts_mel.float().cpu().numpy()
            T = mel_np.shape[2]
            xp = np.linspace(0, T - 1, T)
            xq = np.linspace(0, T - 1, int(T / speed))
            mel_np = np.stack(
                [np.stack([np.interp(xq, xp, row) for row in ch]) for ch in mel_np]
            ).astype(np.float32)
            tts_mel = torch.as_tensor(mel_np, device=self.device)

        # edge-replicate to the HiFT bucket; cut the valid samples after
        t_mel = int(tts_mel.shape[2])
        h_bucket = bucket_for(t_mel, buckets=HIFT_MEL_BUCKETS)
        tts_mel = tts_mel.float()
        mel_in = torch.cat([tts_mel, tts_mel[:, :, t_mel - 1:].expand(-1, -1, h_bucket - t_mel)],
                           dim=2)
        cache_buf = torch.zeros((1, 1, sc), device=self.device)
        c_len = 0 if cache is None else int(cache["source"].shape[2])
        if c_len:
            cache_buf[:, :, :c_len] = cache["source"]
        with self.timer.stage("hift"):
            audio, source = self._vocode(mel_in, hift_draws, cache_buf, c_len)
            n_samples = t_mel * self.cfg.hift.upsample_scale
            # the source's tail (all of it when the chunk is shorter than the cache)
            source = source[:, :, max(n_samples - sc, 0): n_samples]
            audio = audio[0, :n_samples].cpu().numpy()

        if cache is not None:
            audio = _fade_in_out(audio, cache["speech"], self.speech_window)
        if not finalize:
            session["hift_cache"] = {"mel": tts_mel[:, :, max(t_mel - mc, 0):],
                                     "source": source, "speech": audio[-sc:]}
            audio = audio[:-sc]
        return audio

    # ------------------------------------------------------------------
    # streaming: LM side
    # ------------------------------------------------------------------

    def _lm_prefill_chunk(self, lm: dict, ids, src, max_gen: int, target_step: int):
        """LM prefill and the decode of the first chunk."""
        with self.timer.stage("lm_prefill_chunk"):
            state = llm_mod.lm_prefill(self.params["llm"], self.cfg.llm, self._tensor(ids),
                                       self._tensor(src), lm["prompt_len"], max_gen)
            return llm_mod.lm_decode_chunk(self.params["llm"], self.cfg.llm, state,
                                           lm["prompt_len"], lm["min_len"], lm["max_len"],
                                           target_step, lm["draws"])

    def _lm_chunk(self, lm: dict, state: llm_mod.DecodeState, target_step: int):
        with self.timer.stage("lm_chunk"):
            return llm_mod.lm_decode_chunk(self.params["llm"], self.cfg.llm, state,
                                           lm["prompt_len"], lm["min_len"], lm["max_len"],
                                           target_step, lm["draws"])

    @staticmethod
    def _fetch(state: llm_mod.DecodeState):
        """(emitted tokens, finished, token row) of row 0 in ONE device-to-host copy."""
        snap = torch.cat([state.lengths[:1], state.finished[:1].long(),
                          state.tokens[0]]).cpu().numpy()
        return int(snap[0]), bool(snap[1]), snap[2:]

    # ------------------------------------------------------------------
    # streaming: chunk-cached flow
    # ------------------------------------------------------------------

    def _get_stream_params(self) -> dict:
        if self._stream_params is None:
            with self.timer.stage("stream_params_build"):
                self._stream_params = prepare_stream_params(
                    self.params["flow"], self.cfg.flow, self.stream_max_tokens)
        return self._stream_params

    def _init_stream_state(self, device=None) -> FlowStreamState:
        return init_flow_stream_state(self.cfg.flow, self.stream_max_tokens,
                                      dtype=self.params["flow"]["input_embedding"]["weight"].dtype,
                                      device=self.device if device is None else device)

    def stream_session_bytes(self) -> int:
        """Device bytes one cached-flow streaming session holds at the
        configured token cap (sized on the meta device, nothing allocated)."""
        return self._init_stream_state("meta").nbytes()

    def _flow_feed(self, fstate: FlowStreamState, tok: np.ndarray, ctx: np.ndarray,
                   cond: np.ndarray, embedding: np.ndarray):
        """One ``flow_chunk`` on host arrays: tok (n,), ctx (la,), cond (2n, 80)."""
        return flow_chunk(self._get_stream_params(), self.cfg.flow, fstate,
                          self._tensor(tok[None]), self._tensor(ctx[None]),
                          self._tensor(np.asarray(embedding)[None], torch.float32),
                          self._tensor(cond[None], torch.float32))

    @staticmethod
    def _combined(sp: np.ndarray, gen: np.ndarray, gen_base: int, i0: int, n: int) -> np.ndarray:
        """Tokens [i0, i0 + n) of prompt ``sp`` ++ generated ``gen``, in state
        positions: after a rollover, position i >= P holds gen[gen_base + i - P]."""
        i = np.arange(i0, i0 + n)
        in_prompt = i < len(sp)
        out = np.empty(n, np.int32)
        out[in_prompt] = sp[i[in_prompt]]
        out[~in_prompt] = gen[gen_base + i[~in_prompt] - len(sp)]
        return out

    def _feed_tokens(self, fstate: FlowStreamState, prompt: PromptInputs, gen: np.ndarray,
                     gen_base: int, t0: int, n: int):
        """Feed state positions [t0, t0 + n) of prompt ++ generated, with the
        lookahead tokens after them as context; returns (mel, fstate)."""
        sp, la = prompt.flow_prompt_speech_tokens, self.pre_lookahead_len
        with self.timer.stage(f"flow_chunk[{n}]"):
            return self._flow_feed(fstate, self._combined(sp, gen, gen_base, t0, n),
                                   self._combined(sp, gen, gen_base, t0 + n, la),
                                   self._prompt_feat_chunk(prompt, t0, n), prompt.embedding)

    def _rollover(self, prompt: PromptInputs, gen: np.ndarray, g_fed: int):
        """Re-prime a fresh state over the prompt and the last
        ``stream_rollover_window`` of the ``g_fed`` generated tokens fed so
        far, the window aligned so that the catch-up decomposes into
        PRIME_SIZES feeds.  Returns (fstate, gen_base, t_fed)."""
        hop, la = self.token_hop_len, self.pre_lookahead_len
        P = len(prompt.flow_prompt_speech_tokens)
        prompt_only = self._prompt_prime_len(P, hop, la)
        w = self.stream_rollover_window
        w += (-((P - prompt_only) + w)) % hop
        gen_base = max(0, g_fed - w)
        fstate, _ = self._primed_flow_state(prompt)
        t, t_fed = prompt_only, P + (g_fed - gen_base)
        with self.timer.stage("stream_rollover"):
            for n in self._decompose_feed(t_fed - prompt_only):
                _, fstate = self._feed_tokens(fstate, prompt, gen, gen_base, t, n)
                t += n
        return fstate, gen_base, t_fed

    def _stream_chunk_batch(self, hop: int, states: list, tok: np.ndarray, ctx: np.ndarray,
                            emb: np.ndarray, cond: np.ndarray, cache_mel: torch.Tensor,
                            cache_source: torch.Tensor, cache_speech: np.ndarray,
                            hift_draws: Optional[HiftDraws] = None):
        """One steady chunk of ``hop`` tokens for B sessions at their own
        cursors (the JAX package's ``_stream_chunk_fused_batch_fn``): the
        chunk-cached flow over the stacked states, each row's mel cache in
        front, every row edge-padded to the HiFT bucket, one HiFT call over
        the rows with their source caches, the Hamming crossfade with each
        row's withheld tail, and the caches rotated.

        tok (B, hop), ctx (B, la), emb (B, 192) and cond (B, 2 hop, 80) are
        host arrays; cache_mel (B, 80, mel_cache_len), cache_source (B, 1,
        source_cache_len) and cache_speech (B, source_cache_len) hold each
        row's full vocoder cache (``_fused_cache_ok``).  Returns (states,
        audio rows (float32 host arrays), cache_mel, cache_source,
        cache_speech), row for row."""
        mc, sc, up = self.mel_cache_len, self.source_cache_len, self.cfg.hift.upsample_scale
        with self.timer.stage(f"flow_chunk[{hop}]"):
            mel, stacked = flow_chunk(self._get_stream_params(), self.cfg.flow,
                                      stack_states(states), self._tensor(tok), self._tensor(ctx),
                                      self._tensor(emb, torch.float32),
                                      self._tensor(cond, torch.float32))
        tts_mel = torch.cat([cache_mel, mel], dim=2)
        t_mel = tts_mel.shape[2]
        h_bucket = bucket_for(t_mel, buckets=HIFT_MEL_BUCKETS)
        mel_in = torch.cat([tts_mel, tts_mel[:, :, -1:].expand(-1, -1, h_bucket - t_mel)], dim=2)
        n_samples = t_mel * up
        with self.timer.stage("hift"):
            audio, source = self._vocode(mel_in, hift_draws, cache_source, sc)
            audio = audio[:, :n_samples].cpu().numpy()
        rows = [_fade_in_out(a, s, self.speech_window) for a, s in zip(audio, cache_speech)]
        return (unstack_states(stacked), [r[:-sc] for r in rows], tts_mel[:, :, -mc:],
                source[:, :, n_samples - sc:n_samples], np.stack([r[-sc:] for r in rows]))

    def _fused_cache_ok(self, session: dict) -> bool:
        """The session's vocoder cache is full size, as the steady chunk of
        ``StreamSession`` needs (the JAX package's fused chunk program takes
        only such a cache; the port keeps the guard, which also decides when
        the steady chunk size escalates)."""
        cache = session.get("hift_cache")
        return (cache is not None
                and cache["mel"].shape[2] == self.mel_cache_len
                and cache["source"].shape[2] == self.source_cache_len
                and cache["speech"].shape[0] == self.source_cache_len)

    def _recompute_window(self, n_prompt: int) -> tuple:
        """(cap, window) of a windowed recompute: the largest flow bucket,
        read when called, and the generated tokens kept as context once
        prompt + generated would pass it."""
        hop, la = self.token_hop_len, self.pre_lookahead_len
        cap = FLOW_TOKEN_BUCKETS[-1]
        return cap, max(hop, min(self.stream_rollover_window, cap - n_prompt - 2 * (hop + la)))

    def _decompose_feed(self, n: int) -> list:
        out = []
        for s in self.PRIME_SIZES:
            while n >= s:
                out.append(s)
                n -= s
        if n:
            raise ValueError(f"{n} tokens left over: feeds come in multiples of {s}")
        return out

    @staticmethod
    def _prompt_prime_len(P: int, hop: int, la: int) -> int:
        """Tokens of the prompt primed ahead of generation: full hops, minus
        one if the remainder is too short to provide la-token context."""
        prompt_only = (P // hop) * hop
        if prompt_only and P - prompt_only < la:
            prompt_only -= hop
        return prompt_only

    def _prompt_feat_chunk(self, prompt: PromptInputs, t0: int, n: int) -> np.ndarray:
        """(2n, 80) prompt mel over tokens [t0, t0 + n), zeros past the
        prompt's speech tokens."""
        ratio = self.cfg.flow.token_mel_ratio
        cond = np.zeros((n * ratio, self.cfg.flow.output_size), np.float32)
        lo = t0 * ratio
        take = min(n * ratio, len(prompt.flow_prompt_speech_tokens) * ratio - lo)
        if take > 0:
            cond[:take] = prompt.prompt_feat[lo: lo + take]
        return cond

    def _primed_flow_state(self, prompt: PromptInputs):
        """A FlowStreamState primed over the prompt's full hops, from the
        per-prompt snapshot cache (at most 4 prompts).  Chunks update a state
        in place, so a snapshot is cloned on the way in and on the way out.
        Returns (fstate, prompt_only)."""
        hop, la = self.token_hop_len, self.pre_lookahead_len
        sp = prompt.flow_prompt_speech_tokens.astype(np.int32)
        P = len(sp)
        prompt_only = self._prompt_prime_len(P, hop, la)
        key = hashlib.sha1(b"".join(np.ascontiguousarray(a).tobytes() for a in (
            sp, np.asarray(prompt.prompt_feat, np.float32),
            np.asarray(prompt.embedding, np.float32)))).hexdigest()
        cached = self._primed_cache.get(key)
        if cached is not None:
            return cached.clone(), prompt_only
        fstate = self._init_stream_state()
        with self.timer.stage("prompt_prime"):
            t = 0
            for n in self._decompose_feed(prompt_only):
                _, fstate = self._flow_feed(fstate, sp[t: t + n], sp[t + n: t + n + la],
                                            self._prompt_feat_chunk(prompt, t, n),
                                            prompt.embedding)
                t += n
        if len(self._primed_cache) >= 4:  # bound the device memory snapshots hold
            self._primed_cache.pop(next(iter(self._primed_cache)))
        self._primed_cache[key] = fstate.clone()
        return fstate, prompt_only

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
        """Yield waveform chunks (float32 at cfg.sample_rate): one without
        streaming, one per hop (the first joined with the prompt's padding to
        a hop) and a final one with it.

        lm_draws / hift_draws inject the random draws (see ``lm_decode_chunk``
        and ``sine_source``; ``hift_draws`` is called once per HiFT call, in
        order); by default the LM draws from a generator seeded by one draw
        of ``self.generator`` at the start of the call, HiFT from
        ``self.generator``.  Under ``use_bistream`` the LM runs the fill-token
        protocol (``lm_draws`` indexed by its decode step) and the tokens go
        through ``_wav_from_token_gen``.
        """
        if self.use_bistream:
            text = prompt.text_tokens.astype(np.int32)
            mt = self.cfg.llm.mix_ratio[0]
            pieces = (text[i: i + mt] for i in range(0, len(text), mt))
            yield from self._wav_from_token_gen(self._bistream_tokens(pieces, prompt, lm_draws),
                                                prompt, stream, speed, hift_draws)
            return
        ids, src, prompt_len, p_bucket, min_len, max_len = self._pack_lm_prompt(prompt)
        # round up to a multiple of 64, capped by the KV-cache capacity
        max_gen = min(((max_len + 63) // 64) * 64, self.cfg.llm.max_seq_len - p_bucket)
        own_draws = self._lm_draws(1)  # drawn in every call, injected draws or not
        lm = {"prompt_len": self._tensor([prompt_len]), "min_len": self._tensor([min_len]),
              "max_len": self._tensor([max_len]), "draws": lm_draws or own_draws}

        if not stream:
            with self.timer.stage("lm_decode"):
                tokens, lengths, self.last_decode_steps = llm_mod.lm_decode(
                    self.params["llm"], self.cfg.llm, self._tensor(ids), self._tensor(src),
                    lm["prompt_len"], lm["min_len"], lm["max_len"], max_gen, draws=lm["draws"])
                n = int(lengths[0])
                tokens = tokens[0, :n].cpu().numpy()
            self.last_n_tokens = n
            yield self._finalize_full(tokens, prompt, {"hift_cache": None}, speed, hift_draws)
            return
        run = self._tts_stream_cached if self.cached_stream else self._tts_stream_recompute
        yield from run(prompt, lm, ids, src, max_gen, speed, hift_draws)

    def _bistream_tokens(self, text_chunks, prompt: PromptInputs,
                         lm_draws: Optional[llm_mod.Draws] = None):
        """The speech tokens of the fill-token protocol over ``text_chunks``
        (arrays of text token ids), with the prompt's text and LM speech
        tokens; ``last_n_tokens`` and ``last_decode_steps`` follow them.  The
        LM's own draws are seeded here, injected draws or not, as in ``tts``."""
        own_draws = self._lm_draws(1)
        draws = lm_draws or own_draws
        self.last_n_tokens = self.last_decode_steps = 0

        def counted(step):
            self.last_decode_steps = step + 1
            return draws(step)

        def tokens():
            for tok in llm_mod.lm_inference_bistream(
                    self.params["llm"], self.cfg.llm, text_chunks,
                    prompt.prompt_text_tokens.astype(np.int32),
                    prompt.llm_prompt_speech_tokens.astype(np.int32), draws=counted,
                    max_cache=self.cfg.llm.max_seq_len, timer=self.timer):
                self.last_n_tokens += 1
                yield tok

        return tokens()

    def tts_stream_text(self, text_chunks, prompt: PromptInputs, stream: bool = True,
                        speed: float = 1.0, lm_draws: Optional[llm_mod.Draws] = None,
                        hift_draws: Optional[HiftDraws] = None
                        ) -> Generator[np.ndarray, None, None]:
        """Streaming text in: arrays of text token ids arrive one by one (from
        an upstream LLM, say) and waveform chunks come out, through the
        fill-token protocol end to end.  ``lm_draws`` / ``hift_draws`` as in
        ``tts``."""
        chunks = (np.asarray(c, np.int32) for c in text_chunks)
        yield from self._wav_from_token_gen(self._bistream_tokens(chunks, prompt, lm_draws),
                                            prompt, stream, speed, hift_draws)

    def _tts_stream_recompute(self, prompt: PromptInputs, lm: dict, ids, src, max_gen: int,
                              speed: float,
                              hift_draws: Optional[HiftDraws]) -> Generator[np.ndarray, None, None]:
        """The reference's streaming schedule (``_wav_from_token_gen``) over
        the chunked decode: the prefill decodes the first chunk's tokens, and
        each time the schedule has used up the tokens decoded so far, a hop
        more steps are decoded."""
        hop, la = self.token_hop_len, self.pre_lookahead_len
        n_prompt = len(prompt.flow_prompt_speech_tokens)
        prompt_pad = int(np.ceil(n_prompt / hop) * hop - n_prompt)

        def tokens():
            state = self._lm_prefill_chunk(lm, ids, src, max_gen, hop + prompt_pad + la)
            done = 0
            while True:
                n_avail, finished, toks = self._fetch(state)
                self.last_n_tokens, self.last_decode_steps = n_avail, state.step
                yield from toks[done:n_avail]
                done = n_avail
                if finished or state.step >= max_gen:
                    return
                state = self._lm_chunk(lm, state, state.step + hop)

        yield from self._wav_from_token_gen(tokens(), prompt, True, speed, hift_draws)

    def _wav_from_token_gen(self, token_gen, prompt: PromptInputs, stream: bool,
                            speed: float = 1.0, hift_draws: Optional[HiftDraws] = None
                            ) -> Generator[np.ndarray, None, None]:
        """Vocode an incremental speech-token stream on the reference's hop
        schedule.  Under ``cached_stream=True`` the serving path's
        ``StreamSession`` takes the tokens one by one (the chunk-cached
        flow, with rollover); otherwise each chunk recomputes the prefix
        within a rolling window that keeps the span inside the largest flow
        bucket."""
        session: dict = {"hift_cache": None}
        if not stream:
            tokens = np.fromiter(token_gen, np.int32)
            yield self._finalize_full(tokens, prompt, session, speed, hift_draws)
            return
        if self.cached_stream:
            from cosyvoice2_eu_torch.serving.engine import StreamSession

            sess = StreamSession(self, prompt, speed=speed, hift_draws=hift_draws)
            toks: list = []
            for t in token_gen:
                toks.append(int(t))
                yield from sess.feed(toks, False)
            yield from sess.feed(toks, True)
            return
        hop, la = self.token_hop_len, self.pre_lookahead_len
        n_prompt = len(prompt.flow_prompt_speech_tokens)
        prompt_pad = int(np.ceil(n_prompt / hop) * hop - n_prompt)
        cap, window = self._recompute_window(n_prompt)
        base = 0  # generated tokens dropped from the recompute context
        token_offset = 0
        buf: list = []
        for t in token_gen:
            buf.append(int(t))
            this_hop = hop + prompt_pad if token_offset == 0 else hop
            rel = token_offset - base
            if n_prompt + rel + this_hop + la > cap and rel > window:
                base, rel = token_offset - window, window
            if len(buf) - token_offset >= this_hop + la:
                chunk = np.asarray(buf[base: token_offset + this_hop + la], np.int32)
                yield self._token2wav(chunk, prompt, rel, session, True, False,
                                      hift_draws=hift_draws)
                token_offset += this_hop
        yield self._token2wav(np.asarray(buf[base:], np.int32), prompt, token_offset - base,
                              session, False, True, speed, hift_draws)

    def _tts_stream_cached(self, prompt: PromptInputs, lm: dict, ids, src, max_gen: int,
                           speed: float,
                           hift_draws: Optional[HiftDraws]) -> Generator[np.ndarray, None, None]:
        """Streaming through the chunk-cached flow: [prompt ++ generated]
        feeds the flow in 25-token chunks at O(1) each, and each chunk's mel
        goes through ``_hift_chunk``; the first chunk is a recompute (the
        cached state catches up behind it), and the final chunk the
        reference's full-recompute finalize, bounded by the window after a
        rollover."""
        hop, la = self.token_hop_len, self.pre_lookahead_len
        P = len(prompt.flow_prompt_speech_tokens)
        prompt_pad = int(np.ceil(P / hop) * hop - P)
        session: dict = {"hift_cache": None}
        self._get_stream_params()

        state = self._lm_prefill_chunk(lm, ids, src, max_gen, hop + prompt_pad + la)
        toks = np.zeros(0, np.int64)  # generated tokens, as of the last fetch
        # after a rollover, state position i >= P holds generated token gen_base + (i - P)
        gen_base = 0

        def fetch():
            nonlocal toks
            n_avail, finished, toks = self._fetch(state)
            return state.step, n_avail, finished

        prompt_only = self._prompt_prime_len(P, hop, la)
        first = hop + prompt_pad  # generated tokens of the first chunk
        step, n_avail, finished = fetch()

        # first chunk by recompute (one flow call over prompt + the first
        # chunk); the cached state catches up behind the audio already
        # yielded.  A decode round can spend steps on special tokens without
        # emitting, so it repeats until the chunk is there, the LM ends or max_gen.
        while n_avail < first + la and not finished and step < max_gen:
            state = self._lm_chunk(lm, state, step + (first + la - n_avail))
            step, n_avail, finished = fetch()
        # a stream shorter than the first chunk needs no state: the final
        # recompute vocodes it all
        fstate, t_fed = None, P  # t_fed: the next state position to feed
        if n_avail >= first + la:
            with self.timer.stage("first_chunk_recompute"):
                audio = self._token2wav(toks[:first + la], prompt, 0, session, True, False,
                                        hift_draws=hift_draws)
            yield audio
            fstate, _ = self._primed_flow_state(prompt)
            _, fstate = self._feed_tokens(fstate, prompt, toks, gen_base, prompt_only,
                                          P - prompt_only + first)
            t_fed = P + first

        can_roll = (self.stream_rollover
                    and P + self.stream_rollover_window + 2 * hop <= self.stream_max_tokens)
        stale = False  # the fetched values predate a speculative decode
        while fstate is not None:
            if stale:
                step, n_avail, finished = fetch()
                stale = False
            need_gen = gen_base + t_fed + hop + la - P  # generated tokens the feed needs
            if n_avail < need_gen and not finished:
                state = self._lm_chunk(lm, state, step + (need_gen - n_avail))
                step, n_avail, finished = fetch()
            at_cap = t_fed + hop > self.stream_max_tokens
            remaining = n_avail - (gen_base + t_fed - P)  # generated, not yet fed
            if at_cap and can_roll and (not finished or remaining > 2 * hop):
                fstate, gen_base, t_fed = self._rollover(prompt, toks, gen_base + (t_fed - P))
                continue
            if n_avail < need_gen or at_cap:
                if finished or step >= max_gen or at_cap:
                    break  # the final partial chunk by (window-bounded) recompute
                continue
            mel, fstate = self._feed_tokens(fstate, prompt, toks, gen_base, t_fed, hop)
            t_fed += hop
            audio = self._hift_chunk(mel, session, False, hift_draws=hift_draws)
            # decode the next hop ahead (a no-op once the LM has finished)
            if not finished and step < max_gen:
                state = self._lm_chunk(lm, state, step + hop + la)
                stale = True
            yield audio

        self.last_n_tokens, self.last_decode_steps = n_avail, state.step
        # after a rollover the finalize recompute starts at gen_base too
        yield self._token2wav(toks[gen_base: n_avail], prompt, t_fed - P, session, False,
                              True, speed, hift_draws)

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
        own_draws = self._lm_draws(n)  # drawn in every call, as in tts
        with self.timer.stage("lm_decode"):
            tokens, lengths, self.last_decode_steps = llm_mod.lm_decode(
                self.params["llm"], cfg.llm, self._tensor(ids), self._tensor(src),
                self._tensor(prompt_len), self._tensor(min_len), self._tensor(max_len),
                max_gen, draws=lm_draws or own_draws,
            )
            tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
        self.last_batch_tokens = [int(x) for x in lengths]

        ratio = cfg.flow.token_mel_ratio
        totals = [len(p.flow_prompt_speech_tokens) + int(lengths[i]) for i, p in enumerate(prompts)]
        if max(totals) > FLOW_TOKEN_BUCKETS[-1]:
            # per-row synthesis: the long rows through the streaming
            # schedule (``_finalize_full``), the rest one-shot
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
            with self.timer.stage("hift"):
                audio, _ = self._vocode(mel_g, hift_draws, cache, 0)
                out.extend(audio[i - lo, : mel_lens[i] * hcfg.upsample_scale].cpu().numpy()
                           for i in range(lo, hi))
        return out

    def vc(self, source_speech_tokens: np.ndarray, prompt: PromptInputs, stream: bool = False,
           speed: float = 1.0, hift_draws: Optional[HiftDraws] = None
           ) -> Generator[np.ndarray, None, None]:
        """Voice conversion: re-synthesize source speech tokens in the
        prompt speaker's voice, without the LM.  Without streaming one flow
        and HiFT call; with it, recompute chunks over the growing prefix (a
        hop and the lookahead each, then the final chunk).  As in the JAX
        package, neither windows: past the largest flow bucket
        ``bucket_for`` raises ``ValueError``.  ``hift_draws`` as in ``tts``."""
        session: dict = {"hift_cache": None}
        tokens = np.asarray(source_speech_tokens, np.int32)
        if not stream:
            yield self._token2wav(tokens, prompt, 0, session, False, True, speed, hift_draws)
            return
        hop, la = self.token_hop_len, self.pre_lookahead_len
        offset = 0
        while len(tokens) - offset >= hop + la:
            yield self._token2wav(tokens[: offset + hop + la], prompt, offset, session, True,
                                  False, hift_draws=hift_draws)
            offset += hop
        yield self._token2wav(tokens, prompt, offset, session, False, True, speed, hift_draws)


def _fade_in_out(fade_in: np.ndarray, fade_out: np.ndarray, window: np.ndarray) -> np.ndarray:
    """Hamming crossfade of chunk boundaries (streaming's vocoder cache)."""
    ov = window.shape[0] // 2
    out = fade_in.copy()
    out[:ov] = fade_in[:ov] * window[:ov] + fade_out[-ov:] * window[ov:]
    return out
