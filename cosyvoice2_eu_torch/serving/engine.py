"""The per-request token -> audio session of the serving path, in PyTorch.

Counterpart of ``StreamSession`` in ``cosyvoice2_eu_tpu/serving/engine.py``:
the flow/HiFT half of the cached streaming path, fed the generated-token
prefix as it grows.  ``TTSModel._wav_from_token_gen`` runs it under
``cached_stream=True``, which is how synthesis past the largest flow bucket
(``_finalize_full``) and ``tts_batch``'s per-row fallback vocode.

The first emission is a recompute over prompt + the first hop; the cached
flow state is primed behind it.  Steady chunks are one flow feed of 25, 50
or 100 tokens (the size escalates as the stream builds lead) and one
``_hift_chunk``.  At the state's token cap the session re-primes over the
prompt and a window of recent tokens (rollover); the end is the reference's
finalize recompute, bounded by a window, with an oversized remainder
drained in hop-sized recompute chunks first.

The engine (``TTSEngine``, slot-batched decode and the batched first and
steady chunks) is not ported yet: ROADMAP item 6b.
"""

from __future__ import annotations

import numpy as np
import torch


class StreamSession:
    """Per-request streaming state machine over a ``TTSModel``.

    ``hift_draws`` (see ``TTSModel.tts``) is handed to every HiFT call of
    the session, in order."""

    def __init__(self, model, prompt, speed: float = 1.0, hift_draws=None):
        self.model = model
        self.prompt = prompt
        # speed != 1.0 is non-stream only (the reference asserts it): render
        # the flow and HiFT once at the end, with mel interpolation
        self.speed = speed
        self.single_shot = speed != 1.0
        self.hift_draws = hift_draws
        cfg = model.cfg
        self.ratio = cfg.flow.token_mel_ratio
        self.hop = model.token_hop_len
        self.la = model.pre_lookahead_len
        self.P = len(prompt.flow_prompt_speech_tokens)
        self.prompt_pad = int(np.ceil(self.P / self.hop) * self.hop - self.P)
        self.prompt_mel = self.P * self.ratio
        self.session: dict = {"hift_cache": None}

        prompt_only = model._prompt_prime_len(self.P, self.hop, self.la)
        # no flow state until the first emission, which is a recompute; the
        # cached state is primed and caught up behind its audio
        self.fstate = None
        self.first_pending = not self.single_shot
        self.gen_base = 0  # generated tokens rolled out of the state window
        self.t_fed = prompt_only  # the next state position to feed
        self.next_feed = (self.P - prompt_only) + self.prompt_pad + self.hop
        self.this_hop = self.hop + self.prompt_pad
        self.emitted = 0  # generated tokens vocoded so far
        self.mel_buf = torch.zeros((1, cfg.flow.output_size, 0), device=model.device)
        self.done = False

    def _can_rollover(self, gen: np.ndarray, lm_finished: bool) -> bool:
        model = self.model
        return (model.stream_rollover
                and self.P + model.stream_rollover_window + 2 * self.hop
                <= model.stream_max_tokens
                and (not lm_finished or len(gen) - self.emitted > 2 * self.hop))

    def _rollover(self, gen: np.ndarray) -> None:
        """A fresh cached state over the prompt and the last window of
        generated tokens (``TTSModel._rollover``, shared with the direct
        cached stream)."""
        g_fed = self.gen_base + (self.t_fed - self.P)
        self.fstate, self.gen_base, self.t_fed = self.model._rollover(self.prompt, gen, g_fed)

    def _feed(self, t0: int, n: int, gen: np.ndarray) -> torch.Tensor:
        mel, self.fstate = self.model._feed_tokens(self.fstate, self.prompt, gen, self.gen_base,
                                                   t0, n)
        return mel

    def feed(self, gen_tokens, lm_finished: bool) -> list:
        """Consume the generated-token prefix seen so far; returns the audio
        chunks that became ready (float32 numpy).  Call once more with
        ``lm_finished=True`` to flush the final chunk."""
        out: list = []
        if self.done:
            return out
        model = self.model
        gen = np.asarray(gen_tokens, np.int32)
        if self.single_shot:
            if lm_finished:
                out.append(model._token2wav(gen, self.prompt, 0, self.session, False, True,
                                            self.speed, self.hift_draws))
                self.done = True
            return out
        if self.first_pending:
            need = self.this_hop + self.la
            # the catch-up feed must fit the cached window; when the cap is
            # smaller than prompt + the first hop, the session never caches
            # and the finalize drains it in recompute chunks
            fits = self.t_fed + self.next_feed <= model.stream_max_tokens
            if len(gen) >= need and fits:
                with model.timer.stage("first_chunk_recompute"):
                    out.append(model._token2wav(gen[:need], self.prompt, 0, self.session, True,
                                                False, hift_draws=self.hift_draws))
                self.first_apply(gen)
            elif lm_finished:
                out.extend(self._finalize(gen))
                self.done = True
                return out
            else:
                return out
        while True:
            avail = self.P + len(gen) - self.gen_base
            if (self.next_feed == self.hop and self.this_hop == self.hop
                    and self.mel_buf.shape[2] == 0 and self.t_fed >= self.P
                    and model._fused_cache_ok(self.session)):
                # steady state: one feed of h tokens and one HiFT call; h
                # escalates as the stream builds lead
                h = self._cur_hop()
                cap = model.stream_max_tokens
                if self.t_fed + h > cap and self._can_rollover(gen, lm_finished):
                    self._rollover(gen)
                    continue
                if not (avail >= self.t_fed + h + self.la and self.t_fed + h <= cap):
                    break  # wait for the tokens of a full chunk
                with model.timer.stage(f"stream_chunk[{h}]"):
                    mel = self._feed(self.t_fed, h, gen)
                    out.append(model._hift_chunk(mel, self.session, False,
                                                 hift_draws=self.hift_draws))
                self.t_fed += h
                self.emitted += h
                continue
            if not (avail >= self.t_fed + self.next_feed + self.la
                    and self.t_fed + self.next_feed <= model.stream_max_tokens):
                break
            mel = self._feed(self.t_fed, self.next_feed, gen)
            start = max(0, self.prompt_mel - self.t_fed * self.ratio)
            self.mel_buf = torch.cat([self.mel_buf, mel[:, :, start:]], dim=2)
            self.t_fed += self.next_feed
            self.next_feed = self.hop
            while self.mel_buf.shape[2] >= self.this_hop * self.ratio:
                chunk_mel = self.mel_buf[:, :, :self.this_hop * self.ratio]
                self.mel_buf = self.mel_buf[:, :, self.this_hop * self.ratio:]
                out.append(model._hift_chunk(chunk_mel, self.session, False,
                                             hift_draws=self.hift_draws))
                self.emitted += self.this_hop
                self.this_hop = self.hop
        if lm_finished:
            remaining = len(gen) - self.emitted
            cap_hit = self.t_fed + self.next_feed > model.stream_max_tokens
            if remaining > 0 or self.session["hift_cache"] is not None or cap_hit:
                out.extend(self._finalize(gen))
            self.done = True
        return out

    def first_apply(self, gen: np.ndarray) -> None:
        """Commit the first emission: prime the cached state (from the
        model's per-prompt snapshot cache) and catch it up behind the audio
        already emitted with one feed whose mel is dropped."""
        self.fstate, _ = self.model._primed_flow_state(self.prompt)
        self._feed(self.t_fed, self.next_feed, gen)
        self.t_fed += self.next_feed
        self.emitted = self.this_hop
        self.this_hop = self.hop
        self.next_feed = self.hop
        self.first_pending = False

    def _cur_hop(self) -> int:
        """Steady chunk size: 1 hop while the stream builds lead, then 2 and
        4 hops, as far as the state's cap allows."""
        cap = self.model.stream_max_tokens
        for mult, lead_chunks in ((4, 8), (2, 4)):
            if self.emitted >= lead_chunks * self.hop and self.t_fed + mult * self.hop <= cap:
                return mult * self.hop
        return self.hop

    def _finalize(self, gen: np.ndarray) -> list:
        """Flush the tail through the reference's finalize recompute, with
        the context windowed so that it fits the largest flow bucket: an
        oversized remainder is drained first in hop-sized streaming chunks
        over [prompt ++ recent window], each re-based to keep the bucket
        fixed, then one window-bounded final chunk.  The final recompute is
        windowed even when the whole context would fit (the JAX package
        does so; upstream's finalize does not)."""
        model = self.model
        hop, la = self.hop, self.la
        cap, window = model._recompute_window(self.P)
        token_offset = self.emitted
        base = 0
        out = []
        while len(gen) - token_offset > max(cap - self.P - window, 0):
            this_hop = hop + self.prompt_pad if token_offset == 0 else hop
            if len(gen) - token_offset < this_hop + la:
                break  # too short for a full chunk: the final one takes it
            base = max(base, token_offset - window)
            out.append(model._token2wav(gen[base: token_offset + this_hop + la], self.prompt,
                                        token_offset - base, self.session, True, False,
                                        hift_draws=self.hift_draws))
            token_offset += this_hop
        base = max(base, token_offset - window)
        over = self.P + (len(gen) - base) - cap
        if over > 0:  # a prompt so long that even the window overflows
            base = min(token_offset, base + over)
        out.append(model._token2wav(gen[base:], self.prompt, token_offset - base, self.session,
                                    False, True, self.speed, self.hift_draws))
        return out
