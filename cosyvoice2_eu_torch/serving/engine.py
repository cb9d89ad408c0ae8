"""The continuous-batching serving engine, in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/serving/engine.py``.  Concurrent requests
share one slot-batched LM decode (``models/llm.py``, ``slots_*``), joining
at a chunk boundary and leaving when they finish, while each request owns a
``StreamSession``: the flow/HiFT half of the cached streaming path, fed the
generated-token prefix as it grows.  One background thread drives the card;
callers read float32 audio chunks off per-request queues:

    engine = TTSEngine(api._model, n_slots=4)
    for chunk in engine.submit(prompt_inputs):   # (t,) float32 numpy
        play(chunk)

``EngineAPI`` puts the engine behind the ``Cosy2EU`` surface the servers
call.  ``TTSModel._wav_from_token_gen`` runs a ``StreamSession`` on its own
under ``cached_stream=True``, which is how synthesis past the largest flow
bucket (``_finalize_full``) and ``tts_batch``'s per-row fallback vocode.

Under tensor parallelism (``load(tp=N)``, one process per GPU) every process
of the group holds slices of the LM and must make the same LM calls.  The
engine on process 0 serves (``role == "server"``); every other process
builds the engine with the same arguments and runs ``follow``
(``role == "follower"``).  Before each call that changes the group's LM
state (a request's ``prefill_row``, ``slot_insert``, ``slots_decode``, the
reset after a loop failure, and the close) process 0 sends the call to the
group with ``broadcast_object_list``, and each follower makes it with the
same draws (its generator seeded alike, consumed once a decode step).  A
request that cannot stage is refused on process 0 before anything is sent.
Flow and HiFT are whole on every process, so only process 0 vocodes.  While
idle, process 0 sends a heartbeat every 0.2 s, so a follower never waits
long on a live group and the process group's timeout
(``init_process_group(timeout=...)``) bounds each of its waits.

The first emission is a recompute over prompt + the first hop; the cached
flow state is primed behind it.  Steady chunks are one flow feed of 25, 50
or 100 tokens (the size escalates as the stream builds lead) and one
``_hift_chunk``.  At the state's token cap the session re-primes over the
prompt and a window of recent tokens (rollover); the end is the reference's
finalize recompute, bounded by a window, with an oversized remainder
drained in hop-sized recompute chunks first.

The engine batches what it can across sessions: the first emissions of the
sessions that reach theirs in one decode round go through one flow recompute
and one HiFT call (``_first_batch``), and sessions whose next step is one
steady chunk of the same size through one batched chunk
(``TTSModel._stream_chunk_batch``).  Groups are padded to ``n_slots`` rows.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from cosyvoice2_eu_torch.models import llm as llm_mod
from cosyvoice2_eu_torch.models.flow import flow_inference
from cosyvoice2_eu_torch.models.qwen2 import local_kv_heads
from cosyvoice2_eu_torch.runtime import model as rt

log = logging.getLogger(__name__)


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
            if self._steady():
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

    def _steady(self) -> bool:
        """The session is in its steady state, where each step is one chunk
        of ``_cur_hop()`` tokens past the prompt with a full vocoder cache."""
        return (self.next_feed == self.hop and self.this_hop == self.hop
                and self.mel_buf.shape[2] == 0 and self.t_fed >= self.P
                and self.model._fused_cache_ok(self.session))

    def _cur_hop(self) -> int:
        """Steady chunk size: 1 hop while the stream builds lead, then 2 and
        4 hops, as far as the state's cap allows."""
        cap = self.model.stream_max_tokens
        for mult, lead_chunks in ((4, 8), (2, 4)):
            if self.emitted >= lead_chunks * self.hop and self.t_fed + mult * self.hop <= cap:
                return mult * self.hop
        return self.hop

    # -- the engine's hooks: it batches these steps across sessions ------------

    def first_ready(self, gen: np.ndarray) -> bool:
        """The next step is the first emission (batchable)."""
        return (not self.done and not self.single_shot and self.first_pending
                and len(gen) >= self.this_hop + self.la
                and self.t_fed + self.next_feed <= self.model.stream_max_tokens)

    def wants_steady(self, gen: np.ndarray) -> bool:
        """The next step is exactly one steady chunk (batchable): the guard
        of ``feed``'s steady branch, with the chunk's tokens there and no
        rollover due."""
        if self.done or self.single_shot or self.first_pending or not self._steady():
            return False
        h = self._cur_hop()
        return (self.t_fed + h <= self.model.stream_max_tokens
                and self.P + len(gen) - self.gen_base >= self.t_fed + h + self.la)

    def steady_inputs(self, gen: np.ndarray) -> tuple:
        """(tok, ctx, cond) host rows and the vocoder cache (mel, source,
        speech) of the next steady chunk."""
        model, h = self.model, self._cur_hop()
        sp = self.prompt.flow_prompt_speech_tokens
        cache = self.session["hift_cache"]
        return (model._combined(sp, gen, self.gen_base, self.t_fed, h),
                model._combined(sp, gen, self.gen_base, self.t_fed + h, self.la),
                model._prompt_feat_chunk(self.prompt, self.t_fed, h),
                cache["mel"], cache["source"], cache["speech"])

    def steady_apply(self, h: int, fstate, c_mel, c_src, c_sp) -> None:
        """Commit one steady chunk of ``h`` tokens run by the engine (its
        audio goes out through the engine)."""
        self.fstate = fstate
        self.session["hift_cache"] = {"mel": c_mel, "source": c_src, "speech": c_sp}
        self.t_fed += h
        self.emitted += h

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


@dataclass
class _Request:
    prompt: "rt.PromptInputs"
    out: "queue.Queue[Optional[np.ndarray]]"
    speed: float = 1.0
    harvested: int = 0  # generated tokens handed to the session so far
    session: Optional[StreamSession] = None
    failed: Optional[str] = None


class RequestHandle:
    """Iterable over a request's audio chunks, float32 numpy (blocks until
    each is ready; raises ``RuntimeError`` if the request failed)."""

    def __init__(self, req: _Request):
        self._req = req

    def __iter__(self):
        while True:
            chunk = self._req.out.get()
            if chunk is None:
                if self._req.failed:
                    raise RuntimeError(self._req.failed)
                return
            yield chunk


def check_servable(model) -> None:
    """Raise ``ValueError`` for a tensor-parallel model (a ``TTSModel`` or a
    ``Cosy2EU``) served outside the engine: only the engine keeps the
    group's processes in step (``serving_api``)."""
    tm = getattr(model, "_model", model)
    if getattr(tm, "tp", 0) > 1 and not isinstance(model, (EngineAPI, TTSEngine)):
        raise ValueError(f"a tensor-parallel model (tp={tm.tp}) is served through EngineAPI, "
                         "which keeps every process of its group in step (serving_api)")


def serving_api(api, n_slots: int = 0):
    """What a server serves: ``api`` (a ``Cosy2EU``) itself when ``n_slots``
    is 0, else ``EngineAPI(api, n_slots)``; always the engine (4 slots when
    ``n_slots`` is 0) for a tensor-parallel model."""
    if n_slots <= 0 and getattr(api._model, "tp", 0) <= 1:
        return api
    return EngineAPI(api, n_slots=n_slots if n_slots > 0 else 4)


def follows(served) -> bool:
    """On a follower process of a tensor-parallel group, run the follower
    loop until process 0's engine closes and return True; elsewhere return
    False at once (the caller then binds its server)."""
    engine = getattr(served, "engine", None)
    if engine is None or engine.role != "follower":
        return False
    engine.follow()
    return True


def follow(model, **engine_kwargs) -> int:
    """Process r > 0 of ``model``'s tensor-parallel group: make the LM calls
    of process 0's ``TTSEngine`` (built with the same ``engine_kwargs``) in
    its order until it closes; returns the decode steps made."""
    return TTSEngine(model, **engine_kwargs).follow()


class TTSEngine:
    """Slot-batched continuous serving over one ``TTSModel``, on its device.

    Each loop round stages waiting requests (prefill into a KV row of their
    own, ``prefill_row``, even while every slot is busy), merges staged rows
    into free slots, decodes ``chunk_steps`` steps of every slot
    (``slots_decode``), then vocodes: the sessions at their first emission
    in one batched recompute, those at a steady chunk of the same size in
    one batched chunk, the rest through their own ``feed``.  A request
    leaves its slot when its LM finishes.

    ``lm_draws(step)`` (see ``slots_decode``; step counts the engine's
    decode steps) and ``hift_draws`` (called once per HiFT call, in order)
    inject the random draws; by default the LM draws from a generator
    seeded ``model.seed + 17`` and HiFT from the model's generator.

    Under tp > 1 the engine of process 0 (``role`` "server") starts its loop
    at once and sends each LM call to the group; the others (``role``
    "follower") serve nothing and run ``follow``.  A closed engine of a
    tensor-parallel group takes no more requests: its followers have ended.
    """

    def __init__(self, model, n_slots: int = 4, chunk_steps: int = 25, max_cache: int = 1024,
                 max_gen: int = 640, lm_draws: Optional[llm_mod.Draws] = None,
                 hift_draws: Optional[rt.HiftDraws] = None):
        mesh = getattr(model, "tp_mesh", None)
        self._group = mesh.group if mesh is not None else None
        self._src = dist.get_global_rank(self._group, 0) if self._group is not None else 0
        self.role = "follower" if mesh is not None and mesh.rank > 0 else "server"
        self._closed = False
        self._ids = itertools.count()
        self.model = model
        self.cfg = model.cfg
        self.n_slots = n_slots
        self.chunk_steps = chunk_steps
        self.max_cache = max_cache
        self.max_gen = min(max_gen, max_cache - 1)
        self.lm_draws = lm_draws
        self.hift_draws = hift_draws
        self._reset_state()
        self._staged: deque = deque()
        self._pad_state_cache = None
        self._pending: "queue.Queue[_Request]" = queue.Queue()
        self._slots: list = [None] * n_slots
        self._lock = threading.Lock()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        if self._group is not None and self.role == "server":
            self._ensure_running()  # its heartbeats keep the followers' waits short

    # -- public ----------------------------------------------------------

    def submit(self, prompt, speed: float = 1.0) -> RequestHandle:
        """Queue one request (``PromptInputs``); its audio comes through the handle."""
        if self.role == "follower":
            raise RuntimeError("a follower engine serves nothing: process 0 of its group serves")
        if self._closed and self._group is not None:
            raise RuntimeError("engine closed: its tensor-parallel followers have ended")
        req = _Request(prompt=prompt, out=queue.Queue(), speed=speed)
        self._pending.put(req)
        self._ensure_running()
        return RequestHandle(req)

    def close(self) -> None:
        """Stop the loop after its current round; requests still in the
        engine then fail with "engine closed".  Under tp the loop's last
        message ends the followers."""
        self._closed = True
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=30)
            if not self._thread.is_alive():
                self._fail_all("engine closed")

    def follow(self) -> int:
        """A follower's loop: make each LM call process 0 sends, in its
        order, until it closes; returns the decode steps made.  Each wait is
        one ``broadcast_object_list``, bounded by the process group's
        timeout."""
        if self.role != "follower":
            raise RuntimeError("follow() runs on processes 1.. of a tensor-parallel group")
        rows: dict = {}
        steps = 0
        while True:
            op, *args = self._hear()
            if op == "close":
                return steps
            if op == "hello":
                mine = (self.n_slots, self.chunk_steps, self.max_cache, self.max_gen)
                if tuple(args) != mine:
                    raise ValueError(f"process 0's engine has (n_slots, chunk_steps, max_cache, "
                                     f"max_gen) {tuple(args)}, this follower's {mine}")
            elif op == "prefill":
                rid, ids, src, prompt_len = args
                rows[rid] = self._prefill(ids, src, prompt_len)
            elif op == "drop":
                rows.pop(args[0], None)
            elif op == "insert":
                rid, slot, meta = args
                row, last = rows.pop(rid)
                self.state = llm_mod.slot_insert(self.state, slot, row, last, *meta)
            elif op == "decode":
                if args[0]:  # the slots process 0 freed since the last round
                    self.state.active[args[0]] = False
                before = self.state.step
                with self.model.timer.stage("eng_decode"):
                    self.state = llm_mod.slots_decode(self.model.params["llm"], self.cfg.llm,
                                                      self.state, self.chunk_steps, self._draws)
                steps += self.state.step - before
            elif op == "reset":
                rows.clear()
                self._reset_state()

    # -- internals --------------------------------------------------------

    def _tell(self, *msg) -> None:
        """Process 0 under tp: send one LM call to the group's followers."""
        if self._group is not None:
            dist.broadcast_object_list([msg], src=self._src, group=self._group)

    def _hear(self) -> tuple:
        box = [None]
        dist.broadcast_object_list(box, src=self._src, group=self._group)
        return box[0]

    def _prefill(self, ids, src, prompt_len: int):
        model = self.model
        return llm_mod.prefill_row(model.params["llm"], self.cfg.llm, model._tensor(ids),
                                   model._tensor(src), prompt_len, self.max_cache,
                                   dtype=self.state.kv.k.dtype)

    def _reset_state(self) -> None:
        """Empty slots, with the LM draws from their start."""
        model = self.model
        dtype = model.params["llm"]["llm_embedding"]["weight"].dtype
        self.state = llm_mod.slots_init(
            self.cfg.llm, self.n_slots, self.max_cache, self.max_gen, dtype=dtype,
            device=model.device,
            num_kv_heads=local_kv_heads(model.params["llm"]["backbone"], self.cfg.llm.backbone))
        self._draws = self.lm_draws
        if self._draws is None:
            gen = torch.Generator(device=model.device)
            gen.manual_seed(model.seed + 17)
            self._draws = llm_mod.generator_draws(gen, self.n_slots, self.cfg.llm)

    def _ensure_running(self) -> None:
        with self._lock:
            if not self._running:
                self._running = True
                self._thread = threading.Thread(target=self._loop, daemon=True)
                self._thread.start()

    def _stage(self, req: _Request) -> None:
        """Prefill the request's prompt into a KV row of its own and build
        its session, ahead of a free slot."""
        model = self.model
        ids, src, prompt_len, p_bucket, min_len, max_len = model._pack_lm_prompt(req.prompt)
        if p_bucket >= self.max_cache:
            raise ValueError(f"prompt bucket {p_bucket} exceeds the engine's cache "
                             f"({self.max_cache} slots)")
        # everything that may refuse the request comes before the group hears of it
        session = StreamSession(model, req.prompt, speed=req.speed, hift_draws=self.hift_draws)
        rid = next(self._ids)
        self._tell("prefill", rid, ids, src, prompt_len)
        try:
            with model.timer.stage("eng_prefill"):
                row, last = self._prefill(ids, src, prompt_len)
        except Exception:
            self._tell("drop", rid)
            raise
        req.session = session
        self._staged.append((req, rid, row, last,
                             (prompt_len, min_len, min(max_len, self.max_gen), p_bucket)))

    def _insert(self, slot: int) -> None:
        req, rid, row, last, meta = self._staged.popleft()
        self._tell("insert", rid, slot, meta)
        self.state = llm_mod.slot_insert(self.state, slot, row, last, *meta)
        self._slots[slot] = req

    def _decode(self):
        """``chunk_steps`` decode steps of every slot; returns (tokens,
        lengths, finished) on the host, fetched in one copy."""
        self._tell("decode", [slot for slot, r in enumerate(self._slots) if r is None])
        self.state = llm_mod.slots_decode(self.model.params["llm"], self.cfg.llm, self.state,
                                          self.chunk_steps, self._draws)
        st, b = self.state, self.n_slots
        snap = torch.cat([st.lengths, st.finished.long(), st.tokens.reshape(-1)]).cpu().numpy()
        return snap[2 * b:].reshape(b, -1), snap[:b], snap[b:2 * b].astype(bool)

    def _fail_all(self, msg: str) -> None:
        """End every request in a slot, staged or pending with ``msg``."""
        failed = [r for r in self._slots if r is not None]
        failed += [staged[0] for staged in self._staged]
        self._slots = [None] * self.n_slots
        self._staged.clear()
        while True:
            try:
                failed.append(self._pending.get_nowait())
            except queue.Empty:
                break
        for req in failed:
            req.failed = msg
            req.out.put(None)

    def _loop(self) -> None:
        try:
            self._tell("hello", self.n_slots, self.chunk_steps, self.max_cache, self.max_gen)
            while self._running:
                self._loop_once()
            self._tell("close")
        except Exception as e:  # the card or the model failed: fail everyone, allow a restart
            log.exception("engine loop died")
            msg = f"engine loop died: {e!r}"
            try:  # the state may be half written: start a restarted loop on empty slots
                self._tell("reset")
                self._reset_state()
            except Exception:
                log.exception("engine state reset failed; a restart will raise again")
            # the flag drops under the lock submit()'s _ensure_running takes,
            # before the final drain: a request queued before it fails here,
            # one queued after restarts the loop
            with self._lock:
                self._running = False
                self._fail_all(msg)

    def _first_batch(self, group: list, tokens: np.ndarray, lengths: np.ndarray) -> list:
        """The first emissions of ``group``'s sessions: one flow recompute
        over each row's prompt and first chunk (rows share a token bucket;
        per-row lengths, as ``tts_batch``), then one HiFT call, both on
        ``n_slots`` rows (pad rows repeat row 0); each session's vocoder
        cache is primed from its row and its cached state caught up
        (``first_apply``).  Returns each session's audio (host float32)."""
        model = self.model
        cfg = model.cfg
        ratio, la = cfg.flow.token_mel_ratio, model.pre_lookahead_len
        up, sc, mc = cfg.hift.upsample_scale, model.source_cache_len, model.mel_cache_len
        sessions = [req.session for _, req in group]
        gens = [tokens[slot, :int(lengths[slot])] for slot, _ in group]
        totals = [s.P + s.this_hop + la for s in sessions]
        b, n_real = self.n_slots, len(group)
        tok_bucket = rt.bucket_for(max(totals), buckets=rt.FLOW_TOKEN_BUCKETS)
        tok_arr = np.zeros((b, tok_bucket), np.int32)
        feat = np.zeros((b, tok_bucket * ratio, cfg.flow.output_size), np.float32)
        feat_len = np.zeros((b,), np.int32)
        for i, s in enumerate(sessions):
            tok_arr[i, :s.P] = s.prompt.flow_prompt_speech_tokens
            tok_arr[i, s.P:totals[i]] = gens[i][:totals[i] - s.P]
            feat[i, :s.prompt.prompt_feat.shape[0]] = s.prompt.prompt_feat
            feat_len[i] = s.prompt.prompt_feat.shape[0]
        tok_arr[n_real:], feat[n_real:], feat_len[n_real:] = tok_arr[0], feat[0], feat_len[0]
        emb = np.stack([np.asarray(s.prompt.embedding, np.float32) for s in sessions]
                       + [np.asarray(sessions[0].prompt.embedding, np.float32)] * (b - n_real))
        with model.timer.stage("flow"):
            mel = flow_inference(model.params["flow"], cfg.flow, model._tensor(tok_arr),
                                 model._tensor(totals + [totals[0]] * (b - n_real)),
                                 model._tensor(feat, torch.float32), model._tensor(feat_len),
                                 model._tensor(emb, torch.float32), streaming=True,
                                 finalize=False)
        # each row's generated region, edge-padded to the HiFT bucket
        mels = [mel[i, :, int(feat_len[i]):(totals[i] - la) * ratio].float()
                for i in range(n_real)]
        h_bucket = rt.bucket_for(max(m.shape[1] for m in mels), buckets=rt.HIFT_MEL_BUCKETS)
        rows = [torch.cat([m, m[:, -1:].expand(-1, h_bucket - m.shape[1])], dim=1) for m in mels]
        mel_in = torch.stack(rows + rows[:1] * (b - n_real))
        with model.timer.stage("hift"):
            audio, source = model._vocode(mel_in, self.hift_draws,
                                          torch.zeros((b, 1, sc), device=model.device), 0)
            audio = audio.cpu().numpy()
        out = []
        for i, s in enumerate(sessions):
            n_samples = mels[i].shape[1] * up
            a = audio[i, :n_samples]
            s.session["hift_cache"] = {"mel": mels[i][None, :, -mc:],
                                       "source": source[i:i + 1, :, n_samples - sc:n_samples],
                                       "speech": a[-sc:]}
            s.first_apply(gens[i])
            out.append(a[:-sc])
        return out

    @property
    def _pad_state(self):
        """The empty flow state that pads a steady group to ``n_slots`` rows
        (stacking copies it, so it is never written)."""
        if self._pad_state_cache is None:
            self._pad_state_cache = self.model._init_stream_state()
        return self._pad_state_cache

    def _steady_batch(self, group: list, tokens: np.ndarray, lengths: np.ndarray) -> list:
        """One batched steady chunk for ``group``'s sessions (one chunk
        size), padded to ``n_slots`` rows; returns each session's audio."""
        model = self.model
        hop = group[0][1].session._cur_hop()
        rows = [req.session.steady_inputs(tokens[slot, :int(lengths[slot])])
                for slot, req in group]
        n_pad = self.n_slots - len(group)

        def stacked(i):  # field i of every row, pad rows repeating row 0
            return np.stack([r[i] for r in rows] + [rows[0][i]] * n_pad)

        emb = np.stack([np.asarray(req.prompt.embedding, np.float32) for _, req in group]
                       + [np.asarray(group[0][1].prompt.embedding, np.float32)] * n_pad)
        sc, mc, dev = model.source_cache_len, model.mel_cache_len, model.device
        # pad rows vocode from empty caches, sized from the flow's mel bins
        cache_mel = torch.cat([r[3] for r in rows]
                              + [torch.zeros((n_pad, self.cfg.flow.output_size, mc), device=dev)])
        cache_source = torch.cat([r[4] for r in rows] + [torch.zeros((n_pad, 1, sc), device=dev)])
        cache_speech = np.stack([r[5] for r in rows] + [np.zeros(sc, np.float32)] * n_pad)
        states = [req.session.fstate for _, req in group] + [self._pad_state] * n_pad
        states, audio, c_mel, c_src, c_sp = model._stream_chunk_batch(
            hop, states, stacked(0), stacked(1), emb, stacked(2), cache_mel, cache_source,
            cache_speech, self.hift_draws)
        for i, (_, req) in enumerate(group):
            req.session.steady_apply(hop, states[i], c_mel[i:i + 1], c_src[i:i + 1], c_sp[i])
        return audio[:len(group)]

    def _loop_once(self) -> None:
        model = self.model
        timer = model.timer
        # stage waiting requests the moment they arrive, even while every slot is busy
        while len(self._staged) < self.n_slots + 2:
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            try:
                self._stage(req)
            except Exception as e:  # this request alone fails (its prompt past the cache, ...)
                log.exception("staging a request failed")
                req.failed = str(e)
                req.out.put(None)
        for slot in range(self.n_slots):
            if self._slots[slot] is None and self._staged:
                self._insert(slot)
        if all(r is None for r in self._slots):
            if self._pending.empty() and not self._staged:
                try:  # idle: wait briefly for a request, then let the loop check its flag
                    self._pending.put(self._pending.get(timeout=0.2))
                except queue.Empty:
                    self._tell("idle")  # the followers' heartbeat
            return

        with timer.stage("eng_decode"):
            tokens, lengths, finished = self._decode()
        active = [(slot, req) for slot, req in enumerate(self._slots) if req is not None]
        batched: dict = {slot: [] for slot, _ in active}
        gen = {slot: tokens[slot, :int(lengths[slot])] for slot, _ in active}
        # first emissions in one recompute; a row past the largest flow
        # bucket is left to its own feed
        firsts = [(slot, req) for slot, req in active
                  if req.failed is None and req.session.first_ready(gen[slot])
                  and req.session.P + req.session.this_hop + model.pre_lookahead_len
                  <= rt.FLOW_TOKEN_BUCKETS[-1]]
        if len(firsts) >= 2:
            try:
                with timer.stage("eng_first_batch"):
                    rows = self._first_batch(firsts, tokens, lengths)
                for (slot, _), audio in zip(firsts, rows):
                    batched[slot].append(audio)
            except Exception as e:
                log.exception("batched first emission failed")
                for _, req in firsts:
                    req.failed = str(e)
        # steady chunks in batched rounds, grouped by chunk size (sessions
        # escalate at different times); a single session runs its own feed
        while True:
            by_hop: dict = {}
            for slot, req in active:
                if req.failed is None and req.session.wants_steady(gen[slot]):
                    by_hop.setdefault(req.session._cur_hop(), []).append((slot, req))
            group = next((g for g in by_hop.values() if len(g) >= 2), None)
            if group is None:
                break
            try:
                with timer.stage("eng_steady_batch"):
                    rows = self._steady_batch(group, tokens, lengths)
            except Exception as e:
                log.exception("batched steady chunk failed")
                for _, req in group:
                    req.failed = str(e)
                break
            for (slot, _), audio in zip(group, rows):
                batched[slot].append(audio)
        for slot, req in active:
            n = int(lengths[slot])
            done = bool(finished[slot]) or req.failed is not None
            chunks = batched[slot]
            if req.failed is None and (n > req.harvested or done):
                req.harvested = n
                try:
                    with timer.stage("eng_feed"):
                        chunks = chunks + req.session.feed(gen[slot], done)
                except Exception as e:
                    log.exception("a session's feed failed")
                    req.failed = str(e)
                    done = True
            for chunk in chunks:
                req.out.put(chunk)
            if done:
                req.out.put(None)
                self._slots[slot] = None
                self.state.active[slot] = False


class EngineAPI:
    """The ``Cosy2EU`` surface (``tts``, ``stream``, ``add_zero_shot_spk``)
    served through a ``TTSEngine`` on the wrapped model's device:
    concurrent callers share the slot-batched decode (the servers'
    ``--engine-slots``)."""

    def __init__(self, api, n_slots: int = 4, **engine_kwargs):
        self._api = api
        self._frontend = api._frontend
        self._model = api._model
        self.sample_rate = api.sample_rate
        self.engine = TTSEngine(api._model, n_slots=n_slots, **engine_kwargs)

    def _inputs(self, text, prompt, prompt_text, mode, instruct_text, **precomputed):
        art = self._api._prepare(prompt, prompt_text, **precomputed)
        fe = self._frontend
        if mode == "instruct2":
            return fe.frontend_instruct2(text, instruct_text, art)
        if mode not in ("zero_shot", "cross_lingual"):
            raise ValueError(f"unknown mode {mode!r}")
        return getattr(fe, f"frontend_{mode}")(text, art)

    def stream(self, text: str, prompt, *, prompt_text: str = "", speed: float = 1.0,
               text_frontend: bool = False, mode: str = "cross_lingual",
               instruct_text: str = "", **precomputed):
        """Yield waveform chunks (1, t) float32, one engine request per text segment."""
        segments = (self._frontend.normalize_text(text, split=True) if text_frontend
                    else [text])
        for seg in segments:
            inputs = self._inputs(seg, prompt, prompt_text, mode, instruct_text, **precomputed)
            for chunk in self.engine.submit(inputs, speed=speed):
                yield chunk[None]

    def tts(self, text: str, prompt, **kw):
        """Synthesize; returns (waveform (1, T) float32, sample_rate)."""
        return np.concatenate([c[0] for c in self.stream(text, prompt, **kw)])[None], \
            self.sample_rate

    def add_zero_shot_spk(self, prompt_text: str, prompt, spk_id: str) -> bool:
        return self._api.add_zero_shot_spk(prompt_text, prompt, spk_id)

    def close(self) -> None:
        self.engine.close()
