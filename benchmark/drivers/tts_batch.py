"""Offline batched synthesis through ``TTSModel.tts_batch`` (audiobooks,
dataset generation): one caller sends batches back to back.

Set-up makes the weights from the seed (``reference/weights.py``), loads
them with ``cosyvoice2_eu_torch.load`` in the configuration's precision and
warms up with the mix's first batch (every batch has the same sizes, so
every shape of the window is met, every kernel built).  The window runs whole batches until
``--seconds`` have passed; ``audio_s_per_s`` is the audio of every request
of the window over the window's wall time.  With ``--trace 1`` one more
batch runs after the window under the profiler.

What the timed path produced is read at two taps that hold references
only: ``models/llm.py::lm_decode``'s tokens and lengths, and the mel of the
flow call (``runtime/model.py``'s ``flow_inference``); the waveforms are
``tts_batch``'s results.  They are then judged against the reference, in
fp32 with TF32 off, once the program is freed, the LM on the rows that
decode greedily (zero Gumbel draws; ``greedy`` a batch), the flow and
HiFT on every row (each on the row's own tokens and draws):

* ``lm_logit_gap``: the widest gap, over every served token of the greedy rows,
  between the reference's best logit and the served token's, the reference
  run once over the prompt and the served tokens (an id past EOS is fed
  back without being served: a position where one is within
  ``special_margin`` of the reference's best ends the row's comparison);
* ``flow_mel_rel``: the relative L2 error of each row's generated mel
  against the reference flow on the same tokens, prompt and x-vector;
* ``hift_wav_rel``: the relative L2 error of each row's waveform against the
  reference HiFT on the program's mel with the same draws.

``run(..., control=True)`` also reads the control, one precision below the
configuration's, in the same three numbers: the reference computed in fp8
for the bf16 LM (the gap of the token it puts first at each position of
the same prompts and tokens) and flow, in TF32 for the fp32 HiFT.  Beside
it, ``lm_logit_gap_int8``: the program's own int8 LM path
(``load(lm_quant="int8")``, weight-only int8 projections, through
``models/llm.py::lm_training_hidden`` over the same tokens).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import flops
from harness import trace as tracing
from harness import traffic as gen_traffic
from harness.core import Check, Outcome
from reference import flow as ref_flow
from reference import hift as ref_hift
from reference import lm as ref_lm
from reference import weights
from reference.config import model_config
from reference.layers import exact, lowered

def _gumbel(shape, gen):
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=gen, device=gen.device)
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def _generator(device, *key) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0] >> 1))
    return g


class Taps:
    """References to what the timed path produced, per ``tts_batch`` call."""

    def __init__(self, port_llm, port_model):
        self.decodes, self.mels = [], []
        self._llm, self._model = port_llm, port_model
        self._decode, self._flow = port_llm.lm_decode, port_model.flow_inference

        def decode(*a, **k):
            out = self._decode(*a, **k)
            self.decodes.append(out)
            return out

        def flow(*a, **k):
            mel = self._flow(*a, **k)
            self.mels.append(mel)
            return mel

        port_llm.lm_decode, port_model.flow_inference = decode, flow

    def close(self):
        self._llm.lm_decode, self._model.flow_inference = self._decode, self._flow


class BatchDraws:
    """The draws of one batch: Gumbel noise for the LM (zero on greedy rows)
    and HiFT's phases and noise, each from a generator of the run's seed;
    HiFT's shapes are kept so that ``replay_hift`` draws every call again."""

    def __init__(self, device, seed: int, k: int, greedy: list, cfg):
        self.device, self.key = device, (seed, k)
        self.keep = torch.tensor([0.0 if g else 1.0 for g in greedy], device=device)[:, None]
        self.lm_gen = _generator(device, seed, k, 1)
        self.hift_gen = _generator(device, seed, k, 2)
        self.top_k, self.vocab = cfg.llm.top_k, cfg.llm.full_vocab
        self.hift_shapes = []

    def lm(self, step):
        b = self.keep.shape[0]
        return (_gumbel((b, self.top_k), self.lm_gen) * self.keep,
                _gumbel((b, self.vocab), self.lm_gen) * self.keep)

    def hift(self, b, length, harmonics):
        self.hift_shapes.append((b, length, harmonics))
        return self._hift_draw(self.hift_gen, b, length, harmonics)

    @staticmethod
    def _hift_draw(g, b, length, harmonics):
        return (torch.rand((b, harmonics), generator=g, device=g.device),
                torch.randn((b, length, harmonics), generator=g, device=g.device))

    def replay_hift(self) -> list:
        g = _generator(self.device, *self.key, 2)
        return [self._hift_draw(g, *s) for s in self.hift_shapes]


def _prompt(port_model, row):
    return port_model.PromptInputs(
        text_tokens=row["text_tokens"], prompt_text_tokens=row["prompt_text_tokens"],
        llm_prompt_speech_tokens=row["speech_tokens"],
        flow_prompt_speech_tokens=row["speech_tokens"], prompt_feat=row["prompt_feat"],
        embedding=row["embedding"])


def run(cell, seed: int, seconds: float, trace: bool, t_start: float, device: str = "cuda",
        control: bool = False) -> Outcome:
    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.config import TTSConfig, config_from_dict
    from cosyvoice2_eu_torch.models import llm as port_llm
    from cosyvoice2_eu_torch.runtime import model as port_model

    c = model_config(cell.config["model"])
    prec = cell.config["precision"]
    t = cell.traffic
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    batches = gen_traffic.generate(t, c, seed)

    api = cosy.load(config=config_from_dict(TTSConfig, cell.config["model"]),
                    params=weights.make_tts(c, seed, dev), device=device,
                    compute_dtype=prec["llm"], seed=seed % 2**63)
    tm = api._model
    taps = Taps(port_llm, port_model)
    try:
        # warm-up: the first batch (every batch has the same sizes)
        warm = BatchDraws(dev, seed, 0, [r["greedy"] for r in batches[0]], c)
        tm.tts_batch([_prompt(port_model, r) for r in batches[0]], lm_draws=warm.lm,
                     hift_draws=warm.hift)
        _sync(dev)
        taps.decodes.clear()
        taps.mels.clear()
        tm.timer.reset()

        done, draws, wavs = [], [], []

        walls = []

        def serve(k):
            d = BatchDraws(dev, seed, k + 1, [r["greedy"] for r in batches[k]], c)
            t1 = time.perf_counter()
            wavs.append(tm.tts_batch([_prompt(port_model, r) for r in batches[k]],
                                     lm_draws=d.lm, hift_draws=d.hift))
            walls.append(time.perf_counter() - t1)
            done.append(batches[k])
            draws.append(d)

        t0 = time.perf_counter()
        setup_s = t0 - t_start
        while time.perf_counter() - t0 < seconds:
            if len(done) + 1 == len(batches):
                raise RuntimeError("the traffic mix ran out of batches inside the window")
            serve(len(done) + 1)
        _sync(dev)
        window_s = time.perf_counter() - t0
        in_window = len(done)
        stages = tm.timer.summary()
        tr = None
        if trace:  # one more batch, traced, after the window
            with tracing.DeviceTrace() as traced:
                serve(len(done) + 1)
            tr = traced.summary
    finally:
        taps.close()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    samples = [len(w) for out in wavs for w in out]
    audio_s = sum(len(w) for out in wavs[:in_window] for w in out) / c.sample_rate
    tokens = [d[1].cpu().numpy() for d in taps.decodes]  # lengths of each batch's rows
    expect = [int(n) * c.token_mel_ratio * c.hift.upsample_scale for ln in tokens for n in ln]
    failed = sum(1 for out in wavs for w in out if not np.isfinite(w).all()) + sum(
        1 for a, b in zip(samples, expect) if a != b)
    ctx = {"timer": stages, "window_s": window_s, "audio_s": audio_s,
           "decode_steps": sum(int(d[2]) for d in taps.decodes[:in_window]),
           "batches": in_window, "trace": tr}
    if trace:
        ctx.update(_work(c, prec, done, taps, in_window))

    dec = [(d[0].cpu().numpy(), d[1].cpu().numpy()) for d in taps.decodes]
    mels = taps.mels
    del api, tm, taps
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, notes = _judge(cell, c, seed, dev, done, dec, mels, wavs, draws, t["limits"],
                           control)
    notes["batch_seconds"] = walls
    e2e = {"audio_s_per_s": audio_s / window_s, "setup_s": setup_s}
    return Outcome(e2e, ctx, checks, attempted=len(samples), failed=failed,
                   memory_peak_bytes=peak, trace=tr, notes=notes)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _work(c, prec, done, taps, in_window: int) -> dict:
    """The model FLOPs of the window's batches and the K1 calls of the
    traced batch after them."""
    count = flops.FlowFlops(c)
    total = 0.0
    ratio = c.token_mel_ratio
    est = c.flow.estimator
    mel_rows = []
    for b, (rows, dec) in enumerate(zip(done, taps.decodes)):
        mel_rows = []
        for r, n in zip(rows, dec[1].cpu().numpy()):
            n_flow = len(r["speech_tokens"]) + int(n)
            mel_rows.append(n_flow * ratio)
            if b < in_window:
                p_len = (2 + len(r["prompt_text_tokens"]) + len(r["text_tokens"])
                         + len(r["speech_tokens"]))
                total += flops.lm_forward_flops(c.llm, range(1, p_len + int(n) + 1))
                total += count.synthesis(n_flow) + count.hift(int(n) * ratio)
    per_call = c.flow.cfm.n_timesteps * est.n_blocks * (2 + est.num_mid_blocks)
    return {"model_flops": total, "peak_flops": flops.PEAK[prec["llm"]],
            "k1_calls": [mel_rows + mel_rows] * per_call, "k1_heads": est.num_heads,
            "k1_head_dim": est.attention_head_dim,
            "k1_elt": 2 if prec["flow"] == "bfloat16" else 4}


def _int8_lm(cell, c, seed, dev):
    """The program's int8 LM path: (its LM forward over a whole sequence,
    from the same weights)."""
    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.config import TTSConfig, config_from_dict
    from cosyvoice2_eu_torch.models import llm as port_llm

    cfg = config_from_dict(TTSConfig, cell.config["model"])
    api = cosy.load(config=cfg, params=weights.make_tts(c, seed, dev), device=str(dev),
                    compute_dtype=cell.config["precision"]["llm"], lm_quant="int8")
    llm = api._model.params["llm"]
    return lambda ids, src, valid: port_llm.lm_training_hidden(llm, cfg.llm, ids, src, valid)


def _judge(cell, c, seed, dev, done, dec, mels, wavs, draws, limits, control):
    """The three numbers over every batch of the window, the LM's over its
    greedy rows (and the control's, with ``control``)."""
    low_lm = _int8_lm(cell, c, seed, dev) if control else None
    params = weights.make_tts(c, seed, dev)
    gap = mel = wav = 0.0
    ctl = {"lm_logit_gap": 0.0, "lm_logit_gap_int8": 0.0, "flow_mel_rel": 0.0,
           "hift_wav_rel": 0.0}
    served = 0
    for rows, (toks, lens), mel_b, wav_b, d in zip(done, dec, mels, wavs, draws):
        idx = [i for i, r in enumerate(rows) if r["greedy"]]
        for i in idx:
            g, n, lows = _lm_gap(params["llm"], c.llm, rows[i], toks[i, :lens[i]], dev, low_lm,
                                 limits["special_margin"])
            gap, served = max(gap, g), served + n
            for k, v in lows.items():
                ctl[k] = max(ctl[k], v)
        every = list(range(len(rows)))
        m, m8 = _flow_err(params["flow"], c, rows, toks, lens, mel_b, every, dev, control)
        w, w8 = _hift_err(params["hift"], c, rows, lens, mel_b, wav_b, d, every, dev, control)
        mel, wav = max(mel, m), max(wav, w)
        ctl["flow_mel_rel"] = max(ctl["flow_mel_rel"], m8)
        ctl["hift_wav_rel"] = max(ctl["hift_wav_rel"], w8)
    checks = [Check("lm_logit_gap", gap, limits["lm_logit_gap"]),
              Check("flow_mel_rel", mel, limits["flow_mel_rel"]),
              Check("hift_wav_rel", wav, limits["hift_wav_rel"])]
    if served < limits.get("min_served_tokens", 1):
        short = float(limits["min_served_tokens"] - served)
        checks.append(Check("served_tokens_short", short, 0.0))
    notes = {"served_tokens_compared": served}
    if control:
        notes["control"] = ctl
    return checks, notes


def _lm_ids(row, tokens, cfg):
    text = np.concatenate([row["prompt_text_tokens"], row["text_tokens"]])
    sp = row["speech_tokens"]
    ids = np.concatenate([[cfg.sos_eos], text, [cfg.task_id], sp, tokens]).astype(np.int64)
    src = np.concatenate([[ref_lm.SRC_SPECIAL], [ref_lm.SRC_TEXT] * len(text),
                          [ref_lm.SRC_SPECIAL], [ref_lm.SRC_SPEECH] * (len(sp) + len(tokens))])
    return ids, src, 2 + len(text) + len(sp)


def _lm_gap(params, cfg, row, tokens, dev, low_lm, margin):
    """(widest gap, positions compared, {the controls' widest gaps}) of one
    row; ``low_lm`` is the program's int8 LM forward (control runs only)."""
    ids, src, p_len = _lm_ids(row, tokens, cfg)
    n_text = len(row["text_tokens"])
    min_len = int(n_text * cfg.min_token_text_ratio)
    max_len = int(n_text * cfg.max_token_text_ratio)
    ids_t = torch.as_tensor(ids, device=dev)[None]
    src_t = torch.as_tensor(src, device=dev)[None]
    valid = torch.ones_like(ids_t, dtype=torch.bool)
    with exact(), torch.no_grad():
        ref = ref_lm.lm_logits(params, cfg, ids_t, src_t, valid)[0, p_len - 1:].float()
    # the served tokens, then EOS where the row stopped before max_len
    want = list(tokens) + ([cfg.eos_token] if len(tokens) < max_len else [])
    ref = ref[:len(want)]
    pos = torch.arange(len(want), device=dev)
    banned = ((pos < min_len) | (pos == 0))[:, None] & (
        torch.arange(ref.shape[1], device=dev)[None] >= cfg.eos_token)
    best, arg = ref.masked_fill(banned, float("-inf")).max(-1)
    # an id past EOS is fed back without being served: the row's comparison
    # ends where one is within ``margin`` of the reference's best, as the
    # program may have taken it there
    extra = ref[:, cfg.eos_token + 1:].max(-1).values
    special = ((arg > cfg.eos_token) | (best - extra <= margin)).nonzero()
    n = int(special[0]) if len(special) else len(want)
    want_t = torch.as_tensor(want[:n], device=dev)
    g = float((best[:n] - ref[:n].gather(1, want_t[:, None].long())[:, 0]).max()) if n else 0.0
    lows = {}
    if low_lm is not None and n:
        with torch.no_grad():
            int8 = low_lm(ids_t, src_t, valid)[0, p_len - 1:].float()
            with lowered("fp8"):
                fp8 = ref_lm.lm_logits(params, cfg, ids_t, src_t, valid)[0, p_len - 1:].float()
        for key, low in (("lm_logit_gap_int8", int8), ("lm_logit_gap", fp8)):
            top = low[:n].masked_fill(banned[:n], float("-inf")).argmax(-1)
            lows[key] = float((best[:n] - ref[:n].gather(1, top[:, None])[:, 0]).max())
    return g, n, lows


def _flow_inputs(c, rows, toks, lens, idx, dev):
    ratio = c.token_mel_ratio
    totals = [len(rows[i]["speech_tokens"]) + int(lens[i]) for i in idx]
    bucket = max(totals)
    tok = np.zeros((len(idx), bucket), np.int64)
    feat = np.zeros((len(idx), bucket * ratio, c.flow.output_size), np.float32)
    for j, i in enumerate(idx):
        sp = rows[i]["speech_tokens"]
        tok[j, :len(sp)] = sp
        tok[j, len(sp):totals[j]] = toks[i, :lens[i]]
        feat[j, :len(rows[i]["prompt_feat"])] = rows[i]["prompt_feat"]
    t = lambda a, dt=None: torch.as_tensor(a, device=dev, dtype=dt)  # noqa: E731
    return (t(tok), t(totals), t(feat), t([len(rows[i]["prompt_feat"]) for i in idx]),
            t(np.stack([rows[i]["embedding"] for i in idx]))), totals


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a.double() - b.double())
                 / torch.linalg.vector_norm(b.double()).clamp_min(1e-30))


def _flow_err(params, c, rows, toks, lens, mel_b, idx, dev, control):
    """Each checked row's generated mel against the reference flow: (worst
    relative error, the control's)."""
    if not idx:
        return 0.0, 0.0
    args, totals = _flow_inputs(c, rows, toks, lens, idx, dev)
    with exact(), torch.no_grad():
        ref = ref_flow.flow_inference(params, c.flow, *args)
    low = None
    if control:
        with lowered("fp8"), torch.no_grad():
            low = ref_flow.flow_inference(params, c.flow, *args)
    ratio = c.token_mel_ratio
    err = err8 = 0.0
    for j, i in enumerate(idx):
        a, b = len(rows[i]["prompt_feat"]), totals[j] * ratio
        err = max(err, _rel(mel_b[i, :, a:b], ref[j, :, a:b]))
        if low is not None:
            err8 = max(err8, _rel(low[j, :, a:b], ref[j, :, a:b]))
    return err, err8


def _hift_err(params, c, rows, lens, mel_b, wav_b, d, idx, dev, control):
    """Each checked row's waveform against the reference HiFT on the
    program's mel (edge-padded to the bucket of the program's HiFT calls,
    as the program vocodes it) with the row's draws: (worst relative error, the control's)."""
    if not idx:
        return 0.0, 0.0
    ratio, scale = c.token_mel_ratio, c.hift.upsample_scale
    mel_lens = [int(lens[i]) * ratio for i in range(len(rows))]
    sub, length, _ = d.hift_shapes[0]  # the program's sub-batch and mel bucket
    h_bucket = length // scale
    calls = d.replay_hift()
    err = err8 = 0.0
    for i in idx:
        a = len(rows[i]["prompt_feat"])
        seg = mel_b[i, :, a:a + mel_lens[i]]
        mel_in = torch.cat([seg, seg[:, -1:].expand(-1, h_bucket - seg.shape[1])], dim=1)[None]
        rand_ini, noise = calls[i // sub]
        dr = (rand_ini[i % sub:i % sub + 1], noise[i % sub:i % sub + 1])
        with exact(), torch.no_grad():
            ref = ref_hift.hift_inference(params, c.hift, mel_in.float(), draws=dr)[0][0]
        want = ref[:mel_lens[i] * scale]
        got = torch.as_tensor(wav_b[i], device=dev)
        err = max(err, _rel(got, want))
        if control:
            with lowered("tf32"), torch.no_grad():
                low = ref_hift.hift_inference(params, c.hift, mel_in.float(), draws=dr)[0][0]
            err8 = max(err8, _rel(low[:mel_lens[i] * scale], want))
    return err, err8
