"""Per-stage timing of the port: LM prefill, LM decode, flow, HiFT.

Counterpart of ``tools/profile_stages.py`` (the JAX package's), on the same
stages and shapes: ``lm_prefill`` at P = 256 (640 generated slots), two
chunks of 100 decode steps, the flow at token buckets 1024 and 128, HiFT at
2048 and 256 mel frames, each timed after one untimed call, on the host
clock around work that ends in a synchronisation of the card.  Random
weights from seed 0 at the published widths.

``--trace DIR`` wraps one decode chunk of 25 steps (the streaming path's
and the serving engine's chunk) and one flow call (token bucket 1024) in
``utils/profiling.py::device_trace`` and prints, for each, the share of the
block's wall time in which the card ran a kernel or a copy (from the
trace's device events) and the five kernels with the most device time.
Without a card there is no device share to print.

    python -m cosyvoice2_eu_torch.tools.profile_stages [--device cuda] [--trace DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

P, GEN = 256, 640
TRACE_STEPS = 25


def _timed(fn, sync, n: int):
    """(seconds per call over ``n`` calls after one untimed call, last output)."""
    out = fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    sync()
    return (time.perf_counter() - t0) / n, out


DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")  # the trace's categories of device work


def trace_summary(trace_path: str, wall_s: float, top: int = 5) -> dict:
    """The device's busy share of a traced block (the union of its device
    events, kernels and copies, over the block's wall time; None without
    device events) and the ``top`` of them by device time: [(name, ms,
    calls)].  Read from the Chrome trace: the profiler's own event list
    takes minutes to build for a decode chunk's ~10^5 events."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_EVENTS]
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in events:
        us, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (us + e["dur"], n + 1)
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall_s * 1e3, "device_events": len(events),
            "busy_share": busy_us / (wall_s * 1e6) if events else None,
            "top": [(name, us / 1e3, n) for name, (us, n) in kernels]}


def run(cfg=None, device: str = "cuda", trace_dir=None, compute_dtype="bfloat16",
        seed: int = 0, log=print) -> dict:
    """Time every stage of ``load(config=cfg, seed=seed)`` on ``device``
    (``cfg``: the published widths by default); prints one line a stage
    through ``log`` and returns {stage: ms} (and "trace": {"decode",
    "flow"} summaries of ``trace_summary`` with "trace_s", the traced
    block's seconds with the profiler's own work, with ``trace_dir``)."""
    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.models import llm as llm_mod
    from cosyvoice2_eu_torch.models.flow import flow_inference
    from cosyvoice2_eu_torch.models.hift import hift_inference

    cfg = cfg or cosy.TTSConfig()
    api = cosy.load(config=cfg, seed=seed, device=device, compute_dtype=compute_dtype,
                    download=False)
    tm = api._model
    params, dev = tm.params, tm.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    out: dict = {}

    def report(name, s):
        out[name] = s * 1e3
        log(f"{name}: {s * 1e3:.1f} ms [{dev}]")

    with torch.no_grad():
        ids, src = t(rng.integers(0, 1000, (1, P))), t(rng.integers(0, 3, (1, P)))
        plen = t([197])
        dt, state = _timed(lambda: llm_mod.lm_prefill(params["llm"], cfg.llm, ids, src, plen,
                                                      GEN), sync, 3)
        report(f"lm_prefill({P})", dt)

        gen = torch.Generator(device=dev).manual_seed(seed)
        draws = llm_mod.generator_draws(gen, 1, cfg.llm)
        lens = t([600])

        def chunk(st, target):
            return llm_mod.lm_decode_chunk(params["llm"], cfg.llm, dataclasses.replace(st),
                                           plen, lens, lens, target, draws)

        dt, state2 = _timed(lambda: chunk(state, 100), sync, 1)
        report("lm_decode 100 steps", dt)
        log(f"  -> {dt * 10:.2f} ms/token [{dev}]")
        dt, _ = _timed(lambda: chunk(state2, 200), sync, 1)
        report("lm_decode next 100 steps", dt)

        tok = t(rng.integers(0, cfg.flow.vocab_size, (1, 1024)))
        feat = t(rng.standard_normal((1, 2048, cfg.flow.output_size)).astype(np.float32))
        emb = t(rng.standard_normal((1, cfg.frontend.spk_embed_dim)).astype(np.float32))

        def flow(n_tok, n_len, n_feat):
            return flow_inference(params["flow"], cfg.flow, tok[:, :n_tok], t([n_len]),
                                  feat[:, :2 * n_tok], t([n_feat]), emb)

        dt, _ = _timed(lambda: flow(1024, 750, 300), sync, 2)
        report("flow_inference(tok_bucket=1024, mel=2048)", dt)
        dt, _ = _timed(lambda: flow(128, 120, 100), sync, 2)
        report("flow_inference(tok_bucket=128)", dt)

        for mel in (2048, 256):
            m = t(rng.standard_normal((1, cfg.hift.in_channels, mel)).astype(np.float32))
            hgen = torch.Generator(device=dev).manual_seed(1)
            dt, _ = _timed(lambda: hift_inference(params["hift"], cfg.hift, m, generator=hgen),
                           sync, 2)
            report(f"hift({mel} mel)", dt)

        if trace_dir is not None:
            from cosyvoice2_eu_torch.utils.profiling import device_trace

            out["trace"] = {}
            for name, fn in (("decode", lambda: chunk(state, TRACE_STEPS)),
                             ("flow", lambda: flow(1024, 750, 300))):
                sync()
                t_trace = time.perf_counter()
                with device_trace(trace_dir) as prof:
                    t0 = time.perf_counter()
                    fn()
                    sync()
                    wall = time.perf_counter() - t0
                s = out["trace"][name] = trace_summary(prof.trace_path, wall)
                s["trace_s"] = time.perf_counter() - t_trace  # the profiler's own cost included
                share = ("no device events (no card)" if s["busy_share"] is None
                         else f"{100 * s['busy_share']:.1f}%")
                log(f"trace {name}: wall {s['wall_ms']:.1f} ms, device busy {share}; the "
                    f"traced block with the profiler's work {s['trace_s']:.2f} s [{dev}]")
                for k, ms, n in s["top"]:
                    log(f"  {ms:.3f} ms in {n} launches: {k}")
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="trace one decode chunk and one flow call into DIR")
    args = p.parse_args(argv)
    out = run(device=args.device, trace_dir=args.trace)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
