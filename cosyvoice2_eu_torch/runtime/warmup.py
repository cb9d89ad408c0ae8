"""Fill the store of compiled artifacts ahead of serving, and drive the serving modes once.

Counterpart of ``cosyvoice2_eu_tpu/runtime/warmup.py``.  The port's compiled
artifacts are the kernel libraries nvcc builds (``runtime/aot_cache.py``):
run this once when a model is packaged and ship ``<model_dir>/aot_store``
with the weights; ``load()`` picks the store up, so a fresh machine's first
audio needs no nvcc.

    python -m cosyvoice2_eu_torch.cli warmup --model-dir DIR            # into DIR/aot_store
    python -m cosyvoice2_eu_torch.cli warmup --export-store PATH [--batch 20]

``warmup_programs`` builds every kernel library into the active store at
once (on a CUDA model), then drives each prompt bucket through ``tts``
without streaming and twice with streaming (the second primes from the
per-prompt cache), and ``tts_batch`` when asked.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

import numpy as np

from cosyvoice2_eu_torch.utils.synthetic import synthetic_prompt

logger = logging.getLogger(__name__)


def build_kernels() -> dict:
    """Every kernel library in the active store, built at once where
    missing, and loaded; returns a copy of ``store_stats``."""
    from cosyvoice2_eu_torch.ops import cuda_build
    from cosyvoice2_eu_torch.runtime import aot_cache

    cuda_build.build(cuda_build.SOURCES)
    for source in cuda_build.SOURCES:
        cuda_build.load_library(source)
    return {k: list(v) for k, v in aot_cache.store_stats.items()}


def warmup_programs(model, prompt_seconds=(3, 6, 10), batch: int = 0) -> dict:
    """Fill the store for ``model`` (a ``TTSModel``) and drive its modes;
    returns {"modes", "seconds", "store_stats"}."""
    cfg = model.cfg
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    stats = build_kernels() if model.device.type == "cuda" else {"loaded": [], "built": []}
    n_modes = 0
    for secs in prompt_seconds:
        p = synthetic_prompt(cfg, rng, int(secs * cfg.flow.input_frame_rate))
        for _ in model.tts(p, stream=False):
            pass
        # twice: the first primes the prompt's cached flow state, the second starts from it
        for _ in range(2):
            for _ in model.tts(p, stream=True):
                pass
        n_modes += 3
        logger.info("warmup: prompt %ss done (%.1f s elapsed)", secs, time.perf_counter() - t0)
    if batch:
        prompts = [synthetic_prompt(cfg, np.random.default_rng(10 + i),
                                    int(6 * cfg.flow.input_frame_rate)) for i in range(batch)]
        model.tts_batch(prompts)
        n_modes += 1
    return {"modes": n_modes, "seconds": time.perf_counter() - t0, "store_stats": stats}


def warmup_engine(model, n_slots: int = 4) -> dict:
    """Run ``n_slots`` concurrent requests through a ``TTSEngine`` twice (the
    second round reaches the escalated chunk sizes warm)."""
    from cosyvoice2_eu_torch.serving.engine import TTSEngine

    t0 = time.perf_counter()
    cfg = model.cfg
    engine = TTSEngine(model, n_slots=n_slots)
    try:
        for _ in range(2):
            handles = [engine.submit(synthetic_prompt(cfg, np.random.default_rng(100 + i),
                                                      int(6 * cfg.flow.input_frame_rate)))
                       for i in range(n_slots)]
            threads = [threading.Thread(target=lambda h=h: list(h)) for h in handles]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
    finally:
        engine.close()
    return {"engine_seconds": time.perf_counter() - t0}


def warmup_main(argv=None) -> int:
    """``cosy2-eu warmup``: prints {"store", "aot_entries", "modes",
    "seconds", "store_stats", ...} as one JSON line."""
    import argparse

    p = argparse.ArgumentParser(prog="cosy2-eu warmup",
                                description="Build the kernel store and drive the serving modes")
    p.add_argument("--model-dir", default=None)
    p.add_argument("--export-store", default=None,
                   help="store dir (default <model_dir>/aot_store)")
    p.add_argument("--backbone", default=None)
    p.add_argument("--batch", type=int, default=0, help="also run tts_batch at this size")
    p.add_argument("--engine-slots", type=int, default=0,
                   help="also run the serving engine with this many slots")
    p.add_argument("--prompt-seconds", default="3,6,10")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from cosyvoice2_eu_torch.runtime import aot_cache

    store = args.export_store or (
        os.path.join(args.model_dir, "aot_store") if args.model_dir else None)
    if store and not os.environ.get("COSY_AOT_CACHE"):
        aot_cache.set_cache_dir(store)

    import cosyvoice2_eu_torch as cosy

    if args.model_dir:
        api = cosy.load(model_dir=args.model_dir, backbone=args.backbone, device=args.device)
    else:  # the kernels depend on the card and the sources, not on the weights
        api = cosy.load(config=cosy.TTSConfig(), backbone=args.backbone, seed=0,
                        device=args.device)
    secs = tuple(float(s) for s in args.prompt_seconds.split(","))
    stats = warmup_programs(api._model, prompt_seconds=secs, batch=args.batch)
    if args.engine_slots:
        stats.update(warmup_engine(api._model, n_slots=args.engine_slots))
    d = aot_cache.cache_dir()
    print(json.dumps({"store": d, "aot_entries": len(aot_cache.store_entries(d)), **stats}))
    return 0
