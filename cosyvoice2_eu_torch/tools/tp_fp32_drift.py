"""Where an fp32 tensor-parallel prefill departs from the whole LM.

Qwen2-0.5B at its published widths (random weights, seed 0), the prompt of
``chip_smoke.py``'s tp phase (128 positions), on one GPU shared by 2 gloo
ranks; rank 0 prints one JSON object:

* ``layers``: after each decoder layer, max|tp=2 - tp=1| / max|tp=1| of the
  hidden states, each side fed its own previous output (``carried``), and
  the tp=2 layer fed tp=1's input (``fresh``: one layer's own error);
* ``logits``: the prefill's last-position logits, max|err| / max|logits|,
  for tp=2 against tp=1, and for three one-process changes of the whole
  LM's rounding: ``split_sums`` (o_proj and down_proj summed as two halves
  of their inputs, the tp=2 order, no collective), ``cpu`` (the same LM on
  the host) and ``input_ulp`` (the embeddings scaled by 1 + 2^-23 times a
  seeded sign, one rounding's size); each with the K/V kept in fp32, and
  ``*_bf16_cache`` with them rounded to the bf16 KV cache that
  ``lm_prefill`` writes and attends over (the JAX package's cache type);
* ``cache_flips``: the bf16 cache entries (this rank's kv head) that differ
  between tp=2 and tp=1, and of how many;
* ``attention_heads``: max|diff| of layer 0's attention output for query
  heads 0-6 computed with all 14 heads and with those 7 alone.

Run from the root of a checkout:  python -m cosyvoice2_eu_torch.tools.tp_fp32_drift
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import traceback


def tp_prompt(cfg, device):
    """A packed LM prompt in the Qwen2 LM's layout (sos, 40 text ids, the
    task id, 75 prompt speech tokens), seeded, in the 128 bucket: (ids, src,
    prompt_len, bucket); ``chip_smoke.py``'s tp phase runs on it too."""
    import numpy as np
    import torch

    from cosyvoice2_eu_torch.models import llm as llm_mod

    rng = np.random.default_rng(3)
    n_text, n_sp, p_bucket = 40, 75, 128
    ids = np.zeros((1, p_bucket), np.int64)
    src = np.zeros((1, p_bucket), np.int64)
    ids[0, 1:1 + n_text] = rng.integers(2, 20000, n_text)
    src[0, 1:1 + n_text] = llm_mod.SRC_TEXT
    ids[0, 1 + n_text] = cfg.llm.task_id
    ids[0, 2 + n_text:2 + n_text + n_sp] = rng.integers(0, cfg.llm.speech_token_size, n_sp)
    src[0, 2 + n_text:2 + n_text + n_sp] = llm_mod.SRC_SPEECH
    t = lambda a: torch.tensor(a, device=device)  # noqa: E731
    return t(ids), t(src), t([2 + n_text + n_sp]), p_bucket


def _rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def _causal(plen, p: int, bb):
    """The prompt's attention bias (B, 1, P, P) and its RoPE tables."""
    import torch

    from cosyvoice2_eu_torch.models.qwen2 import rope_cos_sin
    from cosyvoice2_eu_torch.ops.masks import NEG_INF

    pos = torch.arange(p, device=plen.device)
    mask = (pos[None, None, :] <= pos[None, :, None]) & (pos[None, None, :] < plen[:, None, None])
    return torch.where(mask, 0.0, NEG_INF)[:, None], *rope_cos_sin(pos, bb)


def _forward(params, cfg, ids, src, plen, embeds=None, cache=None):
    """The prefill: (the last position's logits, every layer's input and
    output, the KV cache); K/V through a cache of dtype ``cache`` (as
    ``qwen2_prefill``), or kept as computed when None."""
    import torch

    from cosyvoice2_eu_torch.models import llm as llm_mod
    from cosyvoice2_eu_torch.models.qwen2 import KVCache, _layer_forward, local_kv_heads
    from cosyvoice2_eu_torch.utils.params import rms_norm

    bb = cfg.llm.backbone
    x = llm_mod.embed_mixed(params, ids, src) if embeds is None else embeds
    b, p = x.shape[:2]
    bias, cos, sin = _causal(plen, p, bb)
    kv = (None if cache is None else KVCache.zeros(
        bb, b, p, x.device, dtype=cache, num_kv_heads=local_kv_heads(params["backbone"], bb)))
    ins, outs = [], []
    for i, lp in enumerate(params["backbone"]["layers"]):
        ins.append(x)
        x = _layer_forward(lp, bb, x, cos, sin, bias, kv=kv, layer_idx=i, attn_len=p)
        outs.append(x)
    x = rms_norm(params["backbone"]["norm"], x, bb.rms_norm_eps)
    last = x[torch.arange(b), plen - 1]
    return llm_mod.head_logits(params, cfg.llm, last), ins, outs, kv


def _rank(rank: int, world: int, cfg, device: str) -> dict:
    """One rank's readings (rank 0 also makes the one-process ones)."""
    import torch

    from cosyvoice2_eu_torch.models import llm as llm_mod
    from cosyvoice2_eu_torch.models import qwen2
    from cosyvoice2_eu_torch.parallel.tp import make_tp_mesh, shard_lm_tp
    from cosyvoice2_eu_torch.utils.device import resolve_device
    from cosyvoice2_eu_torch.utils.params import dense, rms_norm, tree_map

    dev = resolve_device(device)  # fp32 stays fp32: no TF32
    bb = cfg.llm.backbone
    ids, src, plen, _ = tp_prompt(cfg, dev)
    out = {}
    with torch.no_grad():
        whole = llm_mod.init_lm(torch.Generator(device=dev).manual_seed(0), cfg.llm)
        local = shard_lm_tp(whole, make_tp_mesh(world), cfg.llm)
        want, want_ins, want_outs, _ = _forward(whole, cfg, ids, src, plen)
        got, _, got_outs, _ = _forward(local, cfg, ids, src, plen)
        want16, _, _, kv1 = _forward(whole, cfg, ids, src, plen, cache=torch.bfloat16)
        got16, _, _, kv2 = _forward(local, cfg, ids, src, plen, cache=torch.bfloat16)
        mine = slice(rank * kv2.k.shape[2], (rank + 1) * kv2.k.shape[2])
        flips = sum(int((a[:, :, mine] != b).sum()) for a, b in ((kv1.k, kv2.k), (kv1.v, kv2.v)))
        out["cache_flips"] = (flips, 2 * kv2.k.numel())
        bias, cos, sin = _causal(plen, ids.shape[1], bb)
        out["layers"] = {
            "carried": [_rel(g, w) for g, w in zip(got_outs, want_outs)],
            "fresh": [_rel(qwen2._layer_forward(lp, bb, x, cos, sin, bias), w)
                      for lp, x, w in zip(local["backbone"]["layers"], want_ins, want_outs)]}
        out["logits_peak"] = want.abs().max().item()
        logits = {"tp2": _rel(got, want), "tp2_bf16_cache": _rel(got16, want16)}
        if rank == 0:
            row_parallel = qwen2._row_parallel

            def split_sums(p, x, full):
                half = x.shape[-1] // 2
                w = p["weight"]
                y = (dense({"weight": w[:, :half]}, x[..., :half])
                     + dense({"weight": w[:, half:]}, x[..., half:]))
                return y + p["bias"] if "bias" in p else y

            qwen2._row_parallel = split_sums
            try:
                logits["split_sums"] = _rel(_forward(whole, cfg, ids, src, plen)[0], want)
                logits["split_sums_bf16_cache"] = _rel(_forward(
                    whole, cfg, ids, src, plen, cache=torch.bfloat16)[0], want16)
            finally:
                qwen2._row_parallel = row_parallel
            emb = want_ins[0]
            gen = torch.Generator(device=dev).manual_seed(1)
            sign = torch.randint(-1, 2, emb.shape, generator=gen, device=dev).float()
            nudged = emb * (1 + sign * 2.0 ** -23)
            logits["input_ulp"] = _rel(_forward(whole, cfg, ids, src, plen, embeds=nudged)[0],
                                       want)
            logits["input_ulp_bf16_cache"] = _rel(_forward(
                whole, cfg, ids, src, plen, embeds=nudged, cache=torch.bfloat16)[0], want16)
            if dev.type == "cuda":
                host = tree_map(lambda t: t.cpu(), whole)
                logits["cpu"] = _rel(_forward(host, cfg, ids.cpu(), src.cpu(),
                                              plen.cpu())[0].to(dev), want)
                logits["cpu_bf16_cache"] = _rel(_forward(
                    host, cfg, ids.cpu(), src.cpu(), plen.cpu(), cache=torch.bfloat16)[0].to(dev),
                    want16)
                del host
            # layer 0's attention: query heads 0..g-1 among all, and alone
            lp = whole["backbone"]["layers"][0]
            h = rms_norm(lp["input_layernorm"], emb, bb.rms_norm_eps)
            t, hd = h.shape[1], bb.head_dim
            q, k, v = (dense(lp[n], h).reshape(1, t, -1, hd).transpose(1, 2)
                       for n in ("q_proj", "k_proj", "v_proj"))
            g = bb.num_heads // bb.num_kv_heads
            every = qwen2._attention(q, k, v, bias, g)[:, :g]
            alone = qwen2._attention(q[:, :g], k[:, :1], v[:, :1], bias, g)
            out["attention_heads"] = (every - alone).abs().max().item()
        out["logits"] = logits
    return out


def _entry(rank: int, world: int, init_file: str, out_file: str) -> None:
    import torch

    try:
        import torch.distributed as dist

        from cosyvoice2_eu_torch.config import TTSConfig

        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=world)
        try:
            res = {"ok": _rank(rank, world, TTSConfig(), "cuda")}
        finally:
            dist.destroy_process_group()
    except BaseException:
        res = {"error": traceback.format_exc()}
    torch.save(res, out_file)


def main() -> int:
    import multiprocessing as mp

    import torch

    if not torch.cuda.is_available():
        print("tp_fp32_drift needs a GPU", file=sys.stderr)
        return 1
    world = 2
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="cosy_tp_drift_") as d:
        outs = [os.path.join(d, f"rank{r}.pt") for r in range(world)]
        procs = [ctx.Process(target=_entry, args=(r, world, os.path.join(d, "rendezvous"),
                                                  outs[r])) for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        res = [torch.load(o, weights_only=False) if os.path.exists(o) else {"error": "no result"}
               for o in outs]
    for r, x in enumerate(res):
        if "error" in x:
            print(f"rank {r} failed:\n{x['error']}", file=sys.stderr)
            return 1
    print(json.dumps({"rank0": res[0]["ok"], "rank1_logits": res[1]["ok"]["logits"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
