"""The general traffic generator: every mix is a JSON file of parameters.

A mix names its ``generator`` (a function below) and its sizes.  Sizes are
fixed by the file: one seed differs from another only in the order of the
work and in its content (ids, features, which rows decode greedily), so
every seed asks for the same amount of work.  Copied ideas: the synthetic
prompt of the port's ``utils/synthetic.py::synthetic_prompt`` (random codes,
a mel centred at -4 with spread 0.5, a normal x-vector) and the flow batch
of ``chip_smoke.py::_flow_batch``; the dynamic batching of the reference
recipe's ``processor.py`` (sort, then fill batches to a cap of padded
frames or tokens).
"""

from __future__ import annotations

import numpy as np


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator for one use of a run's seed."""
    return np.random.default_rng([int(seed) % (2**64), stream])


def spread(lo: int, hi: int, n: int) -> np.ndarray:
    """n sizes evenly spaced over [lo, hi]."""
    return np.round(np.linspace(lo, hi, n)).astype(np.int64)


def dynamic_batches(sizes, cap: int) -> list:
    """Indices of ``sizes`` sorted by size, cut into batches whose padded
    size (rows x longest) stays within ``cap``."""
    batches, cur = [], []
    for i in np.argsort(sizes, kind="stable"):
        if cur and int(sizes[i]) * (len(cur) + 1) > cap:  # sorted: row i is the longest
            batches.append(cur)
            cur = []
        cur.append(int(i))
    if cur:
        batches.append(cur)
    return batches


def text_ids(r: np.random.Generator, cfg, n: int) -> np.ndarray:
    """n text ids from [100, 50000) (as the port's synthetic prompt), within
    the backbone's vocabulary."""
    return r.integers(100, min(50000, cfg.llm.backbone.vocab_size), n).astype(np.int32)


def tts_requests(t: dict, cfg, seed: int) -> list:
    """Batches of synthesis requests (``t["batches"]`` of ``t["batch"]``
    rows).  Each batch holds the same sizes: prompts of ``prompt_tokens``
    speech codes (25 a second) with ``prompt_text_tokens`` ids, targets of
    ``text_tokens`` ids, each spread evenly over its range and paired in one
    fixed order for every seed; the seed orders the rows, draws their content and picks
    ``greedy`` rows a batch that decode greedily.  Returns [[request dict]]."""
    b = t["batch"]
    sp = spread(*t["prompt_tokens"], b)
    pt = spread(*t["prompt_text_tokens"], b)
    tx = spread(*t["text_tokens"], b)[rng_for(0, 999).permutation(b)]  # one pairing for all seeds
    out = []
    for k in range(t["batches"]):
        r = rng_for(seed, 1000 + k)
        rows = []
        greedy = set(r.choice(b, size=t["greedy"], replace=False).tolist())
        for j, i in enumerate(r.permutation(b)):
            codes = r.integers(0, cfg.llm.speech_token_size, sp[i]).astype(np.int32)
            rows.append({
                "text_tokens": text_ids(r, cfg, tx[i]),
                "prompt_text_tokens": text_ids(r, cfg, pt[i]),
                "speech_tokens": codes,
                "prompt_feat": (r.standard_normal((2 * sp[i], cfg.flow.output_size)) * 0.5
                                - 4.0).astype(np.float32),
                "embedding": r.standard_normal(cfg.frontend.spk_embed_dim).astype(np.float32),
                "greedy": j in greedy,
            })
        out.append(rows)
    return out


def lm_sequences(t: dict, cfg, seed: int) -> list:
    """Text and speech id sequences for LM training, in dynamic batches.
    Speech lengths: ``utterances`` sizes evenly spread over
    ``speech_tokens``; text one id per ``speech_per_text`` speech tokens.  Sorted and batched to
    ``cap_padded_tokens`` (text + speech + 3 specials a row); the seed
    orders the batches and draws the ids.  Returns [(texts, speeches)]."""
    sp = spread(*t["speech_tokens"], t["utterances"])
    tx = np.maximum(1, np.round(sp / t["speech_per_text"])).astype(np.int64)
    batches = dynamic_batches(sp + tx + 3, t["cap_padded_tokens"])
    r = rng_for(seed, 2000)
    out = []
    for k in r.permutation(len(batches)):
        idx = batches[k]
        out.append(([text_ids(r, cfg, tx[i]) for i in idx],
                    [r.integers(0, cfg.llm.speech_token_size, sp[i]).astype(np.int32)
                     for i in idx]))
    return out


def flow_utterances(t: dict, cfg, seed: int) -> list:
    """Flow training batches in the dataset's dict form (numpy): mel frames
    of ``utterances`` sizes evenly spread over ``frames`` (rounded to whole
    tokens, ``token_mel_ratio`` frames a token),
    sorted and batched to ``cap_padded_frames``; the seed orders the batches
    and draws codes, features and x-vectors."""
    ratio = cfg.flow.token_mel_ratio
    fr = np.round(spread(*t["frames"], t["utterances"]) / ratio).astype(np.int64) * ratio
    batches = dynamic_batches(fr, t["cap_padded_frames"])
    r = rng_for(seed, 3000)
    out = []
    for k in r.permutation(len(batches)):
        lens = np.asarray([fr[i] for i in batches[k]], np.int32)
        b, t_mel = len(lens), int(lens.max())
        out.append({
            "speech_token": r.integers(0, cfg.flow.vocab_size,
                                       (b, t_mel // ratio)).astype(np.int32),
            "speech_token_len": lens // ratio,
            "speech_feat": (r.standard_normal((b, t_mel, cfg.flow.output_size)) * 0.5
                            - 4.0).astype(np.float32),
            "speech_feat_len": lens,
            "embedding": r.standard_normal((b, cfg.flow.spk_embed_dim)).astype(np.float32),
        })
    return out


GENERATORS = {"tts_requests": tts_requests, "lm_sequences": lm_sequences,
              "flow_utterances": flow_utterances}


def generate(t: dict, cfg, seed: int):
    return GENERATORS[t["generator"]](t, cfg, seed)
