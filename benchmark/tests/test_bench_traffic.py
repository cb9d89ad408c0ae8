"""The traffic generators: one seed gives the same inputs, another seed
other content at the same sizes."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from conftest import BATCH_MIX
from harness import registry, traffic
from reference.config import model_config

MIXES = ["batch16", "lm_train", "flow_train"]


def _mix(name):
    if name == "batch16":
        return dict(BATCH_MIX)
    with open(os.path.join(registry.BENCH_DIR, "traffic", name + ".json")) as f:
        return json.load(f)


def _cfg():
    with open(os.path.join(registry.BENCH_DIR, "configs", "cosyvoice2-0.5b.json")) as f:
        return model_config(json.load(f)["model"])


def _arrays(x):
    if isinstance(x, np.ndarray):
        return [x]
    if isinstance(x, dict):
        return [a for v in x.values() for a in _arrays(v)]
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _arrays(v)]
    return [np.asarray(x)]


def _sizes(name, out):
    if name == "batch16":
        return sorted((len(r["text_tokens"]), len(r["speech_tokens"]), len(r["prompt_text_tokens"]))
                      for b in out for r in b)
    if name == "lm_train":
        return sorted((len(t), len(s)) for texts, sp in out for t, s in zip(texts, sp))
    return sorted(int(n) for b in out for n in b["speech_feat_len"])


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_inputs_other_seed_other_content(name):
    t, c = _mix(name), _cfg()
    a, b, other = (traffic.generate(t, c, s) for s in (2**31 + 3, 2**31 + 3, 2**31 + 4))
    assert all(np.array_equal(x, y) for x, y in zip(_arrays(a), _arrays(b)))
    # the same shapes in another order, and other content at each shape
    same_shape = {}
    for x in _arrays(a):
        same_shape.setdefault(x.shape, []).append(x)
    pairs = [(same_shape[y.shape].pop(), y) for y in _arrays(other)
             if y.size > 1 and same_shape.get(y.shape)]
    assert pairs and not all(np.array_equal(x, y) for x, y in pairs)
    assert _sizes(name, a) == _sizes(name, other)  # the work is the seed's order, not its size


def test_batch16_sizes():
    t, c = _mix("batch16"), _cfg()
    batches = traffic.generate(t, c, 11)
    for rows in batches:
        assert len(rows) == t["batch"] and sum(r["greedy"] for r in rows) == t["greedy"]
        assert sorted(len(r["text_tokens"]) for r in rows) == list(range(5, 21))
        for r in rows:
            assert 75 <= len(r["speech_tokens"]) <= 250
            assert r["prompt_feat"].shape == (2 * len(r["speech_tokens"]), 80)
            # every row stays inside the largest flow bucket at its max_len
            assert len(r["speech_tokens"]) + 20 * len(r["text_tokens"]) <= 1024


def test_dynamic_batches_keep_the_cap():
    sizes = traffic.spread(291, 579, 300)[np.random.default_rng(0).permutation(300)]
    batches = traffic.dynamic_batches(sizes, 2400)
    assert sorted(i for b in batches for i in b) == list(range(300))
    assert all(len(b) * max(sizes[i] for i in b) <= 2400 for b in batches)


@pytest.mark.parametrize("name,key,lo,hi", [("lm_train", "speech_tokens", 250, 500),
                                            ("flow_train", "frames", 500, 1000)])
def test_training_lengths_span_mls_segments(name, key, lo, hi):
    """10-20 s utterances: 25 speech tokens or 50 mel frames a second."""
    t, c = _mix(name), _cfg()
    assert t[key] == [lo, hi]
    out = traffic.generate(t, c, 5)
    if name == "lm_train":
        sizes = [len(s) for _, sp in out for s in sp]
        texts = [len(x) for tx, _ in out for x in tx]
        assert sum(sizes) / sum(texts) == pytest.approx(t["speech_per_text"], rel=0.02)
    else:
        sizes = [int(n) for b in out for n in b["speech_feat_len"]]
    assert len(sizes) == t["utterances"] and min(sizes) == lo and max(sizes) == hi
