"""The port's training data pipeline (``train/dataset.py``) and the LM's
batches (``train/train.py::lm_batches``; the row padding,
``parallel/mesh.py::pad_rows``) against
the JAX package's, on synthetic parquet shards made from a seed: every
stage, and the whole pipeline for the LM and the GAN, give the same arrays.

Both pipelines get the same numpy mel function.  JAX draws from Python's
global ``random``, seeded here before each run; the port gets a
``random.Random`` of the same seed.  The GAN pipeline's F0 targets come from
the native YIN in both: JAX's dispatch is pointed at the port's library
(the same source and flags; ``tests/test_torch_pitch.py`` holds the two
libraries equal), so that this file loads no library another test process
may be building."""

import random
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import cosyvoice2_eu_tpu.utils.native as jax_native
from cosyvoice2_eu_torch import config as port_config
from cosyvoice2_eu_torch.frontend.tokenizer import ByteFallbackTokenizer as PortTokenizer
from cosyvoice2_eu_torch.ops.mel import host_mel_fn
from cosyvoice2_eu_torch.parallel import mesh as port_mesh
from cosyvoice2_eu_torch.train import dataset as pds
from cosyvoice2_eu_torch.train import train as port_train
from cosyvoice2_eu_torch.train.train_gan import gan_mel_fn
from cosyvoice2_eu_torch.utils.native import yin_f0
from cosyvoice2_eu_tpu import config as jax_config
from cosyvoice2_eu_tpu.frontend.tokenizer import ByteFallbackTokenizer as JaxTokenizer
from cosyvoice2_eu_tpu.train import dataset as jds
from cosyvoice2_eu_tpu.train import train as jax_train

MEL = host_mel_fn(port_config.MelConfig())
GAN_MEL = gan_mel_fn(port_config.TTSConfig())
TEXTS = ["Bonjour tout le monde.", "Il y a trois chats sur le toit.", "Salut !",
         "La mer est calme ce matin, et le ciel est clair."]


def _rows(rng, n, prefix):
    rows = {k: [] for k in ("utt", "text", "speech", "sample_rate", "speech_token",
                            "reject_speech_token", "utt_embedding", "spk_embedding")}
    for i in range(n):
        sr = 16000 if i % 4 == 3 else 24000
        seconds = rng.uniform(0.8, 2.6)
        t = np.arange(int(sr * seconds)) / sr
        wav = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 250) * t) \
            + rng.standard_normal(len(t)) * 0.05
        if i % 5 == 1:
            wav *= 4.0  # a peak above 0.95: scaled down by resample()
        n_tok = int(seconds * 25)
        if i == 2:
            n_tok = 0  # filtered out: no speech tokens
        rows["utt"].append(f"{prefix}_{i}")
        rows["text"].append(TEXTS[i % len(TEXTS)])
        rows["speech"].append(wav.astype(np.float32).tolist())
        rows["sample_rate"].append(sr)
        rows["speech_token"].append(rng.integers(0, 81, n_tok).astype(np.int32).tolist())
        rows["reject_speech_token"].append(
            rng.integers(0, 81, max(n_tok - 3, 1)).astype(np.int32).tolist())
        rows["utt_embedding"].append(rng.standard_normal(16).astype(np.float32).tolist())
        rows["spk_embedding"].append(rng.standard_normal(16).astype(np.float32).tolist())
    return rows


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("parquet")
    paths = []
    for s in range(3):
        p = root / f"shard_{s}.parquet"
        # 5-row record batches: the opener reads several per file
        pq.write_table(pa.table(_rows(rng, 7, f"s{s}")), str(p), row_group_size=5)
        paths.append(str(p))
    return paths


def _eq(a, b, path=""):
    """Equal dicts / lists / arrays / scalars, arrays exactly."""
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _eq(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{path}/{i}")
    elif isinstance(b, np.ndarray):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _samples(shards, opener):
    return list(opener(shards))


@pytest.mark.parametrize("rank,world,epoch", [(0, 1, 0), (0, 2, 0), (1, 2, 3), (2, 3, 1)])
def test_shard_list_matches_jax(rank, world, epoch):
    items = [f"shard_{i}" for i in range(7)]
    assert pds.shard_list(items, rank, world, epoch) == jds.shard_list(items, rank, world, epoch)


def test_parquet_opener_matches_jax(shards):
    got, want = _samples(shards, pds.parquet_opener), _samples(shards, jds.parquet_opener)
    assert len(got) == 21
    _eq(got, want)


def _stage_inputs(shards, pkg):
    """The samples after the opener, tokenised and filtered, for one package."""
    ds = pds if pkg == "port" else jds
    tok = PortTokenizer() if pkg == "port" else JaxTokenizer()
    return list(ds.filter_samples(ds.tokenize(ds.parquet_opener(shards), tok)))


@pytest.fixture
def jax_natives_to_port(monkeypatch):
    monkeypatch.setattr(jax_native, "yin_f0_native", yin_f0)


STAGES = {
    "tokenize_filter": lambda ds, s, seed: s,
    "resample": lambda ds, s, seed: list(ds.resample(iter(s))),
    "truncate": lambda ds, s, seed: list(_truncate(ds, ds.resample(iter(s)), seed)),
    "compute_fbank": lambda ds, s, seed: list(ds.compute_fbank(ds.resample(iter(s)), MEL)),
    "compute_f0": lambda ds, s, seed: list(ds.compute_f0(ds.compute_fbank(
        _truncate(ds, ds.resample(iter(s)), seed), GAN_MEL))),
    "parse_embedding": lambda ds, s, seed: list(ds.parse_embedding(iter(s))),
    "shuffle": lambda ds, s, seed: list(_shuffle(ds, iter(s), 4, seed)),
    "sort_by_length": lambda ds, s, seed: list(ds.sort_by_length(
        ds.compute_fbank(ds.resample(iter(s)), MEL), 5)),
    "dynamic_batch": lambda ds, s, seed: list(ds.dynamic_batch(
        ds.compute_fbank(ds.resample(iter(s)), MEL), 400)),
    "static_batch": lambda ds, s, seed: list(ds.static_batch(iter(s), 4)),
    "padding": lambda ds, s, seed: list(ds.padding(ds.static_batch(ds.parse_embedding(
        ds.compute_fbank(ds.resample(iter(s)), MEL)), 5), pad_multiple=8)),
}


def _truncate(ds, samples, seed):
    if ds is pds:
        return pds.truncate(samples, 24480 // 2, rng=random.Random(seed))
    random.seed(seed)
    return jds.truncate(samples, 24480 // 2)


def _shuffle(ds, samples, size, seed):
    if ds is pds:
        return pds.shuffle(samples, size, rng=random.Random(seed))
    random.seed(seed)
    return jds.shuffle(samples, size)


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_each_stage_matches_jax(shards, stage, jax_natives_to_port):
    got = STAGES[stage](pds, _stage_inputs(shards, "port"), 7)
    want = STAGES[stage](jds, _stage_inputs(shards, "jax"), 7)
    assert len(want) > 0
    _eq(got, want)


def test_filter_and_resample_do_what_they_say(shards):
    s = _stage_inputs(shards, "port")
    raw = list(pds.parquet_opener(shards))
    # each shard's third row has no speech tokens; rows of 1 s or less are too short
    kept = [r["utt"] for r in raw if len(r["speech_token"]) and len(r["speech"]) > r["sample_rate"]]
    assert [x["utt"] for x in s] == kept and 0 < len(kept) < len(raw) - 3
    out = list(pds.resample(iter(s)))
    assert all(x["sample_rate"] == 24000 for x in out)
    assert max(float(np.abs(x["speech"]).max()) for x in out) <= 0.95 + 1e-6


def test_pad2_matches_jax():
    arrs = [np.arange(6, dtype=np.float32).reshape(3, 2), np.ones((5, 2), np.float32)]
    for pad_to in (None, 4, 9):
        _eq(pds._pad2(arrs, pad_to, -1.0), jds._pad2(arrs, pad_to, -1.0))


def _run(pkg, shards, seed, **kw):
    if pkg == "port":
        return list(pds.build_pipeline(shards, PortTokenizer(), kw.pop("mel"),
                                       rng=random.Random(seed), **kw))
    random.seed(seed)
    return list(jds.build_pipeline(shards, JaxTokenizer(), kw.pop("mel"), **kw))


@pytest.mark.parametrize("gan", [False, True])
@pytest.mark.parametrize("prefetch_depth", [0, 2])
def test_build_pipeline_matches_jax(shards, gan, prefetch_depth, jax_natives_to_port):
    kw = dict(rank=0, world_size=1, epoch=1, gan=gan, max_frames_in_batch=300,
              shuffle_size=6, sort_size=4, num_workers=0, prefetch_depth=prefetch_depth)
    got = _run("port", shards, 11, mel=GAN_MEL if gan else MEL, **kw)
    want = _run("jax", shards, 11, mel=GAN_MEL if gan else MEL, **kw)
    assert len(want) > 2
    _eq(got, want)
    for b in got:
        assert b["speech_feat"].shape[1] * len(b["utts"]) <= 300 or len(b["utts"]) == 1
        if gan:
            assert b["speech"].shape[1] == 24480
            assert b["pitch_feat"].shape == b["speech_feat"].shape[:2]
            assert (b["pitch_feat"] > 0).any()


def test_samples_pipeline_takes_samples_from_memory(shards):
    """The seam after the opener: samples held in memory give what the
    shards give."""
    kw = dict(max_frames_in_batch=300, shuffle_size=6, sort_size=4, num_workers=0,
              prefetch_depth=0)
    samples = list(pds.parquet_opener(pds.shard_list(shards, 0, 1, 2)))
    got = list(pds.samples_pipeline(samples, PortTokenizer(), MEL, rng=random.Random(3), **kw))
    want = list(pds.build_pipeline(shards, PortTokenizer(), MEL, epoch=2, rng=random.Random(3),
                                   **kw))
    _eq(got, want)


@pytest.mark.parametrize("dpo", [False, True])
def test_lm_batches_match_jax(shards, dpo):
    cfg_p, cfg_j = port_config.tiny_test_config(), jax_config.tiny_test_config()
    random.seed(5)
    want = list(jax_train.lm_batches(shards, JaxTokenizer(), MEL, cfg_j, 0, 1, 0,
                                     np.random.default_rng(9), 600, dpo=dpo))
    got = list(port_train.lm_batches(shards, PortTokenizer(), MEL, cfg_p, 0, 1, 0,
                                     np.random.default_rng(9), 600, dpo=dpo,
                                     shuffle_rng=random.Random(5)))
    assert len(want) > 1
    _eq(got, want)
    assert all(b["ids"].shape[1] % 64 == 0 for b in got)


@pytest.mark.parametrize("multiple", [1, 8])
def test_pad_batch_rows_matches_jax(multiple):
    rng = np.random.default_rng(0)
    batch = {"ids": rng.integers(0, 9, (5, 7)).astype(np.int32),
             "target": rng.integers(0, 9, (5, 7)).astype(np.int32),
             "lengths": np.arange(5, dtype=np.int32),
             "speech_feat": rng.standard_normal((5, 3, 2)).astype(np.float32)}
    got, want = port_mesh.pad_rows(batch, multiple), jax_train.pad_batch_rows(batch, multiple)
    _eq(got, want)
    assert next(iter(got.values())).shape[0] == (5 if multiple == 1 else 8)


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "cosy-prefetch"]


def test_prefetch_worker_ends_when_the_consumer_stops_early():
    """The JAX package's worker blocks forever on a full queue once its
    consumer stops; the port's stops, and closes the upstream chain."""
    closed = threading.Event()

    def upstream():
        try:
            for i in range(1000):
                yield i
        finally:
            closed.set()

    before = set(_prefetch_threads())
    it = pds.prefetch(upstream(), depth=2)
    assert next(it) == 0
    started = [t for t in _prefetch_threads() if t not in before]
    assert len(started) == 1
    it.close()
    started[0].join(timeout=5.0)
    assert not started[0].is_alive()
    assert closed.wait(timeout=5.0)


def test_prefetch_passes_items_and_upstream_errors():
    assert list(pds.prefetch(iter(range(7)), depth=2)) == list(range(7))

    def broken():
        yield 1
        raise KeyError("upstream")

    it = pds.prefetch(broken(), depth=2)
    assert next(it) == 1
    with pytest.raises(KeyError, match="upstream"):
        next(it)


def test_worker_map_keeps_the_input_order():
    rng = np.random.default_rng(0)
    delays = rng.uniform(0.0, 0.01, 40)

    def fn(i):
        time.sleep(delays[i])  # later items often finish first
        return i * i

    got = list(pds.worker_map(iter(range(40)), fn, num_workers=4, window=8))
    assert got == [i * i for i in range(40)]
    assert list(pds.worker_map(iter(range(5)), fn, num_workers=0)) == [0, 1, 4, 9, 16]
