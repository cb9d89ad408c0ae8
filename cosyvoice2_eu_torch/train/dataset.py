"""The training data pipeline: parquet shards -> padded host batches.

Counterpart of ``cosyvoice2_eu_tpu/train/dataset.py`` (reference:
cosy_repo/cosyvoice/dataset/dataset.py:26-151 DataList/Processor and the
stages of cosy_repo/cosyvoice/dataset/processor.py): a chain of generator
stages, shards split by rank, dynamic (frame-budget) batches padded in
length order.  Host numpy only; the trainer moves batches to the device.

``build_pipeline`` keeps the JAX package's signature: it opens the shards
(``parquet_opener``, which needs ``pyarrow``) and hands the samples to
``samples_pipeline``, which runs every later stage on any iterable of
sample dicts (a caller without ``pyarrow`` feeds it samples from memory).

Randomness comes from an explicit ``random.Random`` (the JAX package draws
from Python's global ``random``): ``truncate``'s crop starts and
``shuffle``'s orders.  ``prefetch`` stops its worker when the consumer
closes the generator, and then closes the upstream chain.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

import numpy as np


def shard_list(items: Sequence, rank: int, world_size: int, epoch: int = 0,
               shuffle: bool = True, seed: int = 0) -> List:
    """Partition shard paths by data-parallel rank (dataset.py:51-104)."""
    items = list(items)
    if shuffle:
        random.Random(seed + epoch).shuffle(items)
    return items[rank::world_size]


def parquet_opener(paths: Iterable[str], batch_rows: int = 64) -> Iterator[dict]:
    """Per-utterance dicts from parquet shards (processor.py:29).  List
    columns (waveforms, token ids, embeddings) become numpy views of one
    values buffer per record batch, through the Arrow offsets."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    for path in paths:
        with pq.ParquetFile(path) as table:
            for batch in table.iter_batches(batch_size=batch_rows):
                n = batch.num_rows
                cols = {}
                for name, col in zip(batch.schema.names, batch.columns):
                    if isinstance(col, pa.ChunkedArray):
                        col = col.combine_chunks()
                    if pa.types.is_list(col.type) or pa.types.is_large_list(col.type):
                        values = col.values.to_numpy(zero_copy_only=False)
                        offs = np.asarray(col.offsets)  # absolute into values
                        cols[name] = [values[offs[i]: offs[i + 1]] for i in range(n)]
                    else:
                        cols[name] = col.to_pylist()
                for i in range(n):
                    yield {k: v[i] for k, v in cols.items()}


def tokenize(samples: Iterator[dict], tokenizer) -> Iterator[dict]:
    for s in samples:
        s["text_token"] = np.asarray(tokenizer.encode(s["text"]), np.int32)
        yield s


def filter_samples(
    samples: Iterator[dict],
    max_length: int = 40960,
    min_length: int = 100,
    token_max_length: int = 512,
    token_min_length: int = 1,
) -> Iterator[dict]:
    """Length bounds in 10 ms frames and text tokens (processor.py:57)."""
    for s in samples:
        frames = len(s["speech"]) / s["sample_rate"] * 100
        if not (min_length < frames < max_length):
            continue
        if not (token_min_length <= len(s["text_token"]) <= token_max_length):
            continue
        if "speech_token" in s and len(s["speech_token"]) == 0:
            continue
        yield s


def resample(samples: Iterator[dict], target_sr: int = 24000) -> Iterator[dict]:
    """To ``target_sr``, then a peak above 0.95 scaled to 0.95 (processor.py:111)."""
    from cosyvoice2_eu_torch.frontend.frontend import resample as _resample

    for s in samples:
        sr = s["sample_rate"]
        if sr != target_sr:
            s["speech"] = _resample(np.asarray(s["speech"], np.float32), sr, target_sr)
            s["sample_rate"] = target_sr
        speech = np.asarray(s["speech"], np.float32)
        peak = np.abs(speech).max()
        if peak > 0.95:
            speech = speech / peak * 0.95
        s["speech"] = speech
        yield s


def truncate(samples: Iterator[dict], truncate_length: int = 24480,
             rng: Optional[random.Random] = None) -> Iterator[dict]:
    """The GAN trainer's fixed-length crops (processor.py:139): a random
    start from ``rng`` where the waveform is long enough, else zero-padded."""
    rng = rng or random.Random()
    for s in samples:
        speech = s["speech"]
        if len(speech) >= truncate_length:
            start = rng.randint(0, len(speech) - truncate_length)
            s["speech"] = speech[start: start + truncate_length]
        else:
            s["speech"] = np.pad(speech, (0, truncate_length - len(speech)))
        yield s


def compute_fbank(samples: Iterator[dict], mel_fn: Callable,
                  token_mel_ratio: int = 2) -> Iterator[dict]:
    """The 24 kHz mel, trimmed to the tokens at ``token_mel_ratio`` frames
    a token (processor.py:160)."""
    for s in samples:
        feat = mel_fn(np.asarray(s["speech"], np.float32))  # (T_mel, 80)
        if "speech_token" in s:
            token_len = min(feat.shape[0] // token_mel_ratio, len(s["speech_token"]))
            feat = feat[: token_mel_ratio * token_len]
            s["speech_token"] = np.asarray(s["speech_token"][:token_len], np.int32)
        s["speech_feat"] = feat.astype(np.float32)
        yield s


def compute_f0(samples: Iterator[dict], sample_rate: int = 24000,
               hop_size: int = 480) -> Iterator[dict]:
    """F0 targets from the native YIN (``train/pitch.py``; the reference's
    processor.py:188 uses WORLD's harvest), zero-padded or cut to the mel's
    frames."""
    from cosyvoice2_eu_torch.train.pitch import estimate_f0

    for s in samples:
        f0 = estimate_f0(np.asarray(s["speech"], np.float32), sample_rate, hop_size)
        n = s["speech_feat"].shape[0]
        if len(f0) < n:
            f0 = np.pad(f0, (0, n - len(f0)))
        s["pitch_feat"] = f0[:n].astype(np.float32)
        yield s


def parse_embedding(samples: Iterator[dict], normalize: bool = True) -> Iterator[dict]:
    for s in samples:
        for key in ("utt_embedding", "spk_embedding"):
            if key in s:
                e = np.asarray(s[key], np.float32)
                if normalize:
                    e = e / max(np.linalg.norm(e), 1e-12)
                s[key] = e
        yield s


def shuffle(samples: Iterator[dict], shuffle_size: int = 1000,
            rng: Optional[random.Random] = None) -> Iterator[dict]:
    """Shuffle in a buffer of ``shuffle_size``, yielding half of it at a time."""
    rng = rng or random.Random()
    buf: List[dict] = []
    for s in samples:
        buf.append(s)
        if len(buf) >= shuffle_size:
            rng.shuffle(buf)
            yield from buf[: shuffle_size // 2]
            buf = buf[shuffle_size // 2:]
    rng.shuffle(buf)
    yield from buf


def sort_by_length(samples: Iterator[dict], sort_size: int = 500) -> Iterator[dict]:
    buf: List[dict] = []
    for s in samples:
        buf.append(s)
        if len(buf) >= sort_size:
            buf.sort(key=lambda x: x["speech_feat"].shape[0])
            yield from buf
            buf = []
    buf.sort(key=lambda x: x["speech_feat"].shape[0])
    yield from buf


def dynamic_batch(samples: Iterator[dict],
                  max_frames_in_batch: int = 3000) -> Iterator[List[dict]]:
    """Frame-budget batching (processor.py:349): longest x rows <= the budget."""
    buf: List[dict] = []
    longest = 0
    for s in samples:
        frames = s["speech_feat"].shape[0]
        longest = max(longest, frames)
        if buf and longest * (len(buf) + 1) > max_frames_in_batch:
            yield buf
            buf = [s]
            longest = frames
        else:
            buf.append(s)
    if buf:
        yield buf


def static_batch(samples: Iterator[dict], batch_size: int) -> Iterator[List[dict]]:
    buf: List[dict] = []
    for s in samples:
        buf.append(s)
        if len(buf) == batch_size:
            yield buf
            buf = []
    if buf:
        yield buf


def _pad2(arrs: List[np.ndarray], pad_to: int | None = None, value=0.0) -> np.ndarray:
    max_len = max(a.shape[0] for a in arrs)
    if pad_to:
        max_len = max(max_len, pad_to)
    out = np.full((len(arrs), max_len) + arrs[0].shape[1:], value, arrs[0].dtype)
    for i, a in enumerate(arrs):
        out[i, : a.shape[0]] = a
    return out


def padding(batches: Iterator[List[dict]], use_spk_embedding: bool = True,
            pad_multiple: int = 1) -> Iterator[dict]:
    """Pad a list of samples into dense arrays, longest first (processor.py:360);
    ``pad_multiple`` rounds the feature and token lengths up."""
    for batch in batches:
        batch = sorted(batch, key=lambda s: s["speech_feat"].shape[0], reverse=True)

        def rnd(n):
            return -(-n // pad_multiple) * pad_multiple

        out = {
            "text_token": _pad2([s["text_token"] for s in batch]),
            "text_token_len": np.asarray([len(s["text_token"]) for s in batch], np.int32),
            "speech_feat": _pad2([s["speech_feat"] for s in batch],
                                 pad_to=rnd(batch[0]["speech_feat"].shape[0])),
            "speech_feat_len": np.asarray([s["speech_feat"].shape[0] for s in batch], np.int32),
        }
        if "speech_token" in batch[0]:
            out["speech_token"] = _pad2([s["speech_token"] for s in batch],
                                        pad_to=rnd(batch[0]["speech_token"].shape[0]))
            out["speech_token_len"] = np.asarray([len(s["speech_token"]) for s in batch],
                                                 np.int32)
        if "reject_speech_token" in batch[0]:
            # DPO pairs: the rejected continuation beside the chosen tokens
            out["reject_speech_token"] = _pad2(
                [np.asarray(s["reject_speech_token"], np.int32) for s in batch])
            out["reject_speech_token_len"] = np.asarray(
                [len(s["reject_speech_token"]) for s in batch], np.int32)
        if "pitch_feat" in batch[0]:
            out["pitch_feat"] = _pad2([s["pitch_feat"] for s in batch])
        if "speech" in batch[0]:
            out["speech"] = _pad2([np.asarray(s["speech"], np.float32) for s in batch])
        emb_key = "spk_embedding" if use_spk_embedding else "utt_embedding"
        if emb_key in batch[0]:
            out["embedding"] = np.stack([s[emb_key] for s in batch])
        if "utt" in batch[0]:
            out["utts"] = [s["utt"] for s in batch]
        yield out


_END = object()


def prefetch(samples: Iterator, depth: int = 4) -> Iterator:
    """Run the upstream chain in a background thread ("cosy-prefetch") ahead
    of the consumer, through a queue of ``depth`` items, so host
    featurisation overlaps the device's steps (the role of the reference's
    DataLoader workers, train_utils.py:59).

    When the consumer closes this generator (or drops it), the worker stops
    at its next ``put`` (it waits at most 0.1 s at a time) and closes the
    upstream chain, which releases its open files.  An upstream exception
    reaches the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in samples:
                if not put(item):
                    return
            put(_END)
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)
        finally:
            close = getattr(samples, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=worker, name="cosy-prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def worker_map(samples: Iterator[dict], fn: Callable[[dict], dict],
               num_workers: int = 0, window: int = 8) -> Iterator[dict]:
    """Ordered parallel map with at most ``window`` samples in flight.

    The featurisers (mel FFT, native YIN, resampling) release the GIL, so a
    thread pool spreads them over the host's cores; ``num_workers=0`` is the
    plain serial map."""
    if num_workers <= 0:
        for s in samples:
            yield fn(s)
        return
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending: deque = deque()
        for s in samples:
            pending.append(pool.submit(fn, s))
            if len(pending) >= window:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def _default_workers() -> int:
    import os

    return max(0, min((os.cpu_count() or 1) - 1, 8))  # one core for the training loop


def samples_pipeline(
    samples: Iterable[dict],
    tokenizer,
    mel_fn: Callable,
    gan: bool = False,
    max_frames_in_batch: int = 3000,
    use_spk_embedding: bool = True,
    shuffle_size: int = 1000,
    sort_size: int = 500,
    num_workers: int | None = None,
    prefetch_depth: int = 4,
    rng: Optional[random.Random] = None,
) -> Iterator[dict]:
    """Every stage after the opener, over sample dicts (``text``, ``speech``,
    ``sample_rate`` and, as the parquet has them, ``utt``,
    ``speech_token``, ``reject_speech_token``, ``utt_embedding``,
    ``spk_embedding``), in the reference's order (conf/cosyvoice2.yaml
    data_pipeline).  ``gan``: 24480-sample crops and F0 targets.
    ``num_workers``: the featurisers' thread pool (None: cores - 1, at most
    8); ``prefetch_depth``: batches made ahead in a thread (0: none);
    ``rng``: the crops' and shuffles' draws (None: a fresh ``random.Random``)."""
    if num_workers is None:
        num_workers = _default_workers()
    rng = rng or random.Random()
    it = filter_samples(tokenize(iter(samples), tokenizer))

    def featurize(s: dict) -> dict:
        s = next(resample(iter([s])))
        if gan:
            s = next(truncate(iter([s]), rng=rng))
        s = next(compute_fbank(iter([s]), mel_fn))
        if gan:
            s = next(compute_f0(iter([s])))
        return next(parse_embedding(iter([s])))

    it = worker_map(it, featurize, num_workers=num_workers)
    it = sort_by_length(shuffle(it, shuffle_size, rng), sort_size)
    out = padding(dynamic_batch(it, max_frames_in_batch), use_spk_embedding)
    if prefetch_depth > 0:
        out = prefetch(out, depth=prefetch_depth)
    return out


def build_pipeline(
    paths: Sequence[str],
    tokenizer,
    mel_fn: Callable,
    rank: int = 0,
    world_size: int = 1,
    epoch: int = 0,
    gan: bool = False,
    max_frames_in_batch: int = 3000,
    use_spk_embedding: bool = True,
    shuffle_size: int = 1000,
    sort_size: int = 500,
    num_workers: int | None = None,
    prefetch_depth: int = 4,
    rng: Optional[random.Random] = None,
) -> Iterator[dict]:
    """The rank's shards of ``paths`` for ``epoch`` through ``parquet_opener``
    and ``samples_pipeline``."""
    return samples_pipeline(
        parquet_opener(shard_list(paths, rank, world_size, epoch)), tokenizer, mel_fn,
        gan=gan, max_frames_in_batch=max_frames_in_batch, use_spk_embedding=use_spk_embedding,
        shuffle_size=shuffle_size, sort_size=sort_size, num_workers=num_workers,
        prefetch_depth=prefetch_depth, rng=rng)
