"""``utils/profiling.py::StageTimer`` on the CPU: each stage is a profiler
event on the trace's clock, it keeps the host's share of its time and the
caching allocator's counts, and a train step with a timer is bit-equal to
one without."""

import time

import numpy as np
import pytest
import torch

from cosyvoice2_eu_torch.config import TrainConfig, tiny_test_config
from cosyvoice2_eu_torch.models.flow import init_flow
from cosyvoice2_eu_torch.models.llm import init_lm
from cosyvoice2_eu_torch.parallel import train_step as ts
from cosyvoice2_eu_torch.train.optim import make_optimizer
from cosyvoice2_eu_torch.train.sequences import build_lm_batch
from cosyvoice2_eu_torch.utils.params import tree_leaves
from cosyvoice2_eu_torch.utils.profiling import StageTimer

CFG = tiny_test_config()
KEYS = ["total_s", "count", "mean_ms", "host_s", "mallocs", "alloc_retries"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card")
    return torch.device("cuda")


def _events(prof) -> list:
    return [e for e in prof.profiler.kineto_results.events() if e.name().startswith("stage:")]


def test_stage_is_a_cpu_event_that_is_no_user_annotation_and_nests():
    from torch.profiler import ProfilerActivity, profile

    timer = StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("outer"):
            with timer.stage("inner"):
                torch.ones(8) + 1
            time.sleep(0.01)
    ev = {e.name(): e for e in _events(prof)}
    assert set(ev) == {"stage:outer", "stage:inner"}
    for e in ev.values():
        assert not e.is_user_annotation()
        assert str(e.device_type()).endswith("CPU")
    o, i = ev["stage:outer"], ev["stage:inner"]
    assert o.start_ns() <= i.start_ns()
    assert i.start_ns() + i.duration_ns() <= o.start_ns() + o.duration_ns()
    assert o.duration_ns() >= 10_000_000


def test_host_time_ends_at_the_sync():
    nap = 0.05
    synced = StageTimer(sync=lambda: time.sleep(nap))
    plain = StageTimer()
    for timer in (synced, plain):
        for _ in range(2):
            with timer.stage("work"):
                time.sleep(0.002)
    s, p = synced.summary()["work"], plain.summary()["work"]
    assert 0 < s["host_s"] <= s["total_s"]
    assert s["total_s"] - s["host_s"] >= 2 * nap
    assert p["host_s"] == p["total_s"]


def test_summary_keeps_its_keys_and_adds_the_new_ones():
    timer = StageTimer()
    with timer.stage("flow"):
        torch.zeros(1 << 16)
    with timer.stage("flow"):
        pass
    got = timer.summary()["flow"]
    assert list(got) == KEYS
    assert got["count"] == 2
    assert got["mean_ms"] == pytest.approx(1e3 * got["total_s"] / 2)
    if not torch.cuda.is_initialized():
        assert got["mallocs"] == got["alloc_retries"] == 0
    timer.reset()
    assert timer.summary() == {}


def _flow_run(timer):
    """Two flow micro-steps of one accumulation cycle, the second emitting."""
    cfg = CFG.flow
    tc = TrainConfig(lr=1e-3, accum_grad=2)
    tx = make_optimizer(tc)
    step = ts.make_flow_train_step(cfg, tc, tx, timer)
    state = ts.init_train_state(init_flow(torch.Generator().manual_seed(3), cfg), tx)
    rng = np.random.default_rng(4)
    gen = torch.Generator().manual_seed(5)
    metrics = []
    for n, streaming in ((24, True), (18, False)):
        tl = torch.tensor([n, n - 6], dtype=torch.int32)
        batch = {"speech_token": torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, n))),
                 "speech_token_len": tl,
                 "speech_feat": torch.randn((2, 2 * n, cfg.output_size), generator=gen),
                 "speech_feat_len": 2 * tl,
                 "embedding": torch.randn((2, cfg.spk_embed_dim), generator=gen)}
        draws = ts.make_flow_draws(gen, batch, cfg.output_size)
        state, m = step(state, batch, draws, streaming=streaming)
        metrics.append(m)
    return state, metrics


def _lm_run(timer):
    """Two LM micro-steps of one accumulation cycle, the second emitting."""
    cfg = CFG.llm
    tc = TrainConfig(lr=1e-3, accum_grad=2)
    tx = make_optimizer(tc)
    step = ts.make_lm_train_step(cfg, tc, tx, timer)
    state = ts.init_train_state(init_lm(torch.Generator().manual_seed(3), cfg), tx)
    rng = np.random.default_rng(4)
    metrics = []
    for _ in range(2):
        texts = [rng.integers(2, cfg.backbone.vocab_size, k).astype(np.int32) for k in (6, 9)]
        speeches = [rng.integers(0, cfg.speech_token_size, 4 * len(x)).astype(np.int32)
                    for x in texts]
        b = build_lm_batch(texts, speeches, cfg, rng, 0.5)
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        metrics.append(m)
    return state, metrics


def _flat(state) -> list:
    return tree_leaves(state.params) + tree_leaves(
        {k: v for k, v in state.opt_state.items() if isinstance(v, dict)})


@pytest.mark.parametrize("run", [_flow_run, _lm_run], ids=["flow", "lm"])
def test_train_step_with_a_timer_is_bit_equal(run):
    timer = StageTimer(sync=lambda: None)
    a_state, a_m = run(None)
    b_state, b_m = run(timer)
    a, b = _flat(a_state), _flat(b_state)
    assert len(a) == len(b) > 0
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    scalars = {k: v for k, v in a_state.opt_state.items() if not isinstance(v, dict)}
    assert scalars == {k: v for k, v in b_state.opt_state.items() if not isinstance(v, dict)}
    assert a_state.step == b_state.step == 2
    assert [{k: v.item() for k, v in m.items()} for m in a_m] == \
        [{k: v.item() for k, v in m.items()} for m in b_m]
    got = timer.summary()
    assert {k: got[k]["count"] for k in ("forward", "backward", "optimizer")} == \
        {"forward": 2, "backward": 2, "optimizer": 2}
    assert all(0 < v["host_s"] <= v["total_s"] for v in got.values())


@pytest.mark.cuda
def test_a_new_segment_counts_as_a_malloc_on_the_card(cuda_device):
    """A tensor larger than any cached block, allocated inside a stage,
    makes the caching allocator call cudaMalloc there."""
    torch.zeros(1, device=cuda_device)
    timer = StageTimer(sync=torch.cuda.synchronize)
    reserved = torch.cuda.memory_reserved()
    with timer.stage("grow"):
        x = torch.empty(reserved // 4 + (64 << 20), dtype=torch.float32, device=cuda_device)
    with timer.stage("none"):
        pass
    got = timer.summary()
    assert got["grow"]["mallocs"] >= 1
    assert got["none"]["mallocs"] == 0
    assert got["grow"]["alloc_retries"] >= 0
    del x
