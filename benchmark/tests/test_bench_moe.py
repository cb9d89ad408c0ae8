"""The MoE training cell (``ml.lm_moe_train``) on the CPU at a tiny size:
its whole run through ``run.execute``, each planted fault read as not
correct, its model FLOPs against the meta device's count, the route check
and its readers."""

from __future__ import annotations

import json
import os
import time
from types import SimpleNamespace

import pytest
import torch

import run as bench_run
from conftest import make_tiny_root
from harness import flops, moe, registry
from reference import moe_lm
from reference.config import model_config
from reference.layers import tree_map

CELL = "tiny.lm_moe_train"
# the tiny LM of the port's tests on a deepseek_v3 backbone: 1 dense + 2 MoE
# layers, 16 experts of 24 (4 held, from expert 4), top 3, 1 shared
TINY_BACKBONE = {"model_type": "deepseek_v3", "vocab_size": 256, "hidden_size": 64,
                 "intermediate_size": 128, "moe_intermediate_size": 24, "num_layers": 3,
                 "first_k_dense_replace": 1, "num_heads": 4, "kv_lora_rank": 32,
                 "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
                 "n_routed_experts": 16, "num_experts_per_tok": 3, "n_shared_experts": 1,
                 "routed_scaling_factor": 2.446, "aux_loss_alpha": 1e-4, "held_experts": 4,
                 "held_offset": 4, "rms_norm_eps": 1e-5, "rope_theta": 50000.0,
                 "max_position_embeddings": 8192}
LM_METRICS = ("fwd_bwd_ms_per_step", "fwd_bwd_host_ms_per_step", "optimizer_ms_per_step",
              "optimizer_host_ms_per_step", "allocator_mallocs_per_step", "mfu",
              "device_idle_pct")
NEW = ("moe_ms_per_step.lm_moe_train", "moe_host_ms_per_step.lm_moe_train",
       "expert_load_max_over_mean.lm_moe_train")


@pytest.fixture(scope="module")
def moe_root(tmp_path_factory):
    """The tiny benchmark root with the cell ``tiny.lm_moe_train``: the tiny
    configuration on ``TINY_BACKBONE`` under a small copy of the MoE mix,
    with the metrics that ``BENCHMARK.json`` gives ``ml.lm_moe_train``."""
    root = make_tiny_root(str(tmp_path_factory.mktemp("moe")))
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny-moe"
    cfg["model"]["llm"]["backbone"] = TINY_BACKBONE
    with open(os.path.join(bench, "configs", "tiny-moe.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "lm_moe_train.json")) as f:
        t = json.load(f)
    t.update(utterances=24, speech_tokens=[20, 80], cap_padded_tokens=200)
    with open(os.path.join(bench, "traffic", "tiny_lm_moe_train.json"), "w") as f:
        json.dump(t, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny-moe", "source": "tests",
                            "file": "benchmark/configs/tiny-moe.json", "reduced": [],
                            "why": "tests"})
    spec["workloads"].append({"name": CELL, "config": "tiny-moe", "traffic": "tiny_lm_moe_train",
                              "chips": 1, "why": "tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] == "lm_train_tokens_per_s" or m["name"] in {n + ".lm_train"
                                                                   for n in LM_METRICS}:
            m["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=1)
    return root


def _run(root, trace=False, seed=2**31 + 11):
    c = registry.Cell(CELL, root=root)
    line, checks = bench_run.execute(c, seed, 0.5, trace, time.perf_counter(), device="cpu")
    return json.loads(line), checks


@pytest.mark.parametrize("trace", [False, True])
def test_run_is_correct_and_reports_its_metrics(moe_root, trace):
    res, checks = _run(moe_root, trace)
    assert res["correct"] is True, checks
    assert res["checks"]["route_flips"] == {"value": 0, "limit": 0}
    assert res["failed"] == 0 and res["attempted"] > 0
    c = registry.Cell(CELL, root=moe_root)
    got = set(res["metrics"])
    if not trace:
        assert got == {m["name"] for m in c.end_to_end()} == {"lm_train_tokens_per_s", "setup_s"}
    else:  # on the CPU nothing reads the device trace's kernels
        assert set(NEW) | {n + ".lm_train" for n in LM_METRICS} - {
            "device_idle_pct.lm_train"} <= got <= {m["name"] for m in c.per_layer()}
        assert res["metrics"]["expert_load_max_over_mean.lm_moe_train"]["value"] >= 1.0
        assert 0 < res["metrics"]["mfu.lm_train"]["value"]


@pytest.mark.parametrize("fault", sorted(moe.FAULTS))
def test_broken_timed_path_is_not_correct(moe_root, fault):
    restore = moe.plant(fault)
    try:
        res, checks = _run(moe_root)
    finally:
        restore()
    assert res["correct"] is False, checks


def test_the_bias_fault_shows_as_route_flips(moe_root):
    restore = moe.plant("bias_dropped")
    try:
        res, _ = _run(moe_root)
    finally:
        restore()
    assert res["checks"]["route_flips"]["value"] > 0


def _tiny_lm():
    return model_config(json.loads(json.dumps({
        "llm": {"backbone": TINY_BACKBONE, "speech_token_size": 81, "lsm_weight": 0.0,
                "length_normalized_loss": True}, "hift": {"istft_hop_len": 4,
                                                          "upsample_rates": [1]}}))).llm


@pytest.mark.parametrize("t", [5, 12])
def test_forward_flops_match_the_meta_count(t):
    """The count of ``harness/moe.py`` at full attention (every position
    sees all ``t``) and every held expert on every position, as the
    reference computes it, against ``torch.utils.flop_counter``."""
    c = _tiny_lm()
    meta = tree_map(lambda s: torch.empty(s.shape, device="meta"), moe_lm.lm_specs(c))
    biases = [torch.zeros(16, device="meta") for _ in range(2)]
    ids = torch.zeros((1, t), dtype=torch.long, device="meta")
    valid = torch.ones((1, t), dtype=torch.bool, device="meta")
    got = flops.meta_flops(lambda: moe_lm.forward(meta, biases, c, ids, ids, valid))
    assert got == moe.forward_flops(c, [t] * t, held_pairs=t * 4 * 2)


def test_forward_flops_by_hand():
    c = _tiny_lm()
    mla = 64 * 4 * 24 + 64 * 40 + 32 * 4 * 32 + 4 * 16 * 64
    per_token = 3 * mla + 3 * 64 * 128 + 2 * (64 * 16 + 3 * 64 * 24)
    assert moe.token_params(c.backbone) == per_token
    attn = 2 * 3 * 4 * (24 + 16)
    assert moe.forward_flops(c, [1, 2], 5) == (2 * 2 * (per_token + 64 * 84) + attn * 3
                                              + 5 * 6 * 64 * 24)


def test_route_gaps_by_hand():
    choice = torch.tensor([[[0.9, 0.5, 0.5 - 1e-7, 0.1], [0.2, 0.8, 0.6, 0.7]]],
                          dtype=torch.float64)
    routes = torch.tensor([[[0, 2], [1, 2]]])
    valid = torch.tensor([[True, True]])
    gaps = moe.route_gaps(choice, routes, valid)
    # row 0: 0.5 left out over 0.5 - 1e-7 chosen (a tie within rounding);
    # row 1: 0.7 left out over 0.6 chosen (a flip)
    assert gaps.tolist() == pytest.approx([1e-7, 0.1], abs=1e-8)
    assert moe.route_gaps(choice, routes, torch.tensor([[True, False]])).numel() == 1


def _reader(name):
    return registry.load_module(os.path.join(registry.BENCH_DIR, "metrics", name + ".py"), name)


def _stage(total, count, host):
    return {"total_s": total, "count": count, "mean_ms": 1e3 * total / count, "host_s": host}


def test_readers_read_the_timer_and_the_counters():
    timer = {"forward": _stage(2.0, 4, 1.0), "backward": _stage(3.0, 4, 1.5),
             "moe": _stage(0.8, 8, 0.5), "moe_backward": _stage(1.2, 8, 0.3)}
    ctx = {"timer": timer, "counters": {"moe.dispatch.calls": 8, "moe.load_max_over_mean": 12.0}}
    assert _reader(NEW[0]).read(ctx) == pytest.approx(1e3 * 2.0 / 4)
    assert _reader(NEW[1]).read(ctx) == pytest.approx(1e3 * 0.8 / 4)
    assert _reader(NEW[2]).read(ctx) == pytest.approx(1.5)
    # a step without the MoE's stages and counters (a dense backbone's)
    dense = {"timer": {k: timer[k] for k in ("forward", "backward")}, "counters": {}}
    for name in NEW:
        assert _reader(name).read(dense) is None
        assert _reader(name).read({}) is None


def test_new_entries_name_the_cell():
    spec = json.load(open(os.path.join(registry.ROOT, "BENCHMARK.json")))
    cell = registry.Cell("ml.lm_moe_train")
    assert cell.chips == 1 and cell.traffic["driver"] == "lm_moe_train"
    assert [m["name"] for m in cell.end_to_end()] == ["lm_train_tokens_per_s", "setup_s"]
    names = {m["name"] for m in cell.per_layer()}
    assert names == set(NEW) | {n + ".lm_train" for n in LM_METRICS}
    for m in spec["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == ["ml.lm_moe_train"] and m["layer"] == "MoE block"
            assert m["moves"] == "lm_train_tokens_per_s"
    entry = [c for c in spec["configs"] if c["name"] == cell.workload["config"]][0]
    assert entry["reduced"] == ["num_hidden_layers", "n_routed_experts"]
    cfg = cell.config
    assert (cfg["num_hidden_layers"], cfg["n_routed_experts"]) == (9, 8)
    bb = cfg["model"]["llm"]["backbone"]
    assert (bb["num_layers"], bb["held_experts"], bb["n_routed_experts"]) == (9, 8, 64)


def test_the_port_reads_the_configuration():
    from cosyvoice2_eu_torch.config import (
        DeepseekV3Config,
        TTSConfig,
        config_from_dict,
        config_to_dict,
    )

    model = registry.Cell("ml.lm_moe_train").config["model"]
    cfg = config_from_dict(TTSConfig, model)
    assert isinstance(cfg.llm.backbone, DeepseekV3Config)
    assert config_to_dict(cfg) == json.loads(json.dumps(model))
    assert SimpleNamespace(**config_to_dict(cfg.llm.backbone)) == model_config(model).llm.backbone
