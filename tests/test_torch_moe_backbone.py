"""The speech LM on a DeepSeek-V3 backbone (``models/deepseek_v3.py``)
against the benchmark's plain reference (``benchmark/reference/moe_lm.py``)
on the CPU at a tiny size, fp32: the hidden states, the loss, each leaf's
gradient and one AdamW update through ``make_lm_step_fn``; the bias-steered
routing; the expert shares that add up to the uncut layer; the balance loss
by hand; the timer's counters and spans; the decode paths, DPO and LoRA
that raise; the trainer's epoch loop and a two-process data-parallel step;
the configuration read back.  The backbone has no JAX counterpart."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from cosyvoice2_eu_torch import config as port_config
from cosyvoice2_eu_torch.models import deepseek_v3 as ds
from cosyvoice2_eu_torch.models import llm as port_llm
from cosyvoice2_eu_torch.models.qwen2 import _attention
from cosyvoice2_eu_torch.parallel import train_step as port_ts
from cosyvoice2_eu_torch.train import executor as port_executor
from cosyvoice2_eu_torch.train import optim as port_optim
from cosyvoice2_eu_torch.train.sequences import build_lm_batch
from cosyvoice2_eu_torch.train.train import make_lm_step_fn
from cosyvoice2_eu_torch.utils.params import tree_leaves
from cosyvoice2_eu_torch.utils.profiling import StageTimer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmark"))
from reference import moe_lm  # noqa: E402
from reference import train as ref_train  # noqa: E402
from reference.config import model_config  # noqa: E402

# 1 dense + 2 MoE layers; 16 experts of 24, 4 held (from expert 4), top 3, 1 shared
BACKBONE = port_config.DeepseekV3Config(
    vocab_size=256, hidden_size=64, intermediate_size=128, moe_intermediate_size=24,
    num_layers=3, num_heads=4, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
    v_head_dim=16, n_routed_experts=16, num_experts_per_tok=3, n_shared_experts=1,
    held_experts=4, held_offset=4)
TTS = port_config.tiny_test_config()
TTS = dataclasses.replace(TTS, llm=dataclasses.replace(TTS.llm, backbone=BACKBONE))
CFG = TTS.llm
REF = model_config(json.loads(json.dumps(port_config.config_to_dict(TTS)))).llm
SEED = 3
# fp32 sums in another order than the reference's (the held experts' rows
# gathered and scatter-added, the shared expert added last, the attention
# batched by head groups): ~1e-7 of each layer's largest entry, over three
# layers; 1e-5 of the largest entry leaves 30x room and sits far below the
# 1e-3 that a wrong weight, expert or scale gives
REL = 1e-5
# each gradient leaf within 1e-4 of its largest reference entry + 1e-7 (the
# LM step's gate in test_torch_lm_train.py); the loss within 1e-6 relative
GRAD_REL, GRAD_ABS, LOSS_RTOL = 1e-4, 1e-7, 1e-6
TC = port_config.TrainConfig(lr=1e-3, accum_grad=1)
# parameters after an Adam step: its first update is lr x g / (|g| + 1e-8),
# which a gradient near 1e-8 can move by a good part of lr, so they are held
# to 5% of lr (as test_torch_lm_train.py)
PARAM_ATOL = 0.05 * TC.lr


def _weights():
    trained = moe_lm.make(REF, SEED, "cpu")
    biases = moe_lm.router_biases(REF, SEED, "cpu")
    return trained, biases, dict(trained, backbone=dict(trained["backbone"],
                                                        **{ds.FROZEN: biases}))


def _batch(seed=0, n=3):
    rng = np.random.default_rng(seed)
    texts = [rng.integers(100, 200, rng.integers(4, 8)).astype(np.int32) for _ in range(n)]
    speeches = [rng.integers(0, CFG.speech_token_size, int(rng.integers(18, 40)))
                .astype(np.int32) for _ in range(n)]
    b = build_lm_batch(texts, speeches, CFG, rng, bistream_prob=0.5)
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _close(got, want, rel=REL):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= rel * scale + 1e-12, (got - want).abs().max()


def _valid(batch):
    return torch.arange(batch["ids"].shape[1])[None] < batch["lengths"][:, None]


@pytest.mark.parametrize("seed", [0, 1])
def test_hidden_states_and_loss_match_the_reference(seed):
    """The reference is fed the program's routes (ties within rounding
    would flip otherwise) and its own s + b holds them as a top K."""
    from harness import moe

    _, biases, params = _weights()
    batch = _batch(seed)
    valid = _valid(batch)
    embeds = port_llm.embed_mixed(params, batch["ids"], batch["src"])
    hidden, aux = ds.deepseek_v3_forward(params["backbone"], BACKBONE, embeds, valid)
    want, balance, choices = moe_lm.backbone(params["backbone"], biases, REF.backbone, embeds,
                                             valid, aux["routes"])
    _close(hidden[valid], want[valid])
    assert float(aux["balance_loss"]) == pytest.approx(float(balance), rel=LOSS_RTOL)
    for routes, choice in zip(aux["routes"], choices):
        assert float(moe.route_gaps(choice, routes, valid).max()) <= 1e-6
    loss, metrics = port_ts.lm_loss_fn(params, CFG, batch, TC)
    ref = moe_lm.lm_loss(params, biases, REF, batch, aux["routes"])
    assert float(loss) == pytest.approx(float(ref), rel=LOSS_RTOL)
    assert float(metrics["balance_loss"]) > 0 and metrics["routes"].shape == aux["routes"].shape


def test_gradients_and_one_update_through_the_step_fn():
    trained, biases, params = _weights()
    batch = _batch(2)
    tx = port_optim.make_optimizer(TC)
    kept, step_fn, cv_fn = make_lm_step_fn(CFG, TC, tx, params)
    assert ds.FROZEN not in kept["backbone"]  # the biases are never trained
    state = port_ts.init_train_state(kept, tx)
    (_, metrics), grads = port_ts.value_and_grad(
        lambda p: port_ts.lm_loss_fn(dict(p, backbone=dict(p["backbone"],
                                                           **{ds.FROZEN: biases})),
                                     CFG, batch, TC),
        kept)
    routes = metrics["routes"]
    loss, ref_grads = ref_train.loss_and_grads(
        lambda p: moe_lm.lm_loss(p, biases, REF, batch, routes), trained)
    assert float(metrics["loss"]) == pytest.approx(float(loss), rel=LOSS_RTOL)
    for g, r in zip(tree_leaves(grads), tree_leaves(ref_grads)):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= GRAD_REL * float(r.abs().max()) + GRAD_ABS
    new, m = step_fn(state, batch)
    assert float(m["loss"]) == pytest.approx(float(loss), rel=LOSS_RTOL)
    want = ref_train.adam_update(trained, [ref_grads], TC)
    for p, w in zip(tree_leaves(new.params), tree_leaves(want)):
        assert float((p - w).abs().max()) <= PARAM_ATOL
    assert float(cv_fn(kept, batch)["loss"]) == pytest.approx(float(loss), rel=LOSS_RTOL)
    # the step reads the biases and leaves them as they were
    assert all(map(torch.equal, biases, moe_lm.router_biases(REF, SEED, "cpu")))


def _router_case():
    """Scores s = sigmoid(logits) of 2 tokens over 16 experts with known
    order; the gate is the identity over the first 16 features."""
    logits = torch.tensor([[3.0, 2.0, 1.0, 0.9, 0.8] + [-1.0] * 11,
                           [0.1 * i for i in range(16)]])
    x = torch.zeros(2, 64)
    x[:, :16] = logits
    gate = {"weight": torch.eye(16, 64)}
    return logits.sigmoid(), x, gate


@pytest.mark.parametrize("case", ["bias_changes_the_set", "bias_keeps_the_set"])
def test_routing_is_steered_by_the_bias_and_weighted_by_the_scores(case):
    s, x, gate = _router_case()
    k = BACKBONE.num_experts_per_tok
    bias = torch.zeros(16)
    if case == "bias_changes_the_set":
        bias[4] = 0.5  # expert 4 (5th by score on token 0) joins token 0's top 3
    else:
        bias[:] = 0.01 * torch.arange(16)  # shifts every score, reorders no top 3
    scores, idx, w = ds.route(gate, bias, x, BACKBONE)
    torch.testing.assert_close(scores, s, rtol=0, atol=0)
    assert torch.equal(idx.sort(-1).values, torch.topk(s + bias, k).indices.sort(-1).values)
    no_bias = ds.route(gate, torch.zeros(16), x, BACKBONE)[1]
    changed = not torch.equal(idx[0].sort().values, no_bias[0].sort().values)
    assert changed == (case == "bias_changes_the_set")
    # the weights are the chosen scores, normalised and scaled: the bias never enters them
    sel = s.gather(1, idx)
    torch.testing.assert_close(w, sel / sel.sum(-1, keepdim=True) * 2.446)
    if case == "bias_changes_the_set":
        assert 4 in idx[0].tolist()


@pytest.mark.parametrize("shares", [2, 4])
def test_the_expert_shares_add_up_to_the_uncut_layer(shares):
    """Each share holds 16 / shares experts; the shares' outputs, with the
    shared expert (which every share computes) counted once, add up to the
    reference's layer that holds all 16."""
    full = dataclasses.replace(BACKBONE, held_experts=16, held_offset=0)
    ref_full = model_config(json.loads(json.dumps(port_config.config_to_dict(
        dataclasses.replace(TTS, llm=dataclasses.replace(CFG, backbone=full)))))).llm
    specs = moe_lm.lm_specs(ref_full)["backbone"]["layers"][1]["mlp"]
    from reference import weights

    mp = weights.make(specs, 5, "cpu")
    bias = weights.make([weights.Spec("u", (16,), 0.05)], 5, "cpu", stream=1)[0]
    h = torch.randn(2, 7, 64, generator=torch.Generator().manual_seed(0))
    valid = torch.ones(2, 7, dtype=torch.bool)
    want, _, _ = moe_lm._moe(mp, bias, ref_full.backbone, h, valid, None)
    n = 16 // shares
    total = -(shares - 1) * ds.shared_experts(mp["shared_experts"], h)
    pairs = 0
    for r in range(shares):
        cfg = dataclasses.replace(BACKBONE, held_experts=n, held_offset=r * n)
        part = dict(mp, experts={k: v[r * n:(r + 1) * n] for k, v in mp["experts"].items()})
        aux = {"balance_loss": torch.zeros(()), "routes": [], "held_pairs": 0}
        total = total + ds._moe(part, bias, cfg, h, valid, aux, None)
        pairs += aux["held_pairs"]
    _close(total, want)
    assert pairs == 2 * 7 * BACKBONE.num_experts_per_tok  # each (token, slot) pair held once


def test_the_balance_loss_by_hand():
    cfg = dataclasses.replace(BACKBONE, n_routed_experts=4, num_experts_per_tok=2,
                              aux_loss_alpha=0.5)
    s = torch.tensor([[[0.9, 0.1, 0.5, 0.3], [0.2, 0.8, 0.7, 0.1], [0.4, 0.4, 0.4, 0.4]]])
    idx = torch.tensor([[[0, 2], [1, 2], [3, 0]]])
    valid = torch.tensor([[True, True, False]])  # the third position is padding
    # f_i = N/(K T) x times chosen over the 2 valid positions: 4/4 x (1, 1, 2, 0)
    f = [1.0, 1.0, 2.0, 0.0]
    # P_i = mean over the valid positions of s_i / sum_j s_j
    p = [(0.9 / 1.8 + 0.2 / 1.8) / 2, (0.1 / 1.8 + 0.8 / 1.8) / 2, (0.5 / 1.8 + 0.7 / 1.8) / 2,
         (0.3 / 1.8 + 0.1 / 1.8) / 2]
    want = 0.5 * sum(a * b for a, b in zip(f, p))
    assert float(ds.balance_loss(s, idx, valid, cfg)) == pytest.approx(want, rel=1e-6)
    # two rows: the mean over rows
    s2, idx2 = torch.cat([s, s]), torch.cat([idx, idx])
    valid2 = torch.tensor([[True, True, False], [True, True, True]])
    rows = [float(ds.balance_loss(s2[i:i + 1], idx2[i:i + 1], valid2[i:i + 1], cfg))
            for i in range(2)]
    assert float(ds.balance_loss(s2, idx2, valid2, cfg)) == pytest.approx(np.mean(rows))


def test_counters_and_spans_against_the_reference():
    """The timer counts the valid tokens routed to each expert (as the
    reference routes them), to each held one and the dispatches; its MoE
    forward stage opens once a layer, and the loss is bit-equal with and
    without the timer."""
    _, biases, params = _weights()
    batch = _batch(4)
    valid = _valid(batch)
    timer = StageTimer()
    loss, metrics = port_ts.lm_loss_fn(params, CFG, batch, TC, timer)
    embeds = port_llm.embed_mixed(params, batch["ids"], batch["src"])
    _, _, choices = moe_lm.backbone(params["backbone"], biases, REF.backbone, embeds, valid)
    counts = torch.zeros(16)
    for choice in choices:
        counts += torch.zeros(16).index_add_(
            0, torch.topk(choice, 3).indices[valid].reshape(-1), torch.ones(int(valid.sum()) * 3))
    got = timer.counters()
    assert got["moe.tokens_routed"] == counts.tolist()
    assert got["moe.tokens_held"] == counts[4:8].tolist()
    assert got["moe.dispatch.calls"] == 2
    sizes = counts[4:8]
    assert sum(sizes) > 0 and got["moe.load_max_over_mean"] >= 1.0
    assert timer.summary()["moe"]["count"] == 2
    plain, untimed = port_ts.lm_loss_fn(params, CFG, batch, TC)
    assert torch.equal(plain, loss)
    # the held pairs come back with or without a timer
    assert metrics["held_pairs"] == untimed["held_pairs"] == int(sizes.sum())


def test_the_backward_span_opens_and_closes_once_a_layer():
    _, biases, params = _weights()
    batch = _batch(5)
    tx = port_optim.make_optimizer(TC)
    timer = StageTimer()
    kept, step_fn, _ = make_lm_step_fn(CFG, TC, tx, params, timer=timer)
    _, m = step_fn(port_ts.init_train_state(kept, tx), batch)
    stages = timer.summary()
    assert stages["moe"]["count"] == stages["moe_backward"]["count"] == 2
    assert stages["moe_backward"]["total_s"] <= stages["backward"]["total_s"]
    plain_fn = make_lm_step_fn(CFG, TC, tx, params)[1]
    _, plain = plain_fn(port_ts.init_train_state(kept, tx), batch)
    assert torch.equal(plain["loss"], m["loss"]) and torch.equal(plain["routes"], m["routes"])


@pytest.mark.parametrize("path", ["lm_prefill", "bs_init", "bs_extend", "slots_init",
                                  "prefill_row"])
def test_decode_paths_raise_for_the_moe_backbone(path):
    _, _, params = _weights()
    ids = torch.zeros((1, 4), dtype=torch.long)
    call = {"lm_prefill": lambda: port_llm.lm_prefill(params, CFG, ids, ids,
                                                      torch.tensor([4]), 8),
            "bs_init": lambda: port_llm.bs_init(params, CFG, 32),
            "bs_extend": lambda: port_llm.bs_extend(params, CFG, None, ids, ids, 4),
            "slots_init": lambda: port_llm.slots_init(CFG, 2, 32, 8),
            "prefill_row": lambda: port_llm.prefill_row(params, CFG, ids, ids, 4, 32)}[path]
    with pytest.raises(ValueError, match="MLA latent cache"):
        call()


@pytest.mark.parametrize("branch", ["dpo", "lora"])
def test_dpo_and_lora_raise_for_the_moe_backbone(branch):
    _, _, params = _weights()
    tx = port_optim.make_optimizer(TC)
    with pytest.raises(ValueError, match="plain LM step only"):
        make_lm_step_fn(CFG, TC, tx, params, gen=torch.Generator().manual_seed(0),
                        **{branch: True})


def test_the_trainer_logs_each_step(tmp_path):
    """The trainer's epoch loop over the MoE step, logging every step: the
    logged metrics are numbers (the routes stay out), the held pairs among
    them; the epoch's checkpoint holds the trained tree."""
    _, _, params = _weights()
    tc = dataclasses.replace(TC, log_interval=1, save_per_step=0)
    tx = port_optim.make_optimizer(tc)
    kept, step_fn, cv_fn = make_lm_step_fn(CFG, tc, tx, params)
    logged = []
    ex = port_executor.Executor(tc, step_fn, cv_fn, model_dir=str(tmp_path),
                                log_fn=logged.append)
    batches = [_batch(10 + i) for i in range(3)]
    state = ex.train_epoch(port_ts.init_train_state(kept, tx), batches, cv_batches=batches[:1])
    assert state.step == 3 and [m["step"] for m in logged] == [1, 2, 3]
    for m in logged:
        assert "routes" not in m and all(isinstance(v, (int, float)) for v in m.values())
        assert m["balance_loss"] > 0 and m["held_pairs"] > 0
        assert m["loss"] == pytest.approx(m["ce"] + m["balance_loss"], rel=1e-6)
    saved = torch.load(tmp_path / "epoch_0_whole", weights_only=False)
    assert [x.shape for x in tree_leaves(saved)] == [x.shape for x in tree_leaves(kept)]


def test_a_data_parallel_step_is_the_one_process_step(tmp_path):
    """Two processes over gloo, 3 rows split 2 / 1: the reduced metrics and
    the updated parameters are the one-process step's on the whole batch
    (the CE weighted by tokens, the balance loss by rows); each process
    keeps its own rows' routes and held pairs, which add up to the whole
    batch's."""
    import torch_dist_workers as W

    _, _, params = _weights()
    batch = _batch(6)
    tx = port_optim.make_optimizer(TC)
    kept, step_fn, _ = make_lm_step_fn(CFG, TC, tx, params)
    state, want = step_fn(port_ts.init_train_state(kept, tx), batch)
    ranks = W.run_group(W.dp_moe_lm, 2, tmp_path, lm_cfg=CFG, train_cfg=TC, params=params,
                        batch=batch)
    assert [r["rows"] for r in ranks] == [2, 1]
    assert torch.equal(torch.cat([r["routes"] for r in ranks], dim=1), want["routes"])
    assert sum(r["held_pairs"] for r in ranks) == want["held_pairs"]
    for r in ranks:
        assert set(r["metrics"]) == set(want) - {"routes", "held_pairs"}
        for k, v in r["metrics"].items():
            # fp32 sums of two processes' shares against one sum
            assert v == pytest.approx(float(want[k]), rel=LOSS_RTOL, abs=1e-7), k
        for p, w in zip(tree_leaves(r["params"]), tree_leaves(state.params)):
            assert float((torch.as_tensor(p) - w).abs().max()) <= PARAM_ATOL


def test_the_benchmark_configuration_reads_back():
    with open(os.path.join(REPO, "benchmark", "configs",
                           "cosyvoice2-moonlight-16b-a3b.json")) as f:
        model = json.load(f)["model"]
    cfg = port_config.config_from_dict(port_config.TTSConfig, model)
    bb = cfg.llm.backbone
    assert isinstance(bb, port_config.DeepseekV3Config)
    assert (bb.num_layers, bb.held_experts, bb.n_routed_experts, bb.hidden_size) == (9, 8, 64, 2048)
    assert port_config.config_to_dict(cfg) == json.loads(json.dumps(model))
    # the default configs keep their Qwen2 backbones
    assert type(port_config.TTSConfig().llm.backbone) is port_config.Qwen2Config
    qwen = port_config.config_to_dict(port_config.tiny_test_config())
    assert port_config.config_from_dict(port_config.TTSConfig, qwen) == \
        port_config.tiny_test_config()


def test_the_init_tree_is_the_reference_layout():
    gen = torch.Generator().manual_seed(0)
    port = port_llm.init_lm(gen, CFG)
    kept, thaw = port_llm.split_frozen(port)
    frozen = port["backbone"][ds.FROZEN]
    shapes = lambda tree: [tuple(x.shape) for x in tree_leaves(tree)]  # noqa: E731
    assert shapes(kept) == shapes(moe_lm.make(REF, 0, "cpu"))
    assert shapes(frozen) == shapes(moe_lm.router_biases(REF, 0, "cpu"))
    assert all(float(b.abs().max()) <= ds.BIAS_BOUND for b in frozen)
    assert ds.FROZEN not in kept["backbone"] and thaw(kept)["backbone"][ds.FROZEN] is frozen
    # a Qwen tree has no frozen buffers and comes back as it is
    qwen = port_llm.init_lm(gen, port_config.tiny_test_config().llm)
    kept, thaw = port_llm.split_frozen(qwen)
    assert kept is qwen and thaw(qwen) is qwen


def test_attention_takes_a_value_width_of_its_own():
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(2, 4, 5, 12, generator=g), torch.randn(2, 2, 5, 12, generator=g)
    v = torch.randn(2, 2, 5, 7, generator=g)
    bias = torch.zeros(2, 1, 5, 5)
    out = _attention(q, k, v, bias, 2)
    probs = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(2, 1))
                          / 12 ** 0.5, -1)
    torch.testing.assert_close(out, probs @ v.repeat_interleave(2, 1))
