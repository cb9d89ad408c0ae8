"""Process groups for the port's multi-process tests, on the CPU over gloo.

``run_group(fn, world, tmp_path, **kw)`` spawns ``world`` processes, each
joining a gloo group through a rendezvous file under ``tmp_path`` (so test
workers never collide on a port) and calling ``fn(rank, world, **kw)``; it
returns every rank's result.  A rank that raises, or a group that is not
done within ``timeout`` seconds, fails the calling test (the processes are
killed).  The workers import torch and the port only: the JAX side of a
comparison runs in the calling test.
"""

from __future__ import annotations

import os
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

import cosyvoice2_eu_torch.utils.params as P


def _entry(fn, rank, world, init_file, out_file, kw):
    import torch.distributed as dist

    torch.set_num_threads(2)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=world)
        try:
            out = fn(rank, world, **kw)
        finally:
            dist.destroy_process_group()
        torch.save({"ok": out}, out_file)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out_file)
        raise


def run_group(fn, world: int, tmp_path, timeout: float = 240.0, **kw) -> list:
    ctx = mp.get_context("spawn")
    d = os.path.join(str(tmp_path), f"group_{fn.__name__}")
    os.makedirs(d, exist_ok=True)
    init = os.path.join(d, "rendezvous")
    outs = [os.path.join(d, f"rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=_entry, args=(fn, r, world, init, outs[r], kw), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    import time

    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    if hung:
        raise AssertionError(f"ranks {hung} of {fn.__name__} did not finish in {timeout} s")
    results = []
    for r, path in enumerate(outs):
        if not os.path.exists(path):
            raise AssertionError(f"rank {r} of {fn.__name__} exited {procs[r].exitcode} "
                                 "without a result")
        res = torch.load(path, weights_only=False)
        if "error" in res:
            raise AssertionError(f"rank {r} of {fn.__name__} failed:\n{res['error']}")
        results.append(res["ok"])
    return results


def _np(tree):
    return P.tree_map(lambda x: x.detach().cpu().numpy() if torch.is_tensor(x) else x, tree)


def _t(tree):
    return P.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


# ---------------------------------------------------------------------------
# data parallelism: the flow step, the host guards, a GAN turn
# ---------------------------------------------------------------------------

def dp_flow_and_guards(rank, world, flow_cfg, params, batch, draws, train_cfg,
                       gan_cfg=None, gan=None):
    from cosyvoice2_eu_torch.parallel import distributed as D
    from cosyvoice2_eu_torch.parallel import train_step as ts
    from cosyvoice2_eu_torch.parallel.mesh import make_mesh, shard_batch, shard_rows
    from cosyvoice2_eu_torch.train.optim import make_optimizer

    mesh = make_mesh(dp=world)
    out = {"coords": mesh.coords, "shape": mesh.shape}
    mine, my_draws = shard_batch(_t(batch), mesh), shard_rows(_t(draws), mesh)
    tx = make_optimizer(train_cfg, mesh)
    state, metrics = ts.make_flow_train_step(flow_cfg, train_cfg, tx, mesh=mesh)(
        ts.init_train_state(_t(params), tx), mine, my_draws, streaming=False)
    out["metrics"] = _np(metrics)
    out["params"] = _np(state.params)
    out["mu"] = _np(state.opt_state["mu"])
    # this process's own mean, which DDP would average
    out["local_loss"] = float(ts.flow_loss_fn(_t(params), flow_cfg, mine, my_draws, False)[0])

    # the host guards: 3 and 2 batches stop together after 2
    n = 3 if rank == 0 else 2
    out["joined"] = list(D.join_uneven_inputs(iter(range(n)), tag="t"))
    tree = {"w": torch.full((3,), float(rank)), "n": rank, "s": f"rank{rank}"}
    got = D.broadcast_from_host0(tree)
    out["broadcast"] = (got["w"].tolist(), got["n"], got["s"])
    D.host_barrier("end")
    out["agree"] = (D._all_hosts_agree_continue(True), D._all_hosts_agree_continue(rank == 0))

    if gan is not None:
        from cosyvoice2_eu_torch.train.train_gan import GAN_TRAIN_CONFIG, make_gan_steps

        tx_g = make_optimizer(GAN_TRAIN_CONFIG)
        gen_step, disc_step = make_gan_steps(gan_cfg, tx_g, tx_g, mesh)
        g, d = _t(gan["gen"]), _t(gan["disc"])
        b, dr = shard_rows(_t(gan["batch"]), mesh), shard_rows(_t(gan["draws"]), mesh)
        d2, opt_d, m_d = disc_step(d, tx_g.init(d), g, b, dr)
        g2, opt_g, m_g = gen_step(g, tx_g.init(g), d2, b, dr)
        out["gan"] = {"disc": (_np(d2), _np(opt_d["mu"]), _np(m_d)),
                      "gen": (_np(g2), _np(opt_g["mu"]), _np(m_g))}
    return out


# ---------------------------------------------------------------------------
# sharded optimizer state: the LM step, DPO, accumulation
# ---------------------------------------------------------------------------

def fsdp_lm(rank, world, lm_cfg, params, batch, dpo_batch, ref_params, train_cfg,
            accum_cfg, accum_batches):
    from cosyvoice2_eu_torch.ops import optim_passes as passes
    from cosyvoice2_eu_torch.parallel import train_step as ts
    from cosyvoice2_eu_torch.parallel.mesh import make_mesh, shard_batch, shard_rows
    from cosyvoice2_eu_torch.train.dpo import make_dpo_train_step
    from cosyvoice2_eu_torch.train.optim import make_optimizer

    mesh = make_mesh(dp=1, fsdp=world)
    out = {"coords": mesh.coords}
    tx = make_optimizer(train_cfg, mesh)
    state = ts.init_train_state(_t(params), tx)
    out["mu_shapes"] = [tuple(x.shape) for x in P.tree_leaves(state.opt_state["mu"])]
    state, m = ts.make_lm_train_step(lm_cfg, train_cfg, tx, mesh=mesh)(
        state, shard_batch(_t(batch), mesh))
    out["lm"] = {"metrics": _np(m), "params": _np(state.params),
                 "mu": _np(tx.gather_state(state.opt_state, state.params)["mu"])}

    # DPO: a CE over tokens plus a mean over rows, 3 rows split 2 / 1 and
    # not padded, as the trainer gives each process its own rows; at
    # (dp=1, fsdp=2), then at (dp=2, fsdp=1)
    for name, m_dpo in (("dpo", mesh), ("dpo_dp2", make_mesh(dp=world))):
        tx_dpo = make_optimizer(train_cfg, m_dpo)
        state = ts.init_train_state(_t(params), tx_dpo)
        state, m = make_dpo_train_step(lm_cfg, train_cfg, tx_dpo, _t(ref_params), beta=0.1,
                                       mesh=m_dpo)(state, shard_rows(_t(dpo_batch), m_dpo))
        out[name] = {"metrics": _np(m), "params": _np(state.params),
                     "mu": _np(tx_dpo.gather_state(state.opt_state, state.params)["mu"])}

    # accumulation over 2 micro-steps, 3 steps
    tx2 = make_optimizer(accum_cfg, mesh)
    state = ts.init_train_state(_t(params), tx2)
    step = ts.make_lm_train_step(lm_cfg, accum_cfg, tx2, mesh=mesh)
    losses, adopted = [], passes.adopt.calls
    for b in accum_batches:
        state, m = step(state, shard_batch(_t(b), mesh))
        losses.append(float(m["loss"]))
    full = tx2.gather_state(state.opt_state, state.params)
    out["accum"] = {"losses": losses, "params": _np(state.params), "mu": _np(full["mu"]),
                    "acc_grads": _np(full["acc_grads"]), "mini_step": full["mini_step"],
                    "adoptions": passes.adopt.calls - adopted,
                    # the storages under each sharded tree: one flat buffer each
                    "storages": {k: len({x.untyped_storage().data_ptr()
                                         for x in P.tree_leaves(state.opt_state[k])})
                                 for k in ("mu", "nu", "acc_grads")}}
    return out


def dp_moe_lm(rank, world, lm_cfg, train_cfg, params, batch):
    """The plain LM step on a MoE backbone at dp=``world``, this process's
    rows of ``batch`` (split unevenly): the reduced metrics, this process's
    routes and held pairs, its rows, the updated parameters."""
    from cosyvoice2_eu_torch.parallel import train_step as ts
    from cosyvoice2_eu_torch.parallel.mesh import make_mesh, shard_rows
    from cosyvoice2_eu_torch.train.optim import make_optimizer
    from cosyvoice2_eu_torch.train.train import make_lm_step_fn

    mesh = make_mesh(dp=world)
    tx = make_optimizer(train_cfg, mesh)
    kept, step_fn, _ = make_lm_step_fn(lm_cfg, train_cfg, tx, params, mesh=mesh)
    rows = shard_rows(batch, mesh)
    state, m = step_fn(ts.init_train_state(kept, tx), rows)
    own = ("routes", "held_pairs")
    return {"metrics": {k: float(v) for k, v in m.items() if k not in own},
            "routes": m["routes"], "held_pairs": m["held_pairs"],
            "rows": int(rows["ids"].shape[0]), "params": _np(state.params)}


# ---------------------------------------------------------------------------
# the trainer: train.run --fsdp 2
# ---------------------------------------------------------------------------

def _samples(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(26400, 45600))
        tt = np.arange(k) / 24000
        wav = 0.3 * np.sin(2 * np.pi * rng.uniform(110, 240) * tt) + rng.standard_normal(k) * 0.02
        out.append({"utt": f"u{seed}_{i}", "text": "bonjour le monde",
                    "speech": wav.astype(np.float32), "sample_rate": 24000,
                    "speech_token": rng.integers(0, 81, k // 960).astype(np.int32),
                    "utt_embedding": rng.standard_normal(192).astype(np.float32),
                    "spk_embedding": rng.standard_normal(192).astype(np.float32)})
    return out


def trainer_fsdp(rank, world, config_path, model_dir, world1_dir):
    from cosyvoice2_eu_torch.parallel.train_step import init_train_state
    from cosyvoice2_eu_torch.train import executor as E
    from cosyvoice2_eu_torch.train import train as T

    samples = _samples(100 + rank, 3)  # this process's shard
    args = T.parse_args(["--model", "flow", "--train_data", "x", "--cv_data", "x",
                         "--config", config_path, "--max_epoch", "1",
                         "--max_frames_in_batch", "150", "--seed", "3", "--device", "cpu",
                         "--model_dir", model_dir, "--fsdp", str(world)])
    res = T.run(args, lambda path, epoch: iter(samples))
    state = res["state"]
    out = {"steps": res["executor"].step, "params": _np(state.params),
           "loss": float(res["metrics"]["loss"])}
    # a checkpoint written by one process restores here as this process's slices
    tx = res["executor"].tx
    info = E.latest_checkpoint(world1_dir)
    restored = E.restore_train_state(world1_dir, info, init_train_state(state.params, tx), tx)
    out["restored_mu"] = _np(restored.opt_state["mu"])
    return out


# ---------------------------------------------------------------------------
# tensor-parallel decode
# ---------------------------------------------------------------------------

def _draws(nuc, full):
    return lambda step: (torch.tensor(nuc[step]), torch.tensor(full[step]))


def tp_decode(rank, world, lm_cfg, params, prompt, draws):
    from cosyvoice2_eu_torch.models import llm
    from cosyvoice2_eu_torch.parallel.tp import make_tp_mesh, shard_lm_tp
    from cosyvoice2_eu_torch.utils.params import quantize_lm_params

    ids, src, plen, min_len, max_len, max_gen = prompt
    args = [torch.tensor(a).long() for a in (ids, src, plen, min_len, max_len)]
    mesh = make_tp_mesh(world)
    out = {}
    for name, tree in (("fp32", _t(params)), ("int8", quantize_lm_params(_t(params)))):
        local = shard_lm_tp(tree, mesh, lm_cfg)
        layer = local["backbone"]["layers"][0]
        key = "weight" if name == "fp32" else "weight_q"
        out[f"{name}_shapes"] = {k: tuple(layer[k][key].shape) for k in layer if k.endswith("_proj")}
        out[f"{name}_head"] = tuple(local["llm_decoder"][key].shape)
        st = llm.lm_prefill(local, lm_cfg, args[0], args[1], args[2], max_gen)
        out[f"{name}_hidden"] = st.last_hidden.numpy()
        out[f"{name}_kv_heads"] = st.kv.k.shape[2]
        toks, lens, _ = llm.lm_decode(local, lm_cfg, *args, max_gen, draws=_draws(*draws))
        out[f"{name}_tokens"] = (toks.numpy(), lens.numpy())
    # the slices through a tree map (a cast, a copy) keep their group
    recast = P.tree_map(lambda t: t.clone(), P.cast_floating(shard_lm_tp(_t(params), mesh, lm_cfg),
                                                             torch.float32))
    toks, lens, _ = llm.lm_decode(recast, lm_cfg, *args, max_gen, draws=_draws(*draws))
    out["recast_tokens"] = (toks.numpy(), lens.numpy())
    return out


def tp_tts(rank, world, config, prompt, text):
    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.serving.engine import EngineAPI, follows

    model = cosy.load(config=config, seed=0, device="cpu", compute_dtype="float32", tp=world)
    wav, sr = model.tts(text, prompt)
    served = EngineAPI(model, n_slots=2)  # process 0 serves, the other follows until it closes
    if not follows(served):
        served.close()
    return {"wav": wav, "sr": sr, "tokens": model._model.last_n_tokens,
            "role": served.engine.role,
            "q_rows": tuple(model._model.params["llm"]["backbone"]["layers"][0]["q_proj"]
                            ["weight"].shape)}


# ---------------------------------------------------------------------------
# serving under tensor parallelism
# ---------------------------------------------------------------------------

DRAIN_S = 120.0  # seconds a rank waits for a request's audio


def _drain(handles):
    """Each handle's chunks joined (or its error's text), read in a thread
    joined with a deadline."""
    import threading

    out = [None] * len(handles)

    def read():
        for i, h in enumerate(handles):
            try:
                out[i] = np.concatenate(list(h))
            except RuntimeError as e:
                out[i] = str(e)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    reader.join(DRAIN_S)
    if reader.is_alive():
        raise AssertionError(f"the engine gave no end of audio within {DRAIN_S} s")
    return out


def _slots(engine):
    st = engine.state
    return st.tokens.numpy().copy(), st.lengths.numpy().copy()


def tp_serving(rank, world, config, prompts, refused, engine_kw, spk):
    """``load(tp=world)`` and three engines in turn, each closed by process
    0 and followed by the others: (1) ``prompts`` at once (the follower
    starts 2 s late, so process 0's loop, waiting for it, finds them all
    queued); (2) ``refused`` (its prompt past the cache) beside the first
    prompt again; (3) ``serving_api`` behind the stdlib HTTP server, one
    POST of a stored speaker.  Each rank returns its slots' tokens after
    each engine and, on process 0, the audio."""
    import http.client
    import json
    import threading
    import time

    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.serving import engine as E
    from cosyvoice2_eu_torch.serving import http_server

    api = cosy.load(config=config, seed=0, device="cpu", compute_dtype="float32", tp=world)
    out = {}
    for run, batch in (("concurrent", prompts), ("refused", [prompts[0], refused])):
        engine = E.TTSEngine(api._model, **engine_kw)
        out[f"{run}_role"] = engine.role
        if rank > 0:
            if run == "concurrent":
                time.sleep(2.0)
            out[f"{run}_steps"] = engine.follow()
        else:
            try:
                out[f"{run}_audio"] = _drain([engine.submit(p) for p in batch])
            finally:
                engine.close()
        out[f"{run}_slots"] = _slots(engine)

    served = E.serving_api(api, 2)
    out["http_role"] = served.engine.role
    if not E.follows(served):
        server = http_server.serve_stdlib(served, host="127.0.0.1", port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            api._frontend.add_zero_shot_spk("spk", spk)
            conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                              timeout=DRAIN_S)
            try:
                conn.request("POST", "/inference_sft",
                             json.dumps({"tts_text": "Bonjour.", "spk_id": "spk"}))
                resp = conn.getresponse()
                out["http"] = (resp.status, resp.read())
            finally:
                conn.close()
        finally:
            server.shutdown()
            server.server_close()
            thread.join(DRAIN_S)
            served.close()
    out["http_slots"] = _slots(served.engine)
    return out


def tp_entries(rank, world, config):
    """Each serving entry built under ``load(tp=world)`` on every rank (the
    web UI over a stand-in for gradio, which is not installed), its role
    read; process 0 then closes its engine and the others follow until it
    does."""
    import sys
    from unittest import mock

    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.serving import engine as E
    from cosyvoice2_eu_torch.serving import grpc_server, http_server, webui

    sys.modules.setdefault("gradio", mock.MagicMock())
    api = cosy.load(config=config, seed=0, device="cpu", compute_dtype="float32", tp=world)
    out = {}
    for entry in ("engine", "http", "grpc", "webui"):
        if entry == "engine":
            served = engine = E.TTSEngine(api._model)
        else:
            served = E.serving_api(api)
            engine = served.engine
            {"http": http_server._routes, "grpc": grpc_server.CosyVoiceServicer,
             "webui": webui.build_demo}[entry](served)
        if engine.role == "follower":
            out[entry] = (engine.role, engine.follow())
        else:
            served.close()
            out[entry] = (engine.role, engine._thread.is_alive())
    return out
