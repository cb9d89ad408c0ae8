"""Convert the reference's release checkpoints and verify the conversions.

Counterpart of the JAX package's ``tools/convert_and_verify.py``.  Given a
model directory holding the release files (llm.pt / flow.pt / hift.pt,
optionally speech_tokenizer_v2.onnx / campplus.onnx), this tool:

  1. verifies the ONNX conversions (``runtime/onnx_convert.py``) against the
     graphs' own arithmetic (``runtime/onnx_exec.py``): FSQ codes
     token-exact, x-vector cosine; a graph the converter cannot map is run
     through the executor instead and reported as ``executor_fallback``;
  2. synthesizes a sentence through the port and reports its statistics;
  3. writes the converted checkpoints as native checkpoint directories
     (``--save-converted``, ``runtime/checkpoint.py::save_pytree``);
  4. prints a JSON report (and writes it with ``--out``).

The activation parity against the reference's PyTorch modules needs the
upstream code, which the port does not carry: the report says it was
skipped.  Everything runs on ``--device`` (default cuda).

Usage:
  python -m cosyvoice2_eu_torch.tools.convert_and_verify --model_dir /path/to/ckpts \\
      [--out report.json] [--save-converted exp/converted] [--skip-torch] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

_ALL = ("llm.pt", "flow.pt", "hift.pt", "speech_tokenizer_v2.onnx", "campplus.onnx")


def _maybe(path):
    return path if os.path.exists(path) else None


def verify_torch_checkpoints(model_dir: str, cfg, report: dict) -> dict:
    """The activation parity against the reference's PyTorch modules: it
    builds them from the upstream code, which the port does not carry, so
    the report says it was skipped (the JAX package's report without that
    code)."""
    report["torch_parity"] = "skipped: reference checkout not present"
    return report


def verify_onnx(model_dir: str, report: dict, n_frames: int = 96, device="cuda") -> dict:
    """The converted frontend models on ``device`` against the ONNX graphs
    run by the executor."""
    import torch

    from cosyvoice2_eu_torch.models import campplus as cam
    from cosyvoice2_eu_torch.models import speech_tokenizer as st
    from cosyvoice2_eu_torch.runtime.onnx_convert import (
        convert_campplus,
        convert_speech_tokenizer,
    )
    from cosyvoice2_eu_torch.runtime.onnx_exec import run_graph
    from cosyvoice2_eu_torch.runtime.onnx_fallback import (
        make_executor_speech_tokenizer_fn,
        make_executor_spk_embedding_fn,
    )
    from cosyvoice2_eu_torch.runtime.onnx_import import load_onnx
    from cosyvoice2_eu_torch.utils.device import resolve_device
    from cosyvoice2_eu_torch.utils.params import params_from_numpy

    dev = resolve_device(device)
    rng = np.random.default_rng(1)

    st_path = _maybe(os.path.join(model_dir, "speech_tokenizer_v2.onnx"))
    if st_path:
        t0 = time.time()
        model = load_onnx(st_path)
        try:
            params, st_cfg = convert_speech_tokenizer(model)
        except Exception as e:
            # load() would run this graph through the executor: smoke it and
            # report the structural error
            fn = make_executor_speech_tokenizer_fn(model, device=dev)
            codes = fn((rng.standard_normal(16000) * 0.05).astype(np.float32))
            report["speech_tokenizer"] = {
                "ok": bool(len(codes) > 0), "mode": "executor_fallback",
                "structural_error": str(e), "n_tokens": int(len(codes)),
                "seconds": round(time.time() - t0, 1)}
        else:
            mel = rng.standard_normal((1, st_cfg.n_mels, n_frames)).astype(np.float32)
            feeds = {model["inputs"][0]: mel}
            if len(model["inputs"]) > 1:  # length input
                feeds[model["inputs"][1]] = np.asarray([n_frames], np.int32)
            ref = np.asarray(run_graph(model, feeds, device=dev)[0]).reshape(-1)
            with torch.inference_mode():
                codes, code_len = st.encode(params_from_numpy(params, dev), st_cfg,
                                            torch.as_tensor(mel, device=dev),
                                            torch.tensor([n_frames], device=dev))
            got = codes[0, : int(code_len[0])].cpu().numpy()
            n = min(len(got), len(ref))
            report["speech_tokenizer"] = {
                "ok": bool(n > 0 and (got[:n] == ref[:n]).all()), "mode": "structural",
                "token_match": float((got[:n] == ref[:n]).mean()) if n else 0.0,
                "n_tokens": int(n),
                "config": {"layers": st_cfg.num_layers, "d_model": st_cfg.d_model,
                           "strides": list(st_cfg.conv_strides)},
                "seconds": round(time.time() - t0, 1)}

    cam_path = _maybe(os.path.join(model_dir, "campplus.onnx"))
    if cam_path:
        t0 = time.time()
        model = load_onnx(cam_path)
        try:
            params, cam_cfg = convert_campplus(model)
        except Exception as e:
            fn = make_executor_spk_embedding_fn(model, device=dev)
            emb = fn((rng.standard_normal(2 * 16000) * 0.05).astype(np.float32))
            report["campplus"] = {
                "ok": bool(len(emb) > 0 and np.isfinite(emb).all()),
                "mode": "executor_fallback", "structural_error": str(e),
                "embedding_dim": int(len(emb)), "seconds": round(time.time() - t0, 1)}
        else:
            fbank = rng.standard_normal((1, 200, cam_cfg.feat_dim)).astype(np.float32)
            ref = np.asarray(run_graph(model, {model["inputs"][0]: fbank}, device=dev)[0])
            ref = ref.reshape(-1)
            with torch.inference_mode():
                got = cam.campplus_forward(params_from_numpy(params, dev), cam_cfg,
                                           torch.as_tensor(fbank, device=dev))[0].cpu().numpy()
            cos = float(np.dot(ref, got) / (np.linalg.norm(ref) * np.linalg.norm(got) + 1e-12))
            report["campplus"] = {
                "ok": bool(cos > 0.999), "mode": "structural", "cosine": cos,
                "config": {"blocks": list(cam_cfg.block_layers),
                           "embedding": cam_cfg.embedding_size},
                "seconds": round(time.time() - t0, 1)}
    return report


def synthesize_sentence(model_dir: str, cfg, report: dict, device="cuda") -> dict:
    """One sentence through ``load(model_dir=...)`` and ``tts`` on a
    seeded 3 s prompt waveform."""
    import cosyvoice2_eu_torch as cosy

    t0 = time.time()
    model = cosy.load(model_dir=model_dir, config=cfg, device=device)
    prompt_wav = (np.random.default_rng(2).standard_normal(3 * 16000) * 0.05).astype(np.float32)
    try:
        wav, sr = model.tts("Bonjour, ceci est une phrase de vérification.", prompt_wav)
        report["synthesis"] = {
            "ok": bool(np.isfinite(wav).all() and wav.shape[-1] > 0),
            "seconds_audio": wav.shape[-1] / sr, "rms": float(np.sqrt(np.mean(wav**2))),
            "peak": float(np.abs(wav).max()), "wall_s": round(time.time() - t0, 1)}
    except ValueError as e:  # no frontend models and no precomputed prompt artifacts
        report["synthesis"] = {"ok": False, "skipped": str(e)}
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--out", default=None, help="write the JSON report here")
    ap.add_argument("--save-converted", default=None,
                    help="write the converted trees as native checkpoints under this dir")
    ap.add_argument("--skip-torch", action="store_true")
    ap.add_argument("--skip-onnx", action="store_true")
    ap.add_argument("--skip-synthesis", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from cosyvoice2_eu_torch.config import TTSConfig

    cfg = TTSConfig()
    report: dict = {"model_dir": args.model_dir}
    present = sorted(f for f in _ALL if os.path.exists(os.path.join(args.model_dir, f)))
    report["artifacts_found"] = present
    report["artifacts_missing"] = sorted(set(_ALL) - set(present))
    # a subset still gives a full report of what is there
    report["partial"] = bool(report["artifacts_missing"])
    if not present:
        print(json.dumps(dict(report, error="no checkpoint artifacts found")))
        return 1

    if not args.skip_torch:
        verify_torch_checkpoints(args.model_dir, cfg, report)
    if not args.skip_onnx:
        verify_onnx(args.model_dir, report, device=args.device)
    if not args.skip_synthesis and any(f.endswith(".pt") for f in present):
        synthesize_sentence(args.model_dir, cfg, report, device=args.device)

    if args.save_converted:
        from cosyvoice2_eu_torch.runtime.checkpoint import load_reference_checkpoints, save_pytree

        for name, tree in load_reference_checkpoints(args.model_dir, cfg).items():
            save_pytree(os.path.join(args.save_converted, name), tree)
        report["saved_converted"] = args.save_converted

    ok = all(v.get("ok", True) for v in report.values() if isinstance(v, dict) and "ok" in v)
    report["all_ok"] = ok
    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
