"""Command line of the port: ``python -m cosyvoice2_eu_torch.cli``.

Counterpart of ``cosyvoice2_eu_tpu/cli.py`` (the reference CLI's flags,
standalone_infer/src/cosyvoice2_eu/cli.py:54-123): --text --prompt --out
--model-dir --setting --llm-run-id --flow-run-id --hifigan-run-id --final
--stream --speed --text-frontend --prompt-text --mode --backbone
--clear-cache, plus --device (default cuda; "cpu" runs the plain PyTorch
path), with one model cached in the process.  Audio is written as 16-bit
PCM wav.  ``warmup [flags]`` runs ``runtime/warmup.py::warmup_main``: it
builds the kernel store into ``<model_dir>/aot_store`` or ``--export-store``
and drives the serving modes once.
"""

from __future__ import annotations

import argparse
import os
import sys
import wave

import numpy as np

_cached_model = None
_cached_key = None


def get_or_load_model(**kwargs):
    """``load(**kwargs)``, kept for the next call with the same arguments."""
    global _cached_model, _cached_key
    key = tuple(sorted(kwargs.items()))
    if _cached_model is None or _cached_key != key:
        import cosyvoice2_eu_torch as cosy

        _cached_model = cosy.load(**kwargs)
        _cached_key = key
    return _cached_model


def save_wav(path: str, audio: np.ndarray, sr: int) -> None:
    """Write mono float audio in [-1, 1] as 16-bit PCM."""
    pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def main(argv=None):
    global _cached_model, _cached_key

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["warmup"]:
        # `cosy2-eu warmup`: build the kernel store (and drive the serving modes)
        # ahead of serving, into <model_dir>/aot_store or --export-store
        from cosyvoice2_eu_torch.runtime.warmup import warmup_main

        return warmup_main(argv[1:])
    parser = argparse.ArgumentParser(
        description="CosyVoice2-EU inference on the PyTorch port (cross-lingual cloning)")
    parser.add_argument("--text", type=str, required=True)
    parser.add_argument("--prompt", type=str, required=True, help="path to a prompt wav")
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument(
        "--model-dir", type=str, default=os.path.expanduser("~/.cache/cosyvoice2-eu"))
    parser.add_argument("--setting", type=str, default="llm_flow_hifigan")
    parser.add_argument("--llm-run-id", type=str, default=None)
    parser.add_argument("--flow-run-id", type=str, default=None)
    parser.add_argument("--hifigan-run-id", type=str, default=None)
    parser.add_argument("--final", action="store_true")
    parser.add_argument("--stream", action="store_true")
    parser.add_argument("--speed", type=float, default=1.0)
    parser.add_argument("--text-frontend", action="store_true")
    parser.add_argument("--prompt-text", type=str, default="")
    parser.add_argument("--mode", type=str, default="cross_lingual",
                        choices=["cross_lingual", "zero_shot"])
    parser.add_argument("--backbone", type=str, default=None,
                        help="blanken | hf:<id-or-path> | local:<path>; backbones other "
                        "than BlankEN decode through the bistream fill-token protocol")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--clear-cache", action="store_true")
    args = parser.parse_args(argv)

    if args.clear_cache:
        _cached_model, _cached_key = None, None

    model = get_or_load_model(
        model_dir=args.model_dir,
        setting=args.setting,
        llm_run_id=args.llm_run_id,
        flow_run_id=args.flow_run_id,
        hifigan_run_id=args.hifigan_run_id,
        final=args.final or None,
        backbone=args.backbone,
        device=args.device,
    )

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    kwargs = dict(prompt_text=args.prompt_text, speed=args.speed,
                  text_frontend=args.text_frontend, mode=args.mode)
    if args.stream:
        audio = np.concatenate([c[0] for c in model.stream(args.text, args.prompt, **kwargs)])
    else:
        audio = model.tts(args.text, args.prompt, **kwargs)[0][0]
    save_wav(args.out, audio, model.sample_rate)
    print(f"wrote {args.out}: {len(audio) / model.sample_rate:.2f}s at {model.sample_rate} Hz")


if __name__ == "__main__":
    main()
