"""Upload trained checkpoints to the Hugging Face Hub.

Counterpart of ``tools/upload_weights.py`` (the JAX package's; reference
bin/upload_weights.py) over the port's checkpoints: each model directory's
best checkpoint, by the reference's order of preference, and the
experiment's config and tokenizer files.  ``--dry-run`` lists the upload
set and needs no network; without ``huggingface_hub`` only the dry run
works.

    python -m cosyvoice2_eu_torch.tools.upload_weights --exp_dir exp/cosyvoice2 \
        --hf_repo_id user/model [--models llm flow hifigan] [--dry-run]
"""

from __future__ import annotations

import argparse
import logging
import os

SIDECARS = ("config.json", "tokenizer.json", "tokenizer_config.json", "vocab.json",
            "merges.txt", "cosyvoice2.yaml")


def find_best_checkpoint(model_dir: str) -> str | None:
    """The best checkpoint of one model directory: an averaged one
    (``<model>_averaged``, ``averaged_model`` or ``averaged``: a file, a
    directory or ``<name>.pt``), else the lowest CV loss among the
    checkpoints' JSON sidecars (``train/executor.py``), else the latest."""
    from cosyvoice2_eu_torch.train.executor import latest_checkpoint, list_checkpoints

    model_name = os.path.basename(model_dir.rstrip("/"))
    for cand in (f"{model_name}_averaged", "averaged_model", "averaged"):
        p = os.path.join(model_dir, cand)
        for path in (p, p + ".pt"):
            if os.path.exists(path):
                return path
    try:
        ckpts = list_checkpoints(model_dir)
    except (OSError, ValueError):
        logging.exception("checkpoint listing failed for %s", model_dir)
        return None
    with_cv = [c for c in ckpts if c.get("cv_loss") is not None]
    info = (min(with_cv, key=lambda c: c["cv_loss"]) if with_cv
            else latest_checkpoint(model_dir))
    if info and info.get("tag"):
        return os.path.join(model_dir, info["tag"])
    return None


def collect_uploads(exp_dir: str, models: list[str]) -> dict[str, str]:
    """{path in the repo: local path} for each model's best checkpoint
    (``hifigan`` uploads as ``hift``), plus the sidecars at the
    experiment's root."""
    uploads: dict[str, str] = {}
    for model in models:
        mdir = os.path.join(exp_dir, model)
        if not os.path.isdir(mdir):
            logging.warning("missing model dir %s", mdir)
            continue
        best = find_best_checkpoint(mdir)
        if best is None:
            logging.warning("no checkpoint found under %s", mdir)
            continue
        name = "hift" if model == "hifigan" else model
        ext = "" if os.path.isdir(best) else os.path.splitext(best)[1]
        uploads[f"{name}{ext}"] = best
    for sidecar in SIDECARS:
        p = os.path.join(exp_dir, sidecar)
        if os.path.exists(p):
            uploads[sidecar] = p
    return uploads


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--exp_dir", required=True)
    parser.add_argument("--hf_repo_id", required=True)
    parser.add_argument("--hf_token", default=None)
    parser.add_argument("--models", nargs="+", default=["llm", "flow", "hifigan"])
    parser.add_argument("--dry-run", action="store_true",
                        help="list what would upload, no network")
    args = parser.parse_args(argv)

    uploads = collect_uploads(args.exp_dir, args.models)
    if not uploads:
        raise SystemExit("nothing to upload")
    for repo_path, local in sorted(uploads.items()):
        print(f"{repo_path}  <-  {local}")
    if args.dry_run:
        return uploads

    try:
        from huggingface_hub import HfApi
    except ImportError:
        raise SystemExit("huggingface_hub is not installed; re-run with --dry-run to "
                         "inspect the upload set")
    api = HfApi(token=args.hf_token or os.environ.get("HF_TOKEN"))
    api.create_repo(args.hf_repo_id, exist_ok=True, repo_type="model")
    for repo_path, local in uploads.items():
        if os.path.isdir(local):
            api.upload_folder(folder_path=local, path_in_repo=repo_path,
                              repo_id=args.hf_repo_id)
        else:
            api.upload_file(path_or_fileobj=local, path_in_repo=repo_path,
                            repo_id=args.hf_repo_id)
    print(f"uploaded {len(uploads)} artifacts to {args.hf_repo_id}")
    return uploads


if __name__ == "__main__":
    main()
