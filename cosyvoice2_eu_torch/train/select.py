"""Checkpoint selection: the best by CV loss, and the average of the top N.

Counterpart of ``cosyvoice2_eu_tpu/train/select.py`` (reference:
cosy_repo/cosyvoice/bin/select_best_checkpoint.py:15 and
bin/average_model.py:44-75), over the port's checkpoints
(``train/executor.py``).

Usage:
  python -m cosyvoice2_eu_torch.train.select best --model_dir exp/llm
  python -m cosyvoice2_eu_torch.train.select average --model_dir exp/llm --num 5
"""

from __future__ import annotations

import argparse
import json

from cosyvoice2_eu_torch.train.executor import (
    average_checkpoints,
    list_checkpoints,
    save_checkpoint,
)


def select_best(model_dir: str, metric: str = "cv_loss") -> dict:
    """The sidecar of the checkpoint with the least ``metric``; raises
    ``ValueError`` when none has it."""
    infos = [i for i in list_checkpoints(model_dir) if metric in i]
    if not infos:
        raise ValueError(f"no checkpoints with {metric} in {model_dir}")
    return min(infos, key=lambda i: i[metric])


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("command", choices=["best", "average"])
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--num", type=int, default=5)
    parser.add_argument("--metric", default="cv_loss")
    parser.add_argument("--out", default=None, help="output tag for the averaged checkpoint")
    args = parser.parse_args(argv)

    if args.command == "best":
        info = select_best(args.model_dir, args.metric)
        print(json.dumps(info, indent=2))
        return info

    avg, tags = average_checkpoints(args.model_dir, args.num, args.metric)
    out_tag = args.out or f"averaged_top{args.num}"
    # the sidecar has no metric, so the average is never itself chosen
    save_checkpoint(args.model_dir, out_tag, avg, {"averaged_from": tags})
    print(json.dumps({"tag": out_tag, "averaged_from": tags}, indent=2))
    return {"tag": out_tag, "averaged_from": tags}


if __name__ == "__main__":
    main()
