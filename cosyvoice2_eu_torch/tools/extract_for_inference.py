"""Extract a trained checkpoint into an inference model directory.

Counterpart of the JAX package's ``tools/extract_for_inference.py``
(reference: extract_model_for_inference.py, cli/cosyvoice.py:239-268).  A
training run's directory holds ``<tag>`` and its sidecar ``<tag>.json``: the
port's trainer (``train/executor.py``) writes ``<tag>`` as a ``torch.save``
file, the JAX package's as an orbax directory; both are read.  The tool takes
the checkpoint with the least CV loss (``train/select.py``), or the latest
(``executor.latest_checkpoint``) where no CV loss is logged, as in GAN runs;
takes the ``generator`` subtree of a GAN whole checkpoint and leaves the
optimizer state behind; and writes a native checkpoint directory
(``runtime/checkpoint.py::save_pytree``) named ``{llm|flow|hift}-{run_id}``,
or the bare component name with ``--final``, which ``load(model_dir=...)``
resolves as it resolves the reference's ``.pt`` files.

Usage:
  python -m cosyvoice2_eu_torch.tools.extract_for_inference \\
      --exp-dir exp/llm-fr --component llm --out-dir models/eu \\
      --run-id 1500-averaged-blanken-FR [--tag averaged-fr] [--final]
"""

from __future__ import annotations

import argparse
import json
import os

# output component key per --component flag (hifigan trains the hift generator)
_KEYS = {"llm": "llm", "flow": "flow", "hifigan": "hift"}


def read_checkpoint(path: str):
    """A training checkpoint's parameter tree: the port's ``torch.save``
    file, or a checkpoint directory (the JAX package's orbax one)."""
    from cosyvoice2_eu_torch.runtime.checkpoint import load_pytree

    if os.path.isdir(path):
        return load_pytree(path)
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def extract(exp_dir: str, component: str, out_dir: str, tag: str | None = None,
            run_id: str | None = None, final: bool = False) -> str:
    """Write the chosen checkpoint of ``exp_dir`` into ``out_dir``; returns
    the written directory."""
    from cosyvoice2_eu_torch.runtime.checkpoint import save_pytree
    from cosyvoice2_eu_torch.train.executor import latest_checkpoint
    from cosyvoice2_eu_torch.train.select import select_best

    key = _KEYS[component]
    if tag is None:
        try:
            tag = select_best(exp_dir)["tag"]  # the least CV loss by default
        except ValueError:
            info = latest_checkpoint(exp_dir)  # GAN runs log no cv_loss
            if info is None:
                raise FileNotFoundError(f"no checkpoints under {exp_dir}") from None
            tag = info["tag"]
    tree = read_checkpoint(os.path.join(exp_dir, tag))
    # GAN whole checkpoints wrap {generator, discriminator}; inference wants
    # the generator (the reference strips the 'generator.' prefix)
    if isinstance(tree, dict) and "generator" in tree:
        tree = tree["generator"]
    out_path = os.path.join(out_dir, key if final else f"{key}-{run_id or tag}")
    save_pytree(out_path, tree)
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--exp-dir", required=True, help="training dir with checkpoints")
    parser.add_argument("--component", required=True, choices=sorted(_KEYS))
    parser.add_argument("--out-dir", required=True, help="inference model dir")
    parser.add_argument("--tag", default=None, help="checkpoint tag (default: best cv_loss)")
    parser.add_argument("--run-id", default=None, help="output run id (default: the tag)")
    parser.add_argument("--final", action="store_true",
                        help="write the unsuffixed component name (the 'final' matrix slot)")
    args = parser.parse_args(argv)
    path = extract(args.exp_dir, args.component, args.out_dir, tag=args.tag,
                   run_id=args.run_id, final=args.final)
    print(json.dumps({"written": path}))
    return path


if __name__ == "__main__":
    main()
