"""A cell, a configuration, a traffic mix, a driver and a per-layer metric
are taken up from new files and entries alone, with no existing file
edited."""

from __future__ import annotations

import json
import os
import shutil

from harness import registry
from harness.core import Check, Outcome


def _snapshot(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[p] = fh.read()
    return out


def test_new_files_are_found_by_name(tiny_root, tmp_path):
    root = str(tmp_path / "copy")
    shutil.copytree(tiny_root, root)
    before = _snapshot(root)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(bench, "configs", "tiny-b.json"), "w") as f:
        json.dump(dict(cfg, name="tiny-b"), f)
    with open(os.path.join(bench, "traffic", "echo.json"), "w") as f:
        json.dump({"driver": "echo", "generator": "none", "rate": 3}, f)
    with open(os.path.join(bench, "drivers", "echo.py"), "w") as f:
        f.write(
            "from harness.core import Check, Outcome\n"
            "def run(cell, seed, seconds, trace, t_start, device='cuda'):\n"
            "    rate = cell.traffic['rate'] * cell.config['model']['sample_rate']\n"
            "    return Outcome({'echo_per_s': rate, 'setup_s': 1.0}, {'echoes': seed},\n"
            "                   [Check('echo_gap', 0.0, 0.0)], 1, 0, 0)\n")
    with open(os.path.join(bench, "metrics", "echo_count.echo.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx['echoes']\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny-b", "source": "tests",
                            "file": "benchmark/configs/tiny-b.json", "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "tiny-b.echo", "config": "tiny-b", "traffic": "echo",
                              "chips": 1, "why": "x"})
    spec["end_to_end"].insert(0, {"name": "echo_per_s", "unit": "1/s", "better": "higher",
                                  "bound": 0.01, "source": "host_clock",
                                  "workloads": ["tiny-b.echo"]})
    spec["per_layer"].append({"name": "echo_count.echo", "unit": "1", "better": "higher",
                              "source": "program_counter", "layer": "echo",
                              "moves": "echo_per_s"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)

    cell = registry.Cell("tiny-b.echo", root=root)
    assert cell.config["name"] == "tiny-b" and cell.traffic["rate"] == 3
    assert [m["name"] for m in cell.end_to_end()] == ["echo_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer()] == ["echo_count.echo"]
    out = cell.driver().run(cell, 5, 1.0, False, 0.0)
    assert isinstance(out, Outcome) and out.e2e["echo_per_s"] == 3 * 24000
    assert out.correct and out.checks == [Check("echo_gap", 0.0, 0.0)]
    assert cell.reader("echo_count.echo").read(out.ctx) == 5
    # the cells already there are untouched and still find what they name
    assert registry.Cell("tiny.batch16", root=root).traffic["driver"] == "tts_batch"
    after = _snapshot(root)
    assert all(after[p] == b for p, b in before.items())


def test_every_named_file_exists():
    """Each cell of the repository's BENCHMARK.json finds its files, and each
    per-layer metric has its reader."""
    spec = json.load(open(os.path.join(registry.ROOT, "BENCHMARK.json")))
    for w in spec["workloads"]:
        cell = registry.Cell(w["name"])
        assert os.path.exists(os.path.join(cell.bench_dir, "drivers",
                                           cell.traffic["driver"] + ".py"))
        assert cell.per_layer(), w["name"]
    for m in spec["per_layer"]:
        assert os.path.exists(os.path.join(registry.BENCH_DIR, "metrics", m["name"] + ".py"))
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(registry.ROOT, c["file"]))
