"""The port's corpus tools (``data/corpus.py``, ``tools/corpus_tool.py``)
against the JAX package's on ``tests/test_corpus.py``'s synthetic tree:
scans, summaries, subsets under the same seeds, file lists, materialized,
merged and OOD trees, the filtered CSV, and every ``corpus_tool``
subcommand but ``download`` (which needs the network)."""

import csv
import dataclasses
import os

import numpy as np
import pytest
from test_corpus import tree  # noqa: F401 (the synthetic corpus fixture)

from cosyvoice2_eu_torch.data import corpus as port_corpus
from cosyvoice2_eu_torch.tools import corpus_tool as port_tool
from cosyvoice2_eu_tpu.data import corpus as jax_corpus
from tools import corpus_tool as jax_tool


def _files(root) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _utts(utts, root=None):
    rows = [dataclasses.asdict(u) for u in utts]
    if root is not None:
        for r in rows:
            for k in ("wav", "text"):
                r[k] = os.path.relpath(r[k], root) if r[k] else ""
    return rows


def test_scan_and_summary_equal_jax(tree):  # noqa: F811
    for splits in (None, ["train"], ["dev"]):
        got = port_corpus.scan_corpus(str(tree), splits)
        want = jax_corpus.scan_corpus(str(tree), splits)
        assert _utts(got) == _utts(want)
        assert port_corpus.summarize(got) == jax_corpus.summarize(want)
    assert [port_corpus.infer_lang(s) for s in ("mls_fr_0001", "1234_5", "de_emonet_anna", "x")] \
        == [jax_corpus.infer_lang(s) for s in ("mls_fr_0001", "1234_5", "de_emonet_anna", "x")]
    wav = str(tree / "train" / "mls_de_0003" / "mls_de_0003_0000.wav")
    assert port_corpus.wav_duration(wav) == jax_corpus.wav_duration(wav) > 0
    assert port_corpus.wav_duration(str(tree / "none.wav")) == 0.0


@pytest.mark.parametrize("kw", [
    dict(target_hours=0.005, lang_ratios={"mls_fr": 0.5, "mls_de": 0.5}, seed=1),
    dict(target_hours=0.01, seed=3),
    dict(target_hours=1.0, max_clip_s=6.0, min_clip_s=2.0, seed=0),
])
def test_budget_subset_equals_jax(tree, kw):  # noqa: F811
    utts = port_corpus.scan_corpus(str(tree))
    got = port_corpus.budget_subset(utts, **kw)
    want = jax_corpus.budget_subset(jax_corpus.scan_corpus(str(tree)), **kw)
    assert got and _utts(got) == _utts(want)


def test_file_list_and_materialize_equal_jax(tree, tmp_path):  # noqa: F811
    utts = [u for u in port_corpus.scan_corpus(str(tree), ["dev"]) if u.ok]
    port_corpus.write_file_list(utts, str(tmp_path / "p.jsonl"))
    jax_corpus.write_file_list(jax_corpus.scan_corpus(str(tree), ["dev"])[:len(utts)],
                               str(tmp_path / "j.jsonl"))
    assert (tmp_path / "p.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    assert _utts(port_corpus.read_file_list(str(tmp_path / "p.jsonl"))) == _utts(utts)
    for link in (True, False):
        n = port_corpus.materialize_subset(utts, str(tree), str(tmp_path / f"p{link}"), link)
        m = jax_corpus.materialize_subset(jax_corpus.read_file_list(str(tmp_path / "j.jsonl")),
                                          str(tree), str(tmp_path / f"j{link}"), link)
        assert n == m == 2 * len(utts)
        assert _files(tmp_path / f"p{link}") == _files(tmp_path / f"j{link}")


def test_merge_and_ood_equal_jax(tree, tmp_path):  # noqa: F811
    for prefix in ("", "extra_"):
        got = port_corpus.merge_tree(str(tree), str(tmp_path / f"pm{prefix}"), prefix)
        want = jax_corpus.merge_tree(str(tree), str(tmp_path / f"jm{prefix}"), prefix)
        assert got == want and sum(got.values()) > 0
        assert _files(tmp_path / f"pm{prefix}") == _files(tmp_path / f"jm{prefix}")
        assert port_corpus.merge_tree(str(tree), str(tmp_path / f"pm{prefix}"), prefix) == {}
    for per, seed in ((3, 2), (1, 0)):
        n = port_corpus.build_ood_testset(str(tree), str(tmp_path / f"po{per}"), per, seed=seed)
        m = jax_corpus.build_ood_testset(str(tree), str(tmp_path / f"jo{per}"), per, seed=seed)
        assert n == m > 0
        assert _files(tmp_path / f"po{per}") == _files(tmp_path / f"jo{per}")


def _meta_csv(path):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file", "text", "speaker"])
        w.writeheader()
        w.writerows([{"file": "a.wav", "text": "bonjour le monde", "speaker": "s1"},
                     {"file": "", "text": "missing file", "speaker": "s1"},
                     {"file": "b.wav", "text": "x", "speaker": "s2"},
                     {"file": "c.wav", "text": "guten tag", "speaker": ""},
                     {"file": "d.wav", "text": "y" * 40, "speaker": "s3"}])


def test_filter_metadata_csv_equals_jax(tmp_path):
    for side, mod in (("p", port_corpus), ("j", jax_corpus)):
        d = tmp_path / side
        d.mkdir()
        _meta_csv(d / "meta.csv")
        assert mod.filter_metadata_csv(str(d / "meta.csv"), str(d / "meta.csv")) == (3, 2)
        assert mod.filter_metadata_csv(str(d / "meta.csv.bak"), str(d / "short.csv"),
                                       min_chars=1, max_chars=20) == (3, 2)
    assert _files(tmp_path / "p") == _files(tmp_path / "j")


def test_write_wav_and_plot_equal_jax(tree, tmp_path):  # noqa: F811
    audio = np.sin(np.linspace(0, 40, 1600)).astype(np.float32) * 1.2
    port_corpus.write_wav(str(tmp_path / "p.wav"), audio, 16000)
    jax_corpus.write_wav(str(tmp_path / "j.wav"), audio, 16000)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    utts = port_corpus.scan_corpus(str(tree))
    assert port_corpus.plot_durations(utts, str(tmp_path / "p.png")) == \
        jax_corpus.plot_durations(utts, str(tmp_path / "j.png"))


def _run(main, args, capsys):
    main(args)
    return capsys.readouterr().out


@pytest.mark.parametrize("cmd", ["scan", "subset", "merge", "ood", "filter-csv"])
def test_corpus_tool_equals_jax(tree, tmp_path, capsys, cmd):  # noqa: F811
    """Each subcommand through both packages' ``main``: the same printout
    (paths aside) and the same files written."""
    outs = {}
    for side, main in (("p", port_tool.main), ("j", jax_tool.main)):
        d = tmp_path / side
        d.mkdir()
        if cmd == "scan":
            args = ["scan", str(tree), "--splits", "train,dev", "--json", str(d / "s.json")]
        elif cmd == "subset":
            args = ["subset", str(tree), "--hours", "0.004", "--out", str(d / "sel.jsonl"),
                    "--ratios", "mls_fr=0.7,mls_de=0.3", "--seed", "4", "--materialize",
                    str(d / "tree")]
        elif cmd == "merge":
            args = ["merge", str(tree), str(d / "tree"), "--prefix", "de_", "--copy"]
        elif cmd == "ood":
            args = ["ood", str(tree), str(d / "tree"), "--per-speaker", "2", "--seed", "5"]
        else:
            _meta_csv(d / "meta.csv")
            args = ["filter-csv", str(d / "meta.csv"), "--out", str(d / "f.csv"),
                    "--max-chars", "30"]
        outs[side] = _run(main, args, capsys).replace(str(d), "<dir>")
    assert outs["p"] == outs["j"] and outs["p"]
    assert _files(tmp_path / "p") == _files(tmp_path / "j")


def test_corpus_tool_rejects_a_missing_root(tmp_path):
    with pytest.raises(SystemExit):
        port_tool.main(["scan", str(tmp_path / "none")])
    with pytest.raises(SystemExit):
        port_tool.main(["subset", str(tmp_path), "--hours", "1", "--out", "x", "--ratios", "bad"])
