"""The port's data tools against the JAX package's on the CPU:
``tools/prepare_data.py`` on seeded utterances with tiny tokenizer and CAM++
parameters handed to both as orbax directories (the parquet columns equal,
tokens exact, embeddings within 1e-5), and ``tools/convert_and_verify.py``'s
report on synthetic graphs and checkpoints (mirroring
``tests/test_convert_tool.py``), its converted trees included."""

import dataclasses
import json
import os

import jax
import numpy as np
import pyarrow.parquet as pq
import pytest
from test_onnx_convert import build_campplus_onnx, build_tokenizer_onnx
from test_onnx_fallback import build_unconvertible_tokenizer
from test_torch_checkpoint import _save_model_dir
from test_torch_frontend import write_wav
from test_torch_native_checkpoint import _bit_equal
from torch_parity import jax_tts_params, to_numpy

from cosyvoice2_eu_torch import config as port_config
from cosyvoice2_eu_torch.models import campplus as port_cam
from cosyvoice2_eu_torch.models import speech_tokenizer as port_st
from cosyvoice2_eu_torch.runtime import checkpoint as port_ckpt
from cosyvoice2_eu_torch.tools import convert_and_verify as port_cv
from cosyvoice2_eu_torch.tools import prepare_data as port_prep
from cosyvoice2_eu_tpu import config as jax_config
from cosyvoice2_eu_tpu.models import campplus as jax_cam
from cosyvoice2_eu_tpu.models import speech_tokenizer as jax_st
from cosyvoice2_eu_tpu.runtime import checkpoint as jax_ckpt
from tools import convert_and_verify as jax_cv
from tools import prepare_data as jax_prep

TOK = dataclasses.replace(jax_st.tiny_tokenizer_config(), fsq_dim=4)
CAM = dataclasses.replace(jax_cam.tiny_campplus_config(), embedding_size=192)


@pytest.fixture
def tiny_frontend(monkeypatch):
    """Both packages' frontend models at the tiny widths (the tools build
    them with the default configs)."""
    for mod, name, cfg in ((jax_st, "SpeechTokenizerConfig", TOK),
                           (jax_cam, "CAMPPlusConfig", CAM),
                           (port_st, "SpeechTokenizerConfig",
                            port_st.SpeechTokenizerConfig(**dataclasses.asdict(TOK))),
                           (port_cam, "CAMPPlusConfig",
                            port_cam.CAMPPlusConfig(**dataclasses.asdict(CAM)))):
        monkeypatch.setattr(mod, name, lambda c=cfg: c)


@pytest.fixture(scope="module")
def corpus_lists(tmp_path_factory):
    """4 seeded utterances of 2 speakers (one wav unreadable, one without a
    text), their kaldi lists, and the tiny models' parameters as orbax
    directories."""
    d = tmp_path_factory.mktemp("prep")
    wavs, texts, spk = [], [], []
    for i in range(4):
        path = write_wav(d / f"u{i}.wav", 0.6 + 0.3 * i, sr=(16000, 24000, 22050, 16000)[i],
                         seed=i)
        wavs.append(f"u{i} {path}")
        texts.append(f"u{i} phrase numéro {i}")
        spk.append(f"u{i} spk{i % 2}")
    (d / "broken.wav").write_bytes(b"not a wav")
    wavs += [f"broken {d / 'broken.wav'}", f"notext {d / 'u0.wav'}"]
    texts.append("broken phrase")
    for name, lines in (("wav.scp", wavs), ("text", texts), ("utt2spk", spk)):
        (d / name).write_text("\n".join(lines) + "\n")
    k1, k2 = jax.random.split(jax.random.key(0))
    jax_ckpt.save_pytree(str(d / "tok"), jax_st.init_speech_tokenizer(k1, TOK))
    jax_ckpt.save_pytree(str(d / "cam"), jax_cam.init_campplus(k2, CAM))
    return d


def _args(d, out, extra=()):
    return ["--wav_scp", str(d / "wav.scp"), "--text", str(d / "text"), "--utt2spk",
            str(d / "utt2spk"), "--out_dir", str(out), "--num_utts_per_parquet", "2",
            "--tokenizer_params", str(d / "tok"), "--campplus_params", str(d / "cam"), *extra]


def test_prepare_data_equals_jax(corpus_lists, tmp_path, tiny_frontend):
    d = corpus_lists
    got_paths = port_prep.main(_args(d, tmp_path / "port", ["--device", "cpu"]))
    jax_prep.main(_args(d, tmp_path / "jax"))
    lists = [(tmp_path / side / "data.list").read_text().split() for side in ("port", "jax")]
    assert [os.path.basename(p) for p in lists[0]] == [os.path.basename(p) for p in lists[1]]
    assert lists[0] == got_paths and len(got_paths) == 2  # 4 rows, 2 a shard
    for gp, wp in zip(*lists):
        got, want = pq.read_table(gp), pq.read_table(wp)
        assert got.schema == want.schema
        assert got.column_names == ["utt", "spk", "text", "speech", "sample_rate",
                                    "speech_token", "utt_embedding", "spk_embedding"]
        for name in got.column_names:
            g, w = got.column(name).to_pylist(), want.column(name).to_pylist()
            if name in ("utt_embedding", "spk_embedding"):
                g, w = np.asarray(g), np.asarray(w)
                np.testing.assert_allclose(g, w, atol=1e-5 * np.abs(w).max(), err_msg=name)
            else:
                assert g == w, name
    assert sum(len(pq.read_table(p)) for p in got_paths) == 4


def test_prepare_data_rows_without_models(corpus_lists):
    """Without the models the rows hold the waveform and the texts only;
    without utt2spk each utterance is its own speaker."""
    d = corpus_lists
    wavs, texts = port_prep.read_kv(str(d / "wav.scp")), port_prep.read_kv(str(d / "text"))
    rows = port_prep.utterance_rows(wavs, texts, {u: u for u in wavs})
    assert [r["utt"] for r in rows] == ["u0", "u1", "u2", "u3"]
    assert all(set(r) == {"utt", "spk", "text", "speech", "sample_rate"} and r["spk"] == r["utt"]
               for r in rows)
    assert len(rows[1]["speech"]) == int((0.6 + 0.3) * 24000)  # written at 24 kHz


def _report(main, args, out):
    rc = main(args + ["--out", str(out)])
    return rc, json.loads(out.read_text())


def _without_timing(report):
    return {k: ({kk: vv for kk, vv in v.items() if kk not in ("seconds", "cosine")}
                if isinstance(v, dict) else v) for k, v in report.items()}


@pytest.mark.parametrize("graphs", ["campplus", "both", "unconvertible"])
def test_convert_and_verify_report_equals_jax(tmp_path, graphs):
    """The ONNX half of the report: the structural conversions (codes exact,
    cosine above 0.999) and, for a graph the converter cannot map, the
    executor's smoke test; the same fields and verdicts as JAX's."""
    d = tmp_path / "model"
    d.mkdir()
    if graphs in ("campplus", "both"):
        build_campplus_onnx(d / "campplus.onnx", jax_cam.tiny_campplus_config(),
                            np.random.default_rng(0), t_in=200)
    if graphs == "both":
        build_tokenizer_onnx(d / "speech_tokenizer_v2.onnx", np.random.default_rng(1), t_in=96)
    if graphs == "unconvertible":
        build_unconvertible_tokenizer(d / "speech_tokenizer_v2.onnx", np.random.default_rng(2))
    args = ["--model_dir", str(d), "--skip-synthesis"]
    rc, got = _report(port_cv.main, args + ["--device", "cpu"], tmp_path / "p.json")
    jrc, want = _report(jax_cv.main, args, tmp_path / "j.json")
    assert rc == jrc == 0 and got["all_ok"] and got["partial"]
    if graphs == "unconvertible":
        assert got["speech_tokenizer"]["mode"] == "executor_fallback"
        for r in (got, want):
            r["speech_tokenizer"].pop("structural_error")
    else:
        assert got["campplus"]["mode"] == "structural"
        assert abs(got["campplus"]["cosine"] - want["campplus"]["cosine"]) < 1e-6
    assert _without_timing(got) == _without_timing(want)


def test_convert_and_verify_empty_dir(tmp_path, capsys):
    rc = port_cv.main(["--model_dir", str(tmp_path), "--skip-torch", "--skip-onnx",
                       "--skip-synthesis", "--device", "cpu"])
    assert rc == 1
    report = json.loads(capsys.readouterr().out)
    assert report["error"] == "no checkpoint artifacts found"
    assert len(report["artifacts_missing"]) == 5


def test_convert_and_verify_saves_converted_trees(tmp_path, monkeypatch):
    """``--save-converted`` on the reference's ``.pt`` files (at the tiny
    config in both packages): the port's native directories hold the trees
    JAX's orbax directories hold, bit for bit."""
    port_tiny, jax_tiny = port_config.tiny_test_config(), jax_config.tiny_test_config()
    monkeypatch.setattr(port_config, "TTSConfig", lambda: port_tiny)
    monkeypatch.setattr(jax_config, "TTSConfig", lambda: jax_tiny)
    d = _save_model_dir(tmp_path / "model", to_numpy(jax_tts_params(jax_tiny, seed=0)))
    args = ["--model_dir", d, "--skip-onnx", "--skip-synthesis"]
    rc, got = _report(port_cv.main, args + ["--device", "cpu", "--save-converted",
                                            str(tmp_path / "p")], tmp_path / "p.json")
    jrc, want = _report(jax_cv.main, args + ["--save-converted", str(tmp_path / "j")],
                        tmp_path / "j.json")
    assert rc == jrc == 0
    assert {k: v for k, v in got.items() if k != "saved_converted"} == \
        {k: v for k, v in want.items() if k != "saved_converted"}
    assert got["torch_parity"] == "skipped: reference checkout not present"
    for name in ("llm", "flow", "hift"):
        assert os.listdir(tmp_path / "p" / name) == [port_ckpt.NATIVE_TREE_FILE]
        _bit_equal(port_ckpt.load_pytree(str(tmp_path / "p" / name)),
                   port_ckpt.load_pytree(str(tmp_path / "j" / name)))
