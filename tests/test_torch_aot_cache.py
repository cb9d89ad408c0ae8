"""The port's store of compiled artifacts (``runtime/aot_cache.py``, the
kernel libraries ``ops/cuda_build.py`` builds) against the JAX package's
``aot_cache``: the directory's precedence, the content-based salt, the
library names, pruning, a model directory's shipped store, and persistence
turned off.  No nvcc here: the builds run a stand-in ``nvcc`` script that
writes its output file.  Nothing numeric is compared."""

import os
import shutil
import stat

import pytest

import cosyvoice2_eu_torch as port
from cosyvoice2_eu_torch.ops import cuda_build
from cosyvoice2_eu_torch.runtime import aot_cache
from cosyvoice2_eu_tpu.runtime import aot_cache as jax_aot

FAKE_NVCC = """#!/bin/sh
if [ "$1" = "--version" ]; then echo "Cuda compilation tools, release 12.4, V12.4.131"; exit 0; fi
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo "ptxas info    : Used 32 registers" >&2
echo built > "$out"
"""


@pytest.fixture
def clean(monkeypatch):
    """Both stores at their defaults, the port's state of a fresh process."""
    monkeypatch.delenv("COSY_AOT_CACHE", raising=False)
    monkeypatch.setattr(aot_cache, "_cache_dir_override", None)
    monkeypatch.setattr(aot_cache, "_process_dir", None)
    monkeypatch.setattr(aot_cache, "_pruned", False)
    monkeypatch.setattr(aot_cache, "store_stats", {"loaded": [], "built": []})
    monkeypatch.setattr(cuda_build, "build_logs", {})
    jax_aot.set_cache_dir(None)
    yield monkeypatch
    jax_aot.set_cache_dir(None)


@pytest.mark.parametrize("env", [None, "/env/wins", "off", "OFF", "0", "none", ""])
@pytest.mark.parametrize("override", [None, "/models/aot_store"])
def test_cache_dir_precedence_matches_jax(clean, env, override):
    """``COSY_AOT_CACHE`` wins, then ``set_cache_dir``, then the default:
    JAX's answer in every case but the default itself (JAX's /tmp/cosy_aot,
    the port's ``_build/``); off, 0, none and "" turn persistence off."""
    if env is not None:
        clean.setenv("COSY_AOT_CACHE", env)
    aot_cache.set_cache_dir(override)
    jax_aot.set_cache_dir(override)
    if env is None and override is None:
        assert aot_cache.cache_dir() == str(aot_cache.DEFAULT_DIR)
        assert jax_aot.cache_dir() == "/tmp/cosy_aot"
    else:
        assert aot_cache.cache_dir() == jax_aot.cache_dir()
    if env is not None and env.lower() in ("off", "0", "none", ""):
        assert aot_cache.cache_dir() is None


def _copy_csrc(tmp_path):
    d = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, d)
    return d


def test_salt_is_content_based(clean, tmp_path):
    """The same bytes at another path give the same salt (a shipped store
    keeps hitting); an edit to the copied source, or to a header, changes it."""
    src = "flash_attention.cu"
    salt = aot_cache._source_salt(src)
    copy = _copy_csrc(tmp_path)
    clean.setattr(cuda_build, "CSRC", copy)
    assert aot_cache._source_salt(src) == salt and len(salt) == 16
    (copy / src).write_bytes((copy / src).read_bytes() + b"\n// edited\n")
    edited = aot_cache._source_salt(src)
    assert edited != salt
    (copy / "tf32_mma.cuh").write_bytes((copy / "tf32_mma.cuh").read_bytes() + b"\n")
    assert aot_cache._source_salt(src) not in (salt, edited)


def test_library_name_follows_salt_and_capability(clean, tmp_path):
    """A library's name holds its stem, the capability and the salt: it
    changes with either, lies in the store, and matches the pattern
    pruning reads."""
    src = "int8_matmul_sm90.cu"
    clean.setenv("COSY_AOT_CACHE", str(tmp_path / "store"))
    path = cuda_build.library_path(src, "sm90")
    assert path.parent == tmp_path / "store"
    assert path.name == f"int8_matmul_sm90_sm90_{aot_cache._source_salt(src)}.so"
    assert aot_cache._NAME.match(path.name)["stem"] == "int8_matmul_sm90"
    assert cuda_build.library_path(src, "sm100") != path
    assert cuda_build.capability() == "sm90"  # no card here: the flags' target
    copy = _copy_csrc(tmp_path)
    clean.setattr(cuda_build, "CSRC", copy)
    assert cuda_build.library_path(src, "sm90") == path
    (copy / src).write_text("// another kernel\n")
    assert cuda_build.library_path(src, "sm90") != path


def test_prune_touches_only_the_default_and_its_own_names(clean, tmp_path):
    """The implicit default drops libraries (and logs) of other salts and of
    sources that are gone; files of other names (the YIN library, a
    ``tree/`` checkout) stay; an explicit store is never pruned."""
    d = tmp_path / "_build"
    (d / "tree").mkdir(parents=True)
    cur = d / aot_cache.library_name("flash_attention.cu", "sm90")
    files = {"cur": cur, "cur_log": cur.with_suffix(".log"),
             "stale": d / f"flash_attention_sm90_{'0' * 16}.so",
             "stale_log": d / f"flash_attention_sm90_{'0' * 16}.log",
             "gone": d / f"removed_kernel_sm90_{'1' * 16}.so",
             "yin": d / "yin_f0_44211260b138ccef.so", "notes": d / "notes.txt",
             "in_tree": d / "tree" / f"flash_attention_sm90_{'0' * 16}.so"}
    for f in files.values():
        f.touch()
    aot_cache._prune_stale(str(d))
    assert {k for k, f in files.items() if f.exists()} == {"cur", "cur_log", "yin", "notes",
                                                           "in_tree"}
    assert (d / "tree").is_dir()
    # once a process, and never an explicit store
    files["stale"].touch()
    aot_cache._prune_stale(str(d))
    assert files["stale"].exists()
    for explicit in ("env", "override"):
        clean.setattr(aot_cache, "_pruned", False)
        if explicit == "env":
            clean.setenv("COSY_AOT_CACHE", str(d))
        else:
            clean.delenv("COSY_AOT_CACHE")
            aot_cache.set_cache_dir(str(d))
        aot_cache._prune_stale(str(d))
        assert files["stale"].exists()


def test_load_picks_up_shipped_store(clean, tmp_path):
    """``load(model_dir=...)`` points the store at ``<model_dir>/aot_store``
    before anything else (it fails later here, on the missing checkpoints),
    as JAX's ``load`` does."""
    store = tmp_path / "aot_store"
    store.mkdir()
    with pytest.raises(Exception):
        port.load(model_dir=str(tmp_path), device="cpu")
    assert aot_cache.cache_dir() == str(store)
    assert cuda_build.library_path("int8_matmul.cu").parent == store


def _fake_nvcc(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("extern \"C\" int a() { return 0; }\n")
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    return bin_dir


def test_off_persists_nothing(clean, tmp_path):
    """With ``COSY_AOT_CACHE=off`` the library is built into a temporary
    directory of the process, outside the default and any store, and
    recorded as built; the log holds nvcc's release line and ptxas's
    report."""
    _fake_nvcc(tmp_path, clean)
    clean.setattr(aot_cache, "DEFAULT_DIR", tmp_path / "_build")
    clean.setenv("COSY_AOT_CACHE", "off")
    cuda_build.build(["a.cu"])
    lib = cuda_build.library_path("a.cu")
    assert lib.exists() and lib.parent == aot_cache.library_dir()
    assert not str(lib).startswith(str(tmp_path)) and not (tmp_path / "_build").exists()
    log = lib.with_suffix(".log").read_text()
    assert log.startswith("nvcc: Cuda compilation tools, release 12.4") and "registers" in log
    assert [name for name, _ in aot_cache.store_stats["built"]] == [lib.name]
    assert aot_cache.store_entries() == []
    shutil.rmtree(lib.parent)


def test_a_store_serves_a_process_without_nvcc(clean, tmp_path):
    """A library built into a store is found there by a later build with no
    nvcc anywhere: finding a library never runs nvcc."""
    bin_dir = _fake_nvcc(tmp_path, clean)
    store = tmp_path / "store"
    clean.setenv("COSY_AOT_CACHE", str(store))
    cuda_build.build(["a.cu"])
    assert aot_cache.store_entries() == [cuda_build.library_path("a.cu").name]
    shutil.rmtree(bin_dir)
    clean.setattr(cuda_build, "build_logs", {})
    clean.setattr(aot_cache, "store_stats", {"loaded": [], "built": []})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build._nvcc()
    cuda_build.build(["a.cu"])
    assert aot_cache.store_stats["built"] == [] and "registers" in cuda_build.build_logs["a.cu"]
