"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface.  At first use it is compiled
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library in
the store of compiled artifacts (``runtime/aot_cache.py``: the package's
``_build/`` by default, listed in ``.gitignore``; ``COSY_AOT_CACHE`` or a
model directory's ``aot_store`` elsewhere), named by the card's capability
and a hash of its source, the shared ``csrc/*.cuh`` headers and the
compiler flags, and loaded with ``ctypes``.  Finding a library needs no
nvcc.  ``build`` starts one nvcc per missing source, all at once, and waits
for them.  nvcc's report (ptxas's registers, spills and shared memory per
kernel, after nvcc's release line) is kept beside each library as
``<library>.log``, so ``build_logs`` holds it whether this process compiled
the source or found it built.  No library links against libcuda: a kernel
that encodes TMA descriptors gets ``cuTensorMapEncodeTiled`` through the
CUDA runtime's entry-point lookup.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

from cosyvoice2_eu_torch.runtime import aot_cache

CSRC = Path(__file__).resolve().parent.parent / "csrc"
ARCH = "90a"
NVCC_FLAGS = ("-gencode", f"arch=compute_{ARCH},code=sm_{ARCH}", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# every kernel library, in the order chip_smoke.py and warmup build them
SOURCES = ("flash_attention_sm90.cu", "flash_attention.cu", "flash_attention_bwd.cu",
           "int8_matmul_sm90.cu", "int8_matmul_decode_sm90.cu", "int8_matmul.cu",
           "optim_passes.cu")

_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # nvcc's stderr (ptxas register/spill report) per source


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    nvcc = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "nvcc")
    if os.path.exists(nvcc):
        return nvcc
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def capability() -> str:
    """The card's compute capability as ``sm<major><minor>``; without a card,
    the one the flags build for."""
    import torch

    if torch.cuda.is_available():
        return "sm%d%d" % torch.cuda.get_device_capability()
    return "sm" + ARCH.rstrip("a")


def library_path(source: str, capability_: Optional[str] = None) -> Path:
    """The shared library of one ``csrc`` source in the store
    (``aot_cache.library_name``)."""
    return aot_cache.library_dir() / aot_cache.library_name(source, capability_ or capability())


def build(sources) -> None:
    """Compile every source whose library is missing, one nvcc each, in parallel."""
    jobs = []
    store = aot_cache.library_dir()
    for source in sources:
        out = library_path(source)
        if out.exists():
            log = out.with_suffix(".log")
            build_logs.setdefault(source, log.read_text() if log.exists() else "")
            continue
        if not jobs:
            store.mkdir(parents=True, exist_ok=True)
            aot_cache._prune_stale(str(store))
            version = subprocess.run([_nvcc(), "--version"], capture_output=True,
                                     text=True).stdout
            release = next((ln for ln in version.splitlines() if "release" in ln), "")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((source, out, tmp, proc, time.perf_counter()))
    failed = []
    for source, out, tmp, proc, t0 in jobs:
        stdout, stderr = proc.communicate()
        build_logs[source] = stderr
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source}:\n{stdout}{stderr}")
        else:
            out.with_suffix(".log").write_text(f"nvcc: {release.strip()}\n{stderr}")
            os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
            aot_cache.store_stats["built"].append((out.name, time.perf_counter() - t0))
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of one ``csrc`` source, compiled first if needed."""
    lib = _libs.get(source)
    if lib is not None:
        return lib
    build([source])
    path = library_path(source)
    t0 = time.perf_counter()
    lib = _libs[source] = ctypes.CDLL(str(path))
    if all(name != path.name for name, _ in aot_cache.store_stats["built"]):
        aot_cache.store_stats["loaded"].append((path.name, time.perf_counter() - t0))
    return lib
