"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface.  At first use it is compiled
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library
under ``cosyvoice2_eu_torch/_build/`` (listed in ``.gitignore``), named by a
hash of its source, the shared ``csrc/*.cuh`` headers and the compiler
flags, and loaded with ``ctypes``.
``build`` starts one nvcc per missing source, all at once, and waits for
them.  nvcc's report (ptxas's registers, spills and shared memory per
kernel) is kept beside each library as ``<library>.log``, so ``build_logs``
holds it whether this process compiled the source or found it built.  No
library links against libcuda: a kernel that encodes TMA descriptors gets
``cuTensorMapEncodeTiled`` through the CUDA runtime's entry-point lookup.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # nvcc's stderr (ptxas register/spill report) per source


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(source: str) -> Path:
    """The shared library of one ``csrc`` source, named by the hash of the
    source, every ``csrc/*.cuh`` header (a source may include any of them)
    and the flags."""
    key = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.name.encode() + header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}_{key.hexdigest()[:16]}.so"


def build(sources) -> None:
    """Compile every source whose library is missing, one nvcc each, in parallel."""
    jobs = []
    for source in sources:
        out = library_path(source)
        if out.exists():
            log = out.with_suffix(".log")
            build_logs.setdefault(source, log.read_text() if log.exists() else "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((source, out, tmp, proc))
    failed = []
    for source, out, tmp, proc in jobs:
        stdout, stderr = proc.communicate()
        build_logs[source] = stderr
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source}:\n{stdout}{stderr}")
        else:
            out.with_suffix(".log").write_text(stderr)
            os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of one ``csrc`` source, compiled first if needed."""
    lib = _libs.get(source)
    if lib is not None:
        return lib
    build([source])
    lib = _libs[source] = ctypes.CDLL(str(library_path(source)))
    return lib
