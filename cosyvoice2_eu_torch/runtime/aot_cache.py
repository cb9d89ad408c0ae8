"""The port's store of compiled artifacts: the kernel libraries nvcc builds.

Counterpart of ``cosyvoice2_eu_tpu/runtime/aot_cache.py``.  The JAX package
serializes compiled XLA executables so that a fresh process skips tracing
and compiling.  The port runs eagerly: it has no executable to keep, and
its cold start is nvcc building each ``csrc/*.cu`` kernel library at first
use (``ops/cuda_build.py``).  So this store holds those libraries, each
beside the ``.log`` that nvcc wrote for it (ptxas's report and nvcc's
release line), named

    <source stem>_<capability>_<salt>.so   e.g. int8_matmul_sm90_0123456789abcdef.so

``_source_salt(source)`` hashes the bytes of the source, of every
``csrc/*.cuh`` header and of ``NVCC_FLAGS``: the same bytes on another
machine give the same name, so a store shipped with a model keeps hitting,
and an edit to a source or a header rebuilds what it reaches.  The
capability is that of the card (``sm90`` on an H100).  nvcc's version is
not in the name, as JAX leaves its own version out of its key: a process
on a shipped store may have no nvcc at all, and finding a library never
runs it.

The directory (``cache_dir``), by JAX's precedence: ``COSY_AOT_CACHE`` when
it is set; else the directory ``set_cache_dir`` gave (``load()`` sets
``<model_dir>/aot_store`` when the model directory ships one); else the
package's ``_build/``.  ``off``, ``0``, ``none`` or the empty string turn
persistence off: the libraries are built into a temporary directory of the
process, removed at exit, and nothing is reused.  Only the implicit
``_build/`` is pruned of libraries of other salts, and only of files whose
names match the store's pattern.

JAX's ``AotFunction`` and ``aot_jit`` have no counterpart: the port has no
jitted program to wrap (``ROADMAP.md`` §3).
"""

from __future__ import annotations

import atexit
import hashlib
import os
import re
import shutil
import tempfile
from pathlib import Path
from typing import Optional

DEFAULT_DIR = Path(__file__).resolve().parent.parent / "_build"
# libraries found in the store (``loaded``) and built by nvcc in this
# process (``built``), each as (library file, seconds)
store_stats: dict = {"loaded": [], "built": []}
_NAME = re.compile(r"^(?P<stem>\w+)_(?P<cap>sm\d+)_(?P<salt>[0-9a-f]{16})\.(?:so|log)$")
_OFF = ("off", "0", "none", "")

_cache_dir_override: Optional[str] = None
_process_dir: Optional[str] = None
_pruned = False


def set_cache_dir(path: Optional[str]) -> None:
    """Point the store at ``path`` (None: back to the default);
    ``COSY_AOT_CACHE`` still wins."""
    global _cache_dir_override
    _cache_dir_override = path


def cache_dir() -> Optional[str]:
    """The store's directory, or None when persistence is off."""
    val = os.environ.get("COSY_AOT_CACHE")
    if val is None:
        val = _cache_dir_override or str(DEFAULT_DIR)
    if val.lower() in _OFF:
        return None
    return val


def library_dir() -> Path:
    """Where libraries are built and looked for: the store, or with
    persistence off a temporary directory of this process."""
    global _process_dir
    d = cache_dir()
    if d is not None:
        return Path(d)
    if _process_dir is None:
        _process_dir = tempfile.mkdtemp(prefix="cosy_kernels_")
        atexit.register(shutil.rmtree, _process_dir, True)
    return Path(_process_dir)


def _source_salt(source: str) -> str:
    """Content hash of what one library is built from: the source, every
    ``csrc/*.cuh`` header (a source may include any of them) and the flags."""
    from cosyvoice2_eu_torch.ops import cuda_build

    key = hashlib.sha256((cuda_build.CSRC / source).read_bytes())
    for header in sorted(cuda_build.CSRC.glob("*.cuh")):
        key.update(header.name.encode() + header.read_bytes())
    key.update(" ".join(cuda_build.NVCC_FLAGS).encode())
    return key.hexdigest()[:16]


def library_name(source: str, capability: str) -> str:
    return f"{Path(source).stem}_{capability}_{_source_salt(source)}.so"


def store_entries(d: Optional[str] = None) -> list:
    """The libraries in the store (``cache_dir()`` by default)."""
    d = d if d is not None else cache_dir()
    if d is None or not os.path.isdir(d):
        return []
    return sorted(f for f in os.listdir(d) if f.endswith(".so") and _NAME.match(f))


def _prune_stale(d: str) -> None:
    """Drop libraries (and their logs) of other salts from the implicit
    default directory, once a process; an explicit store (``COSY_AOT_CACHE``
    or ``set_cache_dir``) may serve several versions and is left alone, and
    files not named by the store's pattern are never touched."""
    from cosyvoice2_eu_torch.ops import cuda_build

    global _pruned
    if _pruned:
        return
    _pruned = True
    if os.environ.get("COSY_AOT_CACHE") or _cache_dir_override:
        return
    try:
        names = os.listdir(d)
    except OSError:
        return
    for fname in names:
        m = _NAME.match(fname)
        if m is None:
            continue
        source = m["stem"] + ".cu"
        if (cuda_build.CSRC / source).exists() and m["salt"] == _source_salt(source):
            continue
        try:
            os.remove(os.path.join(d, fname))
        except OSError:
            pass
