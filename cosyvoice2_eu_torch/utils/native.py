"""The port's host-side native library: the YIN pitch estimator.

Counterpart of ``cosyvoice2_eu_tpu/utils/native.py``.  ``csrc/yin_f0.cpp``
has a plain C interface.  At first use it is compiled with ``g++`` and the
flags of ``native/Makefile`` into a shared library under
``cosyvoice2_eu_torch/_build/`` (listed in ``.gitignore``), named by a hash
of the source, the flags and the target options ``-march=native`` resolves
to (a library built for one host's CPU is never loaded on another's), and
loaded with ``ctypes``.  The object is linked apart from the compile,
without ``-ffast-math``: linked with it, g++ adds a start file that turns
on flush-to-zero for the whole process as the library loads.  A failed
build raises: there is no fallback onto
the numpy YIN, which ``train/pitch.py`` keeps as the plain version for the
tests.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "yin_f0.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-ffast-math", "-fPIC", "-std=c++17", "-Wall")

_lock = threading.Lock()  # the pipeline's worker threads may all ask at first use
_lib: list = []


def _cxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native YIN (csrc/yin_f0.cpp) needs a C++ compiler")
    return found


def library_path() -> Path:
    """The library's path: a hash of the source, the flags and the resolved
    target options."""
    target = subprocess.run([_cxx(), "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, check=True).stdout
    key = hashlib.sha256(SOURCE.read_bytes())
    key.update(" ".join(CXX_FLAGS).encode() + target.encode())
    return BUILD_DIR / f"yin_f0_{key.hexdigest()[:16]}.so"


def load_library() -> ctypes.CDLL:
    """The loaded YIN library, compiled first if needed; raises if the build fails."""
    with _lock:
        if _lib:
            return _lib[0]
        out = library_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            obj = out.with_suffix(f".{os.getpid()}.o")
            for cmd in ([_cxx(), *CXX_FLAGS, "-c", "-o", str(obj), str(SOURCE)],
                        [_cxx(), "-shared", "-o", str(tmp), str(obj)]):
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
            obj.unlink()
            os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
        lib = ctypes.CDLL(str(out))
        lib.yin_f0.restype = ctypes.c_int
        lib.yin_f0.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib.append(lib)
        return lib


def yin_f0(wav: np.ndarray, sample_rate: int = 24000, hop: int = 480, fmin: float = 60.0,
           fmax: float = 500.0, frame_len: int = 1920, threshold: float = 0.15) -> np.ndarray:
    """wav (T,) -> f0 (T // hop,) in Hz, 0 where unvoiced, from the native YIN."""
    if hop <= 0 or frame_len <= 0 or not 0 < fmin < fmax:
        raise ValueError(f"bad YIN settings: hop {hop}, frame_len {frame_len}, "
                         f"fmin {fmin}, fmax {fmax}")
    lib = load_library()
    wav = np.ascontiguousarray(np.asarray(wav).reshape(-1), np.float32)
    out = np.zeros(len(wav) // hop, np.float32)
    lib.yin_f0(wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.c_int64(len(wav)),
               sample_rate, hop, ctypes.c_float(fmin), ctypes.c_float(fmax), frame_len,
               ctypes.c_float(threshold), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
