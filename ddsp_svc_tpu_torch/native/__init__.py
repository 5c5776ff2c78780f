"""The native host library: the NCCF f0 tracker and frame-RMS volume in C++.

`f0_native.cpp` is the port's own copy of the JAX package's library. It is
built at first use with the host compiler and the flags of the JAX
package's Makefile,

    g++ -O3 -march=native -ffast-math -fPIC -shared -std=c++17
        -o build/ddsp_svc_tpu_torch/f0_native-<hash>.so f0_native.cpp

and loaded with ctypes. The hash covers the source, the flags and what
-march=native means to this host's compiler (its predefined macros), so a
library built for another machine is never loaded here. A failed build or
load raises; nothing returns None for a caller to fall back on. A lock
serialises the build and the load between threads (the preprocessor
extracts from a thread pool), and the build writes a file of its own
process and renames it, so processes do not collide either. Nothing runs at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "f0_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ddsp_svc_tpu_torch"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-ffast-math", "-fPIC", "-shared",
             "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_float_p = ctypes.POINTER(ctypes.c_float)


def _run(cmd, **kw) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, **kw)


def lib_path() -> Path:
    """Where the library for this source, these flags and this host lies
    (it may not be built yet)."""
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"the host C++ compiler {CXX!r} was not found: the "
                           "native f0 library is built at first use")
    target = _run([cxx, "-march=native", "-E", "-dM", "-x", "c++", os.devnull])
    if target.returncode != 0:
        raise RuntimeError(f"{cxx} -march=native failed:\n"
                           + target.stdout.decode(errors="replace"))
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
                            + target.stdout).hexdigest()
    return BUILD_DIR / f"f0_native-{digest[:16]}.so"


def build() -> Path:
    """Compile the library unless it is there. Returns its path; raises
    with the compiler's output on failure."""
    path = lib_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        out = _run([shutil.which(CXX), *CXX_FLAGS, "-o", str(tmp),
                    str(SOURCE)])
        if out.returncode != 0:
            raise RuntimeError(f"{CXX} failed on {SOURCE.name}:\n"
                               + out.stdout.decode(errors="replace"))
        os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.extract_f0_nccf.restype = ctypes.c_int64
            lib.extract_f0_nccf.argtypes = [
                _float_p, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_double, ctypes.c_int, _float_p,
                ctypes.c_int64]
            lib.extract_volume.restype = ctypes.c_int64
            lib.extract_volume.argtypes = [
                _float_p, ctypes.c_int64, ctypes.c_double, _float_p,
                ctypes.c_int64]
            _lib = lib
        return _lib


def _signal(audio: np.ndarray, hop: float):
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    if audio.ndim != 1 or audio.size == 0:
        raise ValueError(f"expected a non-empty (T,) signal, got {audio.shape}")
    if not hop > 0:
        raise ValueError(f"hop must be positive, got {hop}")
    n_frames = int(len(audio) // hop) + 1
    return audio, np.zeros(n_frames, np.float32)


def extract_f0_native(audio: np.ndarray, sample_rate: float, hop: float,
                      f0_min: float, f0_max: float, win: int) -> np.ndarray:
    """NCCF pitch track: (T,) -> (T // hop + 1,) f0 [Hz], 0 = unvoiced.
    Frame n is the window of `win` samples centred on round(n hop)."""
    audio, out = _signal(audio, hop)
    rc = library().extract_f0_nccf(
        audio.ctypes.data_as(_float_p), len(audio), float(sample_rate),
        float(hop), float(f0_min), float(f0_max), int(win),
        out.ctypes.data_as(_float_p), len(out))
    if rc != len(out):
        raise ValueError(
            f"extract_f0_nccf refused its arguments (win {win} at {sample_rate}"
            f" Hz must exceed 8 samples and hold the lags of {f0_min}-{f0_max}"
            " Hz)")
    return out


def extract_volume_native(audio: np.ndarray, hop: float) -> np.ndarray:
    """Frame RMS: (T,) -> (T // hop + 1,), as `ops.volume.extract_volume_np`."""
    audio, out = _signal(audio, hop)
    rc = library().extract_volume(
        audio.ctypes.data_as(_float_p), len(audio), float(hop),
        out.ctypes.data_as(_float_p), len(out))
    if rc != len(out):
        raise ValueError("extract_volume refused its arguments")
    return out
