"""Build and load the hand-written CUDA kernels.

Each source in `ddsp_svc_tpu_torch/csrc/` compiles on its own with nvcc
into a shared library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/ddsp_svc_tpu_torch/<name>-<hash>.so <name>.cu

The library name carries a hash of the source, of the csrc/ headers it
includes (directly or through another header) and of the flags, so an
edited source or header rebuilds every library that depends on it and an
unchanged one loads from the build directory. All missing libraries build
at first use, one nvcc process per source, started together. Nothing here
runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ddsp_svc_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("performer_attention", "combsub_spectral", "combsub_spectral_bwd",
           "harmonic_source", "resblocks", "dft_magnitude", "oscillator_bank",
           "ltv_fir_convolve", "resblock_chain", "fused_stage")
_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def _local_sources(name: str) -> Iterable[bytes]:
    """csrc/<name>.cu and every csrc header it includes with quotes, directly
    or through another header, each once, in the order first included."""
    seen, todo = set(), [f"{name}.cu"]
    while todo:
        file = todo.pop(0)
        if file in seen:
            continue
        seen.add(file)
        text = (CSRC / file).read_bytes()
        yield text
        todo.extend(h.decode() for h in _LOCAL_INCLUDE.findall(text))


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(b"".join(_local_sources(name))
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every named source whose library is missing, all at once.
    Returns the wall seconds spent; raises with nvcc's output on failure."""
    todo = [(n, _lib_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not p.exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for name, path in todo:
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, path, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out.decode(errors='replace')}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib
