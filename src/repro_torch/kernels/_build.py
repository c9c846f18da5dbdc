"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``kernels/csrc/<name>.cu`` compiles on its own into a shared library
with a plain C interface, ``build/repro_torch/<name>-<hash>.so`` under the
repository root (a directory git ignores).  The hash covers the source,
the headers beside it and the flags, so an edit rebuilds.  Nothing runs
``nvcc`` at import: the first launch of a kernel builds it, and
:func:`build` compiles several sources at once, one ``nvcc`` process each,
all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("pair_count", "histogram", "segment_reduce", "ordered_histogram",
           "segmented_scan", "semiring", "flash_attention", "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> {"seconds": wall time until the build was reaped, "ptxas": the
# compiler's -Xptxas -v report, "cached": True when no compile was needed}
build_log: dict[str, dict] = {}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "build only on a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every named source that is not built yet, in parallel.

    Returns ``build_log`` entries for ``names``.  Raises with the compiler's
    output if any build fails; every ``nvcc`` started is waited for or killed.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    try:
        for name in names:
            so = library_path(name)
            if so.exists():
                build_log[name] = {"seconds": 0.0, "ptxas": "", "cached": True}
                continue
            nvcc = nvcc or nvcc_path()
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, so)
        for name, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu "
                                   f"(exit {proc.returncode}):\n{out}")
            os.replace(tmp, so)
            build_log[name] = {"seconds": time.perf_counter() - t0,
                               "ptxas": out.strip(), "cached": False}
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return {name: build_log[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                build((name,))
                lib = ctypes.CDLL(str(library_path(name)))
                lib.repro_error_string.argtypes = [ctypes.c_int]
                lib.repro_error_string.restype = ctypes.c_char_p
                _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s card."""
    return torch.cuda.current_stream(t.device).cuda_stream
