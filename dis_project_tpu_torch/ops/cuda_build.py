"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes), for
``sm_90a``. Libraries go to ``build/kernels/`` beside the package, named by
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source never loads a stale library. Builds happen at first use;
:func:`build` starts several ``nvcc`` processes at once.

Every C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; :func:`check` raises on a non-zero code.
Every source also exports ``kernel_attrs`` (:func:`kernel_attributes`).
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: dict = {}  # name -> ctypes.CDLL, per process

# int kernel_attrs(int which, const char** name, int* attrs), in every source.
_ATTRS_ARGTYPES = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and /usr/local/cuda/bin)")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names) -> float:
    """Compile every named source that has no library yet, all ``nvcc``
    processes at once; returns the seconds taken. Raises with the
    compiler's output on a failed build."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failures = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (built on first use),
    with ``argtypes``/``restype`` set from ``signatures``
    (``{symbol: [ctypes types]}``; every symbol returns a C int)."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for symbol, argtypes in {**signatures, "kernel_attrs": _ATTRS_ARGTYPES}.items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def kernel_attributes(name: str, signatures: dict) -> list:
    """``cudaFuncGetAttributes`` of every kernel in ``csrc/<name>.cu``:
    ``[(kernel, registers a thread, local bytes a thread (spills), static
    shared bytes a CTA), ...]``. Needs the card."""
    lib = load(name, signatures)
    out = []
    attrs = (ctypes.c_int * 3)()
    kernel = ctypes.c_char_p()
    while True:
        code = lib.kernel_attrs(len(out), ctypes.byref(kernel), attrs)
        if code == -1:
            return out
        check(code, f"{name}.kernel_attrs")
        out.append((kernel.value.decode(), *attrs))


def check(code: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_handle(device) -> int:
    """The current PyTorch stream on ``device`` as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream
