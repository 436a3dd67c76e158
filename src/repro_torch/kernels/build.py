"""Build the CUDA sources of ``repro_torch/csrc`` with nvcc and load them.

Each source compiles into its own shared library with a plain C interface
(loaded with ``ctypes``), under ``build/repro_torch/`` at the repository root.
The library's file name carries a hash of the source and the flags, so a
changed source is rebuilt and an unchanged one is reused.  :func:`build`
starts one nvcc per missing library, all at once, and waits for them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Sequence

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), "build", "repro_torch")

_COMMON = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC"]
#: per-source flags: the replay's float64 clock chain must never be
#: contracted into FMAs (the reference engines round every product)
FLAGS: Dict[str, List[str]] = {
    "lane_replay": _COMMON + ["--fmad=false"],
    "hlsh_attention": _COMMON,
    "int4_matmul": _COMMON,
    "flash_attention": _COMMON,
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(FLAGS[name]).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{tag[:16]}.so")


def build(names: Sequence[str] = tuple(FLAGS)) -> Dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one nvcc
    process each, all started together.  Returns name -> library path."""
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = f"{paths[n]}.{os.getpid()}.tmp"
        cmd = [nvcc, *FLAGS[n], "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT))
    errors = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {n}.cu failed ({proc.returncode}):\n"
                          + out.decode(errors="replace"))
            continue
        os.replace(tmp, paths[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name])
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code (each library exports
    ``error_string`` for ``cudaGetErrorString``)."""
    if err != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


#: PyTorch's raw handle of a device's current stream (what its own kernel
#: launchers read), where the build has it: it spares the Python stream
#: object that ``torch.cuda.current_stream(device)`` builds on every call
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_handle(device: torch.device) -> int:
    """The handle of ``device``'s current CUDA stream, for a launch."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(device.index)
    return torch.cuda.current_stream(device).cuda_stream
