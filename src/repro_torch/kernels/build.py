"""Build and load the CUDA kernels (``kernels/csrc/*.cu``).

Each source is compiled on first use with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes).  Libraries
land in ``build/repro_torch/`` at the repository root, named by a hash of
the sources and flags, so an edited source is never served a stale
library.  :func:`build` starts one ``nvcc`` per missing library, all at
once, and waits for all of them.

Every C entry point returns ``cudaGetLastError()`` after its launch
(``cudaErrorInvalidValue`` for arguments it refuses); :func:`check`
raises on anything but 0.  Kernels run on the caller's current stream
and allocate nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Any, Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("quantized_gather", "codebook_matmul_packed",
           "codebook_matmul_packed_t", "blockwise_prefill", "page_gather",
           "paged_attention", "blockwise_prefill_quant",
           "paged_attention_quant", "codebook_matmul", "mla_paged_attention",
           "mla_paged_attention_quant", "kmeans_assign", "fixed_quant")
HEADERS = ("unpack.cuh", "online_softmax.cuh", "mla_attention.cuh",
           "codebook_mma.cuh", "split_decode.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[str, Any] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels are built on the "
                           "machine with the card")
    return found


def library_path(name: str) -> Path:
    """Target of one source: content hash of the source, the shared
    headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu",) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library among ``names`` in parallel.

    Returns ``{name: compiler output}`` (``-Xptxas -v``: registers, shared
    memory, spills per kernel) for the libraries built by this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        if name not in SOURCES:
            raise KeyError(f"unknown kernel source {name!r}")
        target = library_path(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{out}")
            os.unlink(tmp)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def function(name: str, symbol: str, argtypes: Sequence) -> Any:
    """The C entry point ``symbol`` of library ``name`` (built on first
    use), with its ``argtypes`` set and an int (cudaError_t) result."""
    key = f"{name}:{symbol}"
    fn = _FUNCS.get(key)
    if fn is None:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[key] = fn
    return fn


def check(err: int, name: str) -> None:
    """Raise if a C entry point of library ``name`` returned an error."""
    if err != 0:
        text = _LIBS[name].repro_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: error {err} ({text})")


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device`` as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream


def codebook(cb, device):
    """Check a kernel's codebook operand: [K <= 256] f32 on ``device``."""
    if cb.ndim != 1 or cb.shape[0] > 256:
        raise ValueError(f"codebook must be [K<=256], got {tuple(cb.shape)}")
    return operand(cb, "codebook", torch.float32, device)


def operand(t, name: str, dtype, device):
    """Check one kernel operand: on ``device``, of ``dtype``, contiguous
    (a kernel reads raw memory with the strides of a dense tensor)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, kernel runs on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t
