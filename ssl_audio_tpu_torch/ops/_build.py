"""Build and bind the port's CUDA kernels: nvcc into a shared library with a
plain C interface, loaded with ctypes.

Each source under ssl_audio_tpu_torch/csrc/ becomes build/kernels/
<name>-<hash>.so at the repository root, built on first use and keyed by a
hash of the source, the shared headers (*.cuh) and the flags, so an edited source rebuilds and an unchanged
one loads from disk.  Nothing here runs at import: the CPU tests import
every module on a machine without nvcc or a card.

Every C entry takes device pointers and the stream as void* and returns
cudaGetLastError() after its launches; `check` raises on a nonzero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("log_mel.cu", "fused_conv_fwd.cu", "fused_conv_bwd.cu", "fused_attention.cu")

_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}      # source -> nvcc output (ptxas register/spill report)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels "
                       "cannot be built on this machine")


def _target(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):    # shared device code
        h.update(header.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def _compile(source: str) -> Path:
    out = _target(source)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: concurrent builders of the
    # same source never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)],
            capture_output=True, text=True)
        build_log[source] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{build_log[source]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all() -> float:
    """Compile every kernel source, one nvcc process each, all at once.
    Returns the wall-clock seconds."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        for future in [pool.submit(_compile, s) for s in SOURCES]:
            future.result()
    return time.perf_counter() - t0


def load(source: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The ctypes library for `source`, built if needed, with argtypes set
    from `signatures` (entry name -> list of ctypes types) and an int
    (cudaError_t) result for every entry."""
    lib = _libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(_compile(source)))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[source] = lib
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({torch.cuda.get_device_name()})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# element types of the kernels' templates, as the C entries number them
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor, name: str) -> int:
    """The C entries' code of t's element type; raises for any type but
    float32 and bfloat16."""
    if t.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: want float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def count_launch(wrapper, dtype: torch.dtype) -> None:
    """One more launch on a kernel wrapper's counter for `dtype`'s
    instantiation: `launches_bf16` for bfloat16, `launches` for float32.
    Inside a CUDA graph's capture nothing launches: train/steps.py takes the
    capture's counts back off and adds them at every replay."""
    if dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


def require(t: torch.Tensor, name: str, shape: tuple, device: torch.device,
            dtype: torch.dtype = torch.float32) -> None:
    """Raise unless t is a contiguous `dtype` tensor of `shape` on `device`,
    its data 16-byte aligned (the kernels' vector loads)."""
    if t.device != device or t.dtype != dtype \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous() \
            or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: want contiguous 16-byte aligned {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()}, address {t.data_ptr():#x})")
