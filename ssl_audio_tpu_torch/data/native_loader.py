"""The C++ batch readers, bound with ctypes (port of
ssl_audio_tpu/data/native_loader.py).

The sources are the port's own csrc/npy_batch_loader.cc and
csrc/wav_batch_loader.cc (byte for byte the JAX package's readers, so the
batches are the same bits).  Each is built with g++ on first use into build/native/<name>-<hash>.so at
the repository root, keyed by a hash of the source and the flags, under a
temporary name and then renamed, so processes that build at once never load
a half-written library.  A failed build raises with the compiler's output:
there is no fallback to the Python path.

`NativeBatchReader` makes a whole (B, 1, n_mels, crop_frames) normalised
batch of `.npy` log-mels, `NativeWavReader` a (B, unit_length) batch of
mono waveforms, each in a C++ thread pool behind one ctypes call, which
releases the interpreter lock.  Both write into a caller's float32 array
where one is given (a pinned host buffer), else into a new one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional

import numpy as np

REPO = Path(__file__).resolve().parents[2]
NATIVE_SRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = REPO / "build" / "native"
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_c_float_p = ctypes.POINTER(ctypes.c_float)
SIGNATURES = {
    "npy_batch_loader.cc": ("read_npy_batch", [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_ulonglong, ctypes.c_int, _c_float_p]),
    "wav_batch_loader.cc": ("read_wav_batch", [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_ulonglong, ctypes.c_int, _c_float_p]),
}

_libs: dict[str, ctypes.CDLL] = {}


def library_path(source: str) -> Path:
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS]).encode())
    h.update((NATIVE_SRC / source).read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """The shared library of csrc/`source`, compiled if it is not built
    yet.  RuntimeError with the compiler's output when the build fails."""
    out = library_path(source)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [CXX, *CXX_FLAGS, str(NATIVE_SRC / source), "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot build csrc/{source}: {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed on csrc/{source} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(source: str) -> ctypes.CDLL:
    """The ctypes library of csrc/`source`, built if needed, its entry's
    argtypes and int result set."""
    lib = _libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        name, argtypes = SIGNATURES[source]
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[source] = lib
    return lib


def _out_buffer(out: Optional[np.ndarray], shape: tuple) -> np.ndarray:
    if out is None:
        return np.empty(shape, np.float32)
    if out.dtype != np.float32 or out.shape != shape or not out.flags.c_contiguous \
            or not out.flags.writeable:
        raise ValueError(f"out: want a writeable C-contiguous float32 array of {shape}, got "
                         f"{out.dtype} {out.shape} (contiguous={out.flags.c_contiguous})")
    return out


def _c_paths(paths: List[str]):
    return (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])


class NativeBatchReader:
    """`.npy` log-mel paths -> normalised (B, 1, n_mels, crop_frames): each
    file cropped at a start drawn from the batch seed and its position (or
    padded with the normalised zero), (x - mean) / std."""

    def __init__(self, n_mels: int, crop_frames: int, mean: float, std: float,
                 n_threads: int = 8):
        self.lib = load("npy_batch_loader.cc")
        self.n_mels = n_mels
        self.crop_frames = crop_frames
        self.mean = float(mean)
        self.inv_std = 1.0 / float(std)
        self.n_threads = n_threads

    def read(self, paths: List[str], seed: int = 0,
             out: Optional[np.ndarray] = None) -> np.ndarray:
        """IOError naming the first file that could not be read."""
        out = _out_buffer(out, (len(paths), 1, self.n_mels, self.crop_frames))
        c_paths = _c_paths(paths)
        rc = self.lib.read_npy_batch(c_paths, len(paths), self.n_mels, self.crop_frames,
                                     self.mean, self.inv_std, seed, self.n_threads,
                                     out.ctypes.data_as(_c_float_p))
        if rc != 0:
            raise IOError(f"native loader failed on {paths[rc - 1]}")
        return out


class NativeWavReader:
    """wav paths -> (B, unit_length) float32 mono waveforms: channels
    averaged, zero-padded at both ends or cropped at a start drawn from the
    batch seed and the position (the AudioSetWav item, in C++)."""

    def __init__(self, unit_length: int, sample_rate: int, n_threads: int = 8):
        self.lib = load("wav_batch_loader.cc")
        self.unit_length = int(unit_length)
        self.sample_rate = int(sample_rate)
        self.n_threads = n_threads

    def read(self, paths: List[str], seed: int = 0,
             out: Optional[np.ndarray] = None) -> np.ndarray:
        """IOError naming the first file that could not be read (or is not
        at sample_rate)."""
        out = _out_buffer(out, (len(paths), self.unit_length))
        c_paths = _c_paths(paths)
        rc = self.lib.read_wav_batch(c_paths, len(paths), self.unit_length, self.sample_rate,
                                     seed, self.n_threads, out.ctypes.data_as(_c_float_p))
        if rc != 0:
            raise IOError(f"native wav loader failed on {paths[rc - 1]}")
        return out
