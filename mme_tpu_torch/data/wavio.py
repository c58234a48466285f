"""WAV decode + channel mean + resample: the port's native decoder through
ctypes, and a stdlib ``wave`` path.

Port of ``mme_tpu/data/wavio.py``, with its own decoder source
(``mme_tpu_torch/native/wavio.cpp``). The library is built at first use by
``g++ -O3 -march=native -ffast-math -shared -fPIC`` into
``mme_tpu_torch/_build/``: to a temporary name renamed into place, under a
lock file, so processes that start together build it once. Its name carries
a hash of the source, the flags and the target ``-march=native`` resolves
to on this CPU (``g++ -march=native -Q --help=target``), so a library built
for another CPU is never loaded and hosts with the same CPU share one. A
missing compiler or a failed build raises with the compiler's output; it
does not fall back.

The native call releases the GIL for the whole decode + resample, so
``load_waveforms_parallel`` decodes on every core from a thread pool. The
Python path (stdlib ``wave`` + ``ops/resample.py::resample_numpy``) runs for
``use_native=False`` and for a file the native decoder refuses; the latter
are counted in ``FALLBACKS``.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import wave as _wave
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mme_tpu_torch.ops.resample import resample_numpy

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(PKG_DIR, "native", "wavio.cpp")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CXX_FLAGS = ("-O3", "-march=native", "-ffast-math", "-shared", "-fPIC")

# files the native decoder returned non-zero on, decoded by the Python path
FALLBACKS = 0
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the port's WAV decoder "
                           "cannot be built")
    return cxx


@functools.lru_cache(maxsize=None)
def _native_target() -> str:
    """What ``-march=native`` means on this CPU, as the compiler says."""
    cmd = [_compiler(), "-march=native", "-Q", "--help=target"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    return proc.stdout


def library_path(build_dir: Optional[str] = None) -> str:
    digest = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    digest.update(_native_target().encode())
    with open(SOURCE, "rb") as fh:
        digest.update(fh.read())
    return os.path.join(build_dir or BUILD_DIR,
                        f"wavio-{digest.hexdigest()[:12]}.so")


def build_library(build_dir: Optional[str] = None
                  ) -> Tuple[str, Optional[List[str]]]:
    """Compile ``native/wavio.cpp`` unless its library exists. Returns
    (library path, the compiler command, or None when nothing was built)."""
    out = library_path(build_dir)
    if os.path.exists(out):
        return out, None
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)      # released when closed
        if os.path.exists(out):               # built while we waited
            return out, None
        cxx = _compiler()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
        os.close(fd)
        cmd = [cxx, *CXX_FLAGS, "-o", tmp, SOURCE]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"building the WAV decoder failed (exit {proc.returncode}): "
                f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)                  # a reader sees all or none
    return out, cmd


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library()[0])
            lib.wav_info.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_longlong)]
            lib.wav_info.restype = ctypes.c_int
            lib.wav_read_resampled.argtypes = [
                ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_longlong)]
            lib.wav_read_resampled.restype = ctypes.c_int
            _lib = lib
        return _lib


def native_available() -> bool:
    """Builds and loads the library; a failed build raises."""
    return _load_lib() is not None


def _python_read(path: str) -> Tuple[np.ndarray, int]:
    """Integer PCM of 8, 16, 24 or 32 bits through stdlib ``wave`` →
    (channel mean, sample rate)."""
    with _wave.open(path, "rb") as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        bits = w.getsampwidth() * 8
        raw = w.readframes(w.getnframes())
    if bits == 16:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif bits == 24:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
        s = (b[:, 0] << 8) | (b[:, 1] << 16) | (b[:, 2] << 24)
        x = (s >> 8).astype(np.float32) / 8388608.0
    elif bits == 32:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif bits == 8:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128) / 128.0
    else:
        raise ValueError(f"unsupported sample width {bits}")
    return x.reshape(-1, ch).mean(axis=1), sr


def load_waveform(path: str, target_sr: int = 16000,
                  max_samples: Optional[int] = None,
                  use_native: bool = True) -> np.ndarray:
    """Decode one file, average its channels and resample it to
    ``target_sr``, cut to ``max_samples``."""
    global FALLBACKS
    if use_native:
        lib = _load_lib()
        cap = max_samples if max_samples else 16000 * 600
        out = np.empty(cap, np.float32)
        out_len = ctypes.c_longlong()
        rc = lib.wav_read_resampled(
            path.encode(), target_sr,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            cap, ctypes.byref(out_len))
        if rc == 0:
            return out[:min(out_len.value, cap)].copy()
        with _lock:
            FALLBACKS += 1
    x, sr = _python_read(path)
    y = resample_numpy(x, sr, target_sr)
    if max_samples:
        y = y[:max_samples]
    return y


def load_waveforms_parallel(paths: Sequence[str], target_sr: int = 16000,
                            max_samples: Optional[int] = None,
                            workers: int = 8) -> List[np.ndarray]:
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(
            lambda p: load_waveform(p, target_sr, max_samples), paths))
