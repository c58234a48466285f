"""Build and load the port's hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` exposes a plain C interface and compiles with
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded with
ctypes. The build happens at first use, into ``mme_tpu_torch/_build/``
(listed in ``.gitignore``); the library name carries a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source is
never served by a stale library. A missing ``nvcc`` or a failed build
raises.

``LAUNCHES`` counts, per kernel, the launches its wrapper made since the
last :func:`reset_launches`; a wrapper adds one where it launches its kernel
and nowhere else, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable, List

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the port's CUDA kernels cannot be built")
    return path


def library_path(name: str) -> str:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no current library, one
    ``nvcc`` per source, all started together. Returns each source's
    compiler output (``-Xptxas -v``: registers, shared memory, spills);
    empty for a source whose library was already built."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs: List = []
    logs: Dict[str, str] = {}
    for name in names:
        out = library_path(name)
        logs[name] = ""
        if os.path.exists(out):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n"
                          f"{logs[name]}")
        else:
            os.replace(tmp, out)        # atomic: a reader sees all or none
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        _LIBS[name] = lib
    return lib
