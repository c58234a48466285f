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

Every wrapper launches the same way: :func:`entry` gives the C entry point
with its argument types set on the first call only, and
:func:`launch_context` the current stream, with a device guard only when the
tensor is not on the current device.

The forward wrappers on the serving path (K1, K4a, K5a) are also operators
of the ``mme_tpu_torch`` namespace (:func:`define_op`), so that
``torch.export`` records them by name: a ctypes launch reads
``data_ptr()``, which a traced (fake) tensor does not have. Each operator
has the wrapper as its CPU and CUDA kernel and a fake implementation that
gives the outputs' shapes, dtypes and strides. They are registered with
``torch.library.Library`` directly rather than ``torch.library.custom_op``:
the same schema, fake and name, without the Python layer that
``custom_op`` adds to every call (its host cost is in ``PERF.md``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {}
OPS = torch.library.Library("mme_tpu_torch", "FRAGMENT")
_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[Tuple[str, str], Callable] = {}


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


def entry(name: str, symbol: str, argtypes: Sequence) -> Callable:
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, returning an
    int; its library is built and its argument types set on the first call
    only."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _ENTRIES[(name, symbol)] = fn
    return fn


def launch_context(dev: torch.device):
    """(device guard, current stream of `dev` as a raw handle): no guard
    when `dev` is the current device already. The handle is read with
    ``torch._C._cuda_getCurrentRawStream`` (as PyTorch's own Triton
    launches do): ``torch.cuda.current_stream()`` builds a Stream object,
    several µs of host time per launch."""
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    guard = (contextlib.nullcontext() if index == current
             else torch.cuda.device(index))
    return guard, torch._C._cuda_getCurrentRawStream(index)


def define_op(schema: str, impl: Callable, fake: Callable):
    """Registers the operator ``mme_tpu_torch::<schema>`` with ``impl`` as
    its CPU and CUDA kernel and ``fake`` as its implementation for traced
    tensors; returns its overload (``torch.ops.mme_tpu_torch.<name>.default``).
    No autograd kernel: the callers differentiate through their own
    ``torch.autograd.Function``."""
    name = schema.split("(", 1)[0]
    OPS.define(schema)
    for key in ("CPU", "CUDA"):
        OPS.impl(name, impl, key)
    torch.library.register_fake(f"mme_tpu_torch::{name}", fake, lib=OPS)
    return getattr(torch.ops.mme_tpu_torch, name).default
