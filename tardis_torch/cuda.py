"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use by ``nvcc`` for Hopper (``sm_90a``) into ``build/<name>-<hash>.so``,
then loaded with ``ctypes``.  A kernel with compile-time options (K1,
K4, K6, K7) is built once per combination it is asked for, each with its
``-D`` flags (``defines``).  The hash covers the sources, the flags and the defines, so
an edited kernel is rebuilt and a stale library is never loaded.  Every
kernel is compiled with ``--fmad=false``: eager PyTorch does not contract
``a*b+c`` into a fused multiply-add, so without the flag a kernel and its
plain version would round differently and near-ties would flip.

Nothing here runs at import time; the CPU tests import every module.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
KERNELS = ("line_tables", "blackbody_source", "transport_loop",
           "vpacket_volley", "formal_integral", "nonhom_loop", "gamma_step",
           "probe2")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[tuple, ctypes.CDLL] = {}
_functions: dict[tuple, object] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name: str, defines: tuple = ()) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build(libraries) -> float:
    """Compile every missing library of ``libraries``, (kernel name,
    defines) pairs, one ``nvcc`` per library, all at once.

    Returns the wall seconds spent; raises with the compiler's output if
    any build fails.  ``ptxas`` register and spill reports are kept in
    ``build/<library>.log``.
    """
    t0 = time.perf_counter()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, defines in dict.fromkeys((n, tuple(d)) for n, d in libraries):
        out = library_path(name, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
               str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{out.name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded kernel library ``name`` built with ``defines``, built
    first if needed."""
    key = (name, tuple(defines))
    lib = _loaded.get(key)
    if lib is None:
        build((key,))
        lib = ctypes.CDLL(str(library_path(name, defines)))
        _loaded[key] = lib
    return lib


def function(name: str, symbol: str, argtypes, defines: tuple = ()):
    """The C function ``symbol`` of library ``name`` built with ``defines``,
    its argument types set once, when it is first asked for (a wrapper
    that sets them on every call spends host time on each launch)."""
    key = (name, tuple(defines), symbol)
    fn = _functions.get(key)
    if fn is None:
        fn = getattr(library(name, defines), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _functions[key] = fn
    return fn


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> int:
    """The current CUDA stream of the current device, as an address (the
    raw query: ``torch.cuda.current_stream()`` builds a Python stream
    object, which costs a short kernel's wrapper more host time than its
    launch)."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def check_cuda(name: str, device: torch.device, **tensors) -> None:
    """Each ``arg=(tensor, dtype)`` contiguous, of that dtype and on
    ``device``; raise otherwise (a kernel reads raw pointers)."""
    for arg, (t, dtype) in tensors.items():
        if (t.device != device or t.dtype != dtype
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: {arg} must be a contiguous {dtype} tensor on "
                f"{device}, got {t.dtype} on {t.device} "
                f"contiguous={t.is_contiguous()}"
            )


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for another device; no fallback."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tardis_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
