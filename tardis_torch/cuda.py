"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use by ``nvcc`` for Hopper (``sm_90a``) into ``build/<name>-<hash>.so``,
then loaded with ``ctypes``.  The hash covers the sources and the flags, so
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
           "vpacket_volley", "formal_integral")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", CSRC / "threefry.cuh"):
        h.update(src.read_bytes())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> float:
    """Compile every missing library, one ``nvcc`` per source, all at once.

    Returns the wall seconds spent; raises with the compiler's output if
    any build fails.  ``ptxas`` register and spill reports are kept in
    ``build/<name>.log``.
    """
    t0 = time.perf_counter()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        (BUILD / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


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
