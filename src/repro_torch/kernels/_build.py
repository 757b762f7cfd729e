"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/kernels/lib<name>-<hash>.so`` at the
repository root, compiled for Hopper (``sm_90a``) at first use.  The hash
covers the source, the shared headers and the flags, so an edited source is
rebuilt and a stale library is never loaded.  The sources expose a plain C
interface (pointers, sizes and the CUDA stream as integers): no PyTorch
headers, so a build takes seconds.  :func:`build` starts one nvcc per source
at once and waits for all of them; a failed build raises with nvcc's output.
:func:`check_input`, :func:`check_devices` and :func:`check_status` are the
checks every kernel wrapper makes around its launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("fused_first_order", "fused_second_order", "sq_matmul",
           "per_sample_moment", "batch_l2", "ggn_diag", "cross_dot",
           "predictive_var", "flash_attention", "wkv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that has no current library, in parallel.

    nvcc's output (``-Xptxas -v``: registers, shared memory, spills) is kept
    beside each library as ``lib<name>.log``.
    """
    names = tuple(names)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
    procs = {}
    for n, target in todo.items():
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, target)
    failed = []
    for n, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        (BUILD_DIR / f"lib{n}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{n}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {n: library_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed.  Each
    kernel wrapper loads its library once and declares its C signatures."""
    return ctypes.CDLL(str(build((name,))[name]))


def check_input(kernel: str, name: str, x: torch.Tensor, ndim: int,
                dtypes=(torch.float32,)) -> None:
    """Raise unless ``x`` is a non-empty contiguous tensor of ``ndim``
    dimensions and one of ``dtypes`` — what every kernel here takes (the
    reductions float32 only; attention and WKV float32 or bfloat16).  The
    device is :func:`check_devices`'s, made after the wrapper has paired its
    inputs' shapes, so every other refusal holds for CPU tensors too."""
    if x.dtype not in dtypes:
        raise TypeError(f"{kernel}: {name} must be one of {dtypes}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{kernel}: {name} must have {ndim} dimensions, "
                         f"got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
    if x.numel() == 0:
        raise ValueError(f"{kernel}: {name} is empty")


def check_devices(kernel: str, **tensors) -> torch.device:
    """The one CUDA device all the named tensors lie on (None skipped);
    raise unless there is one."""
    devices = {x.device for x in tensors.values() if x is not None}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{kernel}: {', '.join(tensors)} must lie on one CUDA device, "
                         f"got {sorted(map(str, devices))}")
    return next(iter(devices))


def check_status(kernel: str, code: int) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {code}")
