"""Build and bind the CUDA kernels in `scorp_tpu_torch/csrc/`.

Each source is compiled by `nvcc -gencode arch=compute_90a,code=sm_90a -O3
-fmad=false -shared -Xcompiler -fPIC` into `build/kernels/<name>-<hash>.so` at the root
of the checkout, at first use, and loaded with ctypes (a plain C interface:
pointers and the CUDA stream pass as void*, sizes as int, and each entry
point returns the cudaError_t of its launch). The hash covers the source
and the flags, so an edited source is rebuilt. `build_all` starts one nvcc
per source at once. A failed build raises; nothing falls back.

Nothing here runs at import: the CPU tests import every module, and this
machine need not have nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
# -fmad=false: no multiply-add contraction, so every kernel rounds each
# operation as its plain PyTorch version does on the same device (PyTorch
# runs them as separate elementwise ops), and kernel vs plain comparisons
# see no threshold flips from rounding alone.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# C entry points of each source and their argument kinds: p = pointer or
# stream, i = int
SIGNATURES = {
    "expand": {"scorp_expand_keys": "pppppiiiiippp"},
    "composite": {"scorp_composite": "ppppiipppppp"},
    "backward": {"scorp_composite_backward": "pppppppppppiip"},
    "surfel_composite": {
        "scorp_surfel_composite": "ppppii" + "p" * 7,
        "scorp_surfel_composite_train": "ppppii" + "p" * 12,
    },
    "surfel_backward": {"scorp_surfel_backward": "p" * 17 + "iip"},
}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    """The library's path; its hash covers the source, every header in
    csrc/ (the surfel kernels share one) and the flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Compile every source whose library is missing, one nvcc process per
    source, all started together. Returns {name: compiler output} (the
    `-Xptxas -v` register and shared-memory report) for those built."""
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((name, proc, tmp, out))
    reports, failed = {}, []
    for name, proc, tmp, out in jobs:
        text = proc.communicate()[0]
        out.with_suffix(".log").write_text(text)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
        reports[name] = text
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The bound library of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn_name, kinds in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = [ctypes.c_void_p if k == "p" else ctypes.c_int for k in kinds]
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless `t` is a contiguous tensor of this dtype/shape/device."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
