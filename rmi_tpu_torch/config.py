"""The device a measurement runs on, and where the kernels are built.

The port has no global numeric switches: torch computes f64 natively
on both the CPU and the card, so there is nothing like JAX's x64 flag
or compile cache to set.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"


def require_cuda() -> torch.device:
    """The card, or an error: measurement paths never fall back to the
    CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this path needs the card")
    return torch.device("cuda", torch.cuda.current_device())


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def cxx_path() -> str:
    """The host compiler the kernel binding is built with: $CXX, else
    ``c++`` on PATH."""
    found = shutil.which(os.environ.get("CXX") or "c++")
    if found:
        return found
    raise RuntimeError("no host C++ compiler found (set CXX or put c++ on PATH)")
