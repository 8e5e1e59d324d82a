"""nvcc build and ctypes binding of the CUDA kernels in ``csrc/``.

Every ``.cu`` file compiles into ONE shared library with a plain C
interface, built on first use into ``rmi_tpu_torch/_build/`` and keyed
by a hash of the sources and flags, so a fresh checkout builds once and
an edited kernel rebuilds.  ``-fmad=false`` stops nvcc from contracting
a multiply and an add that the source leaves apart: every fused
multiply-add in the kernels is an explicit ``fma()`` (csrc/leaf_eval.cuh).

The C entry points launch on the stream they are given and return
``cudaGetLastError()``; ``launch`` raises if it is not 0, and otherwise
adds one to the entry's count in ``launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time

import torch

from rmi_tpu_torch import config

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lib = None
build_info = {}      # path, seconds (0.0 when loaded from an earlier build), log


def _sources():
    return sorted(p for p in config.CSRC_DIR.iterdir()
                  if p.suffix in (".cu", ".cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The kernel library, compiled first if this source hash has no
    build yet."""
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


def _load() -> ctypes.CDLL:
    config.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = config.BUILD_DIR / f"librmi_kernels_{_digest()}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cus = [str(p) for p in _sources() if p.suffix == ".cu"]
        cmd = [config.nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *cus]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)          # atomic: concurrent builders agree
    build_info.update(path=str(so), seconds=seconds, log=log)
    return ctypes.CDLL(str(so))


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32

# argtypes of every C entry point (csrc/*.cu)
SIGNATURES = {
    "rmi_scan_i32": (_P, _P, _I64, _I32, _I32, _I32, _P, _P),
    "rmi_aug_moments": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _P),
    "rmi_sweep_linear": (_P, _P, _P, _P, _P, _I64, _I64, _P),
    "rmi_leaf_eval_linear": (_P, _P, _P, _P, _I64, _I64, _P),
}

# successful launches per C entry point since the process started
launches = dict.fromkeys(SIGNATURES, 0)


def launch(name: str, *args) -> None:
    """Call C entry ``name`` on the current stream and count it; raise on
    a launch error.  Tensor arguments pass their device pointers."""
    fn = getattr(library(), name)
    fn.argtypes = list(SIGNATURES[name])
    fn.restype = ctypes.c_int
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        rc = fn(*conv, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    launches[name] += 1


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """All ``tensors`` contiguous and on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input")
