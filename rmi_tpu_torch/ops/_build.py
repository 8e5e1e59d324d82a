"""nvcc build and ctypes binding of the CUDA kernels in ``csrc/``.

Every ``.cu`` file compiles to an object with its own ``nvcc``, all
started together, and the objects link into ONE shared library with a
plain C interface, built on first use into ``rmi_tpu_torch/_build/`` and
keyed by a hash of the sources and flags, so a fresh checkout builds
once and an edited kernel rebuilds.  ``-fmad=false`` stops nvcc from
contracting a multiply and an add that the source leaves apart: every
fused multiply-add in the kernels is an explicit ``fma()``
(csrc/leaf_eval.cuh).

The C entry points launch on the stream they are given and return
``cudaGetLastError()``; ``launch`` raises if it is not 0, and otherwise
adds one to the entry's count in ``launches``.  Each entry's ctypes
function is resolved once, with its argument types, and a launch enters
the tensors' device only when it is not the current one: the host cost
of a launch is what a kernel of a few microseconds is timed at
(PERF.md section 6, the probes).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

from rmi_tpu_torch import config

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")

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
        t0 = time.perf_counter()
        log = _compile(so)
        seconds = time.perf_counter() - t0
    build_info.update(path=str(so), seconds=seconds, log=log)
    return ctypes.CDLL(str(so))


def _compile(so) -> str:
    """One nvcc per .cu file, all running at once, then one link into
    ``so``; returns the compilers' output.  Raises if any step fails."""
    nvcc = config.nvcc_path()
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    obj_dir = so.with_name(f"{so.stem}.{os.getpid()}.obj")
    obj_dir.mkdir()
    try:
        jobs = []
        for cu in (p for p in _sources() if p.suffix == ".cu"):
            obj = obj_dir / f"{cu.stem}.o"
            jobs.append((cu.name, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = "", []
        for name, _, proc in jobs:
            out = proc.communicate()[0]
            log += out
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode})")
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                               *(str(obj) for _, obj, _ in jobs)],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
        os.replace(tmp, so)          # atomic: concurrent builders agree
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)
    return log


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_F64 = ctypes.c_double

# argtypes of every C entry point (csrc/*.cu)
SIGNATURES = {
    "rmi_scan_i32": (_P, _P, _I64, _I32, _I32, _I32, _P, _P),
    "rmi_aug_moments": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _P),
    "rmi_aug_moments_weighted": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P),
    "rmi_aug_moments_xx": (_P, _P, _P, _P, _P, _I64, _P),
    "rmi_sweep_max_linear": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P),
    "rmi_sweep_max_cubic": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P),
    "rmi_sweep_max_loglinear": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P),
    "rmi_sweep_max_normal": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P),
    "rmi_span_run_max": (_P, _P, _P, _P, _P, _I64, _I64, _P),
    "rmi_leaf_eval_linear": (_P, _P, _P, _P, _I64, _I64, _P),
    "rmi_leaf_eval_cubic": (_P, _P, _P, _P, _I64, _I64, _P),
    "rmi_leaf_eval_loglinear": (_P, _P, _P, _P, _I64, _I64, _P),
    "rmi_leaf_eval_normal": (_P, _P, _P, _P, _I64, _I64, _P),
    "rmi_lookup_linear": (_P, _P, _I64, _P, _P, _P, _I64, _I64, _I64, _F64, _F64, _P),
    "rmi_lookup_cubic": (_P, _P, _I64, _P, _P, _P, _I64, _I64, _I64, _F64, _F64, _P),
    "rmi_lookup_loglinear": (_P, _P, _I64, _P, _P, _P, _I64, _I64, _I64, _F64, _F64, _P),
    "rmi_lookup_normal": (_P, _P, _I64, _P, _P, _P, _I64, _I64, _I64, _F64, _F64, _P),
    "rmi_cubic_l1": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _P),
    "rmi_serve_sorted": (_P, _I64, _P, _I64, _P, _I64, _P, _P, _I64, _I64, _P, _P),
    "rmi_serve_sorted_scatter": (_P, _P, _I64, _P, _I64, _P, _I64, _P, _P, _I64, _I64,
                                 _P, _P),
    "rmi_probe_scale2": (_P, _P, _I64, _P),
    "rmi_probe_lt_i64": (_P, _P, _P, _I64, _P),
    "rmi_probe_lt_u64": (_P, _P, _P, _I64, _P),
    "rmi_probe_lt_u32pair": (_P, _P, _P, _P, _P, _I64, _P),
    "rmi_probe_gather_rows": (_P, _P, _P, _I64, _I64, _I64, _P),
    "rmi_probe_take": (_P, _P, _P, _I64, _I64, _P),
    "rmi_probe_take_lanes": (_P, _P, _P, _I64, _I64, _P),
    "rmi_probe_row_ring": (_P, _I64, _I64, _I64, _I64, _I64, _P, _P),
    "rmi_probe_row_copy": (_P, _P, _P, _I64, _I64, _P),
}

# successful launches per C entry point since the process started
launches = dict.fromkeys(SIGNATURES, 0)


_entries = {}         # entry name -> its ctypes function, argtypes set
_C = torch._C


def _entry(name: str):
    fn = getattr(library(), name)
    fn.argtypes = list(SIGNATURES[name])
    fn.restype = ctypes.c_int
    _entries[name] = fn
    return fn


def launch(name: str, *args) -> None:
    """Call C entry ``name`` on the current stream of the card that its
    first argument, a tensor, lies on, and count it; raise on a launch
    error.  Tensor arguments pass their device pointers."""
    fn = _entries.get(name) or _entry(name)
    dev = args[0].get_device()
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    # the current stream's handle and device, as torch's generated kernels
    # fetch them
    stream = _C._cuda_getCurrentRawStream(dev)
    if dev == _C._cuda_getDevice():
        rc = fn(*conv, stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*conv, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    launches[name] += 1


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """All ``tensors`` contiguous and on one CUDA device."""
    dev = tensors[0].get_device()
    for t in tensors:
        if t.get_device() != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {tensors[0].device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input")
