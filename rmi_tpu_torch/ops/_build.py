"""Build and binding of the CUDA kernels in ``csrc/``.

Every ``.cu`` file compiles to an object with its own ``nvcc`` and the
binding (``csrc/binding.cpp``) with the host compiler against torch's
headers, all started together; the objects link into ONE Python
extension module, built on first use into ``rmi_tpu_torch/_build/`` and
keyed by a hash of the sources, the flags and the torch and Python it
was built for, so a fresh checkout builds once and an edited kernel
rebuilds.  ``-fmad=false`` stops nvcc from contracting a multiply and an
add that the source leaves apart: every fused multiply-add in the
kernels is an explicit ``fma()`` (csrc/leaf_eval.cuh).

The C entry points (``csrc/entries.h``; ``SIGNATURES`` here) launch on
the stream they are given and return ``cudaGetLastError()``.
``launch(name, *args)`` is the binding's: one call from Python per
launch, which converts each argument by its C parameter's type, checks
that every tensor is contiguous and on one CUDA device (ValueError),
allocates the outputs given as shapes, launches on that device's current
stream, raises if the entry returns nonzero and otherwise adds one to
the entry's count in ``launches`` (csrc/binding.cpp says how).  The
binding needs the host compiler, torch's headers and libraries and
Python's ``Python.h``; a build that fails raises, and nothing falls back
to another binding.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import re
import shutil
import subprocess
import sys
import sysconfig
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from rmi_tpu_torch import config

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC")
BINDING = "binding.cpp"
MODULE = "rmi_kernels"            # the extension's name (PyInit_rmi_kernels)
TORCH_LIBS = ("c10", "c10_cuda", "torch", "torch_cpu", "torch_cuda", "torch_python")

_ext = None
build_info = {}      # path, seconds (0.0 when loaded from an earlier build), log


def _signatures() -> dict:
    """name -> parameter types of every C entry, read from entries.h."""
    text = (config.CSRC_DIR / "entries.h").read_text()
    return {name: tuple(" ".join(p.split()[:-1]) for p in params.split(","))
            for name, params in re.findall(r"^RMI_ENTRY\((\w+),\s*\(([^)]*)\)\)", text,
                                           re.MULTILINE)}


# parameter types of every C entry point, in entries.h's order
SIGNATURES = _signatures()

# successful launches per C entry point since the process started
launches = dict.fromkeys(SIGNATURES, 0)


def _sources():
    return sorted(p for p in config.CSRC_DIR.iterdir()
                  if p.suffix in (".cu", ".cuh", ".h", ".cpp"))


def _digest() -> str:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *CXX_FLAGS, torch.__version__,
                                 sys.version)).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library():
    """The kernels' extension module, compiled first if this source hash
    has no build yet."""
    global _ext, launch
    if _ext is None:
        _ext = _load()
        _ext.set_counts(launches)
        launch = _ext.launch
    return _ext


def launch(name: str, *args):
    """Call C entry ``name`` (module docstring).  This Python function
    stands in until the first call, which builds the library and puts the
    binding's own ``launch`` in its place."""
    if name not in SIGNATURES:
        raise ValueError(f"unknown C entry point {name!r}")
    return library().launch(name, *args)


def _load():
    config.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = config.BUILD_DIR / f"{MODULE}_{_digest()}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        t0 = time.perf_counter()
        log = _compile(so)
        seconds = time.perf_counter() - t0
    build_info.update(path=str(so), seconds=seconds, log=log)
    loader = importlib.machinery.ExtensionFileLoader(MODULE, str(so))
    spec = importlib.util.spec_from_file_location(MODULE, str(so), loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module


def python_include() -> str:
    """The directory of Python.h, which the binding compiles against."""
    inc = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(inc, "Python.h")):
        raise RuntimeError(f"Python.h not found in {inc}: the kernel binding "
                           f"needs Python's development headers")
    return inc


def commands(nvcc: str, cxx: str, obj_dir, out) -> tuple:
    """([(source, compile command)], link command): one nvcc per .cu file
    and one host compiler run for the binding, their objects in
    ``obj_dir``, then one link into the extension ``out``."""
    from torch.utils import cpp_extension
    cuda_inc = os.path.join(os.path.dirname(os.path.dirname(os.path.realpath(nvcc))),
                            "include")
    torch_lib = cpp_extension.library_paths()[0]
    compiles, objs = [], []
    for src in _sources():
        obj = os.path.join(obj_dir, f"{src.stem}.o")
        if src.suffix == ".cu":
            compiles.append((src.name, [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]))
        elif src.name == BINDING:
            abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
            compiles.append((src.name, [
                cxx, *CXX_FLAGS, "-c", "-o", obj, str(src), f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
                *(f"-I{p}" for p in cpp_extension.include_paths()),
                f"-I{python_include()}", f"-I{cuda_inc}"]))
        else:
            continue
        objs.append(obj)
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out), *objs, f"-L{torch_lib}",
            *(f"-l{lib}" for lib in TORCH_LIBS), "-Xlinker", "-rpath", "-Xlinker", torch_lib]
    return compiles, link


def _run(step):
    """(name, return code, output with the step's wall time) of one
    build step (name, command)."""
    name, cmd = step
    t0 = time.perf_counter()
    done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return name, done.returncode, done.stdout + f"{name}: {time.perf_counter() - t0:.2f} s\n"


def _compile(so) -> str:
    """The compile commands all running at once, then the link into
    ``so``; returns the compilers' output with each step's wall time.
    Raises if any step fails."""
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    obj_dir = so.with_name(f"{so.stem}.{os.getpid()}.obj")
    obj_dir.mkdir()
    try:
        compiles, link = commands(config.nvcc_path(), config.cxx_path(), str(obj_dir), tmp)
        with ThreadPoolExecutor(len(compiles)) as pool:
            done = list(pool.map(_run, compiles))
        log = "".join(out for _, _, out in done)
        failed = [f"{name} ({rc})" for name, rc, _ in done if rc != 0]
        if failed:
            raise RuntimeError(f"compile failed for {', '.join(failed)}:\n{log}")
        _, rc, out = _run(("link", link))
        log += out
        if rc != 0:
            raise RuntimeError(f"link failed ({rc}):\n{log}")
        os.replace(tmp, so)          # atomic: concurrent builders agree
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)
        if tmp.exists():
            tmp.unlink()
    return log
