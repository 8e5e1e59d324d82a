"""ctypes binding of the repo's native C++ runtime (native/rmi_native.cpp):
the greedy cachefix spline and the artifact server (counterpart of
rmi_tpu/native.py:29-128).

The library is built on first use from the checkout's
``native/rmi_native.cpp`` with ``config.cxx_path()`` and native/Makefile's
flags (no -ffast-math: NaN rows of empty leaves stay exact) into
``rmi_tpu_torch/_build/``, under a name keyed by the source, the flags
and the host CPU's features, since ``-march=native`` code runs only on
CPUs like the one it was built on.  The committed
``native/librmi_native.so`` is never loaded, for the same reason.  A
build that fails raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

from rmi_tpu_torch import config

SOURCE = config.PACKAGE_DIR.parent / "native" / "rmi_native.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lib: Optional[ctypes.CDLL] = None
_U64P = ctypes.POINTER(ctypes.c_uint64)


def _cpu_features() -> str:
    """The host CPU's feature flags (/proc/cpuinfo), or its machine name."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line
    except OSError:
        pass
    return platform.machine()


def library_path() -> str:
    """Where the build for this source, these flags and this CPU lies."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_cpu_features().encode())
    return str(config.BUILD_DIR / f"librmi_native-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless this host built it already; returns its
    path.  The compiler writes a temporary file that is renamed into
    place, so processes that build at once never load a partial file."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(config.BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=config.BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run([config.cxx_path(), *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"building {SOURCE} failed:\n{r.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load() -> ctypes.CDLL:
    """The library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    lib.rmi_cache_fix.restype = ctypes.c_int64
    lib.rmi_cache_fix.argtypes = [_U64P, _U64P, ctypes.c_uint64, ctypes.c_uint64,
                                  _U64P, _U64P]
    lib.rmi_load.restype = ctypes.c_void_p
    lib.rmi_load.argtypes = [ctypes.c_char_p]
    lib.rmi_free.argtypes = [ctypes.c_void_p]
    lib.rmi_lookup_batch.argtypes = [ctypes.c_void_p, _U64P, ctypes.c_uint64,
                                     _U64P, _U64P]
    lib.rmi_search_batch.argtypes = [ctypes.c_void_p, _U64P, ctypes.c_uint64,
                                     _U64P, ctypes.c_uint64, _U64P]
    _lib = lib
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_U64P)


def _key_words(a: np.ndarray) -> np.ndarray:
    """Keys as the 64-bit words the library reads: an integer key's value,
    an f64 key's bits (rmi_native.cpp reinterprets them where the
    artifact's key_type is f64, its key_is_float)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.float64:
        return a.view(np.uint64)
    return a.astype(np.uint64, copy=False)


def cache_fix(keys: np.ndarray, offsets: np.ndarray,
              line_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The native greedy spline (cache_fix.rs:45-150) over unique u64 keys
    and their first offsets: (knot keys, knot values), u64."""
    lib = load()
    n = keys.shape[0]
    cap = 2 * n + 2          # at most 2 knots per unique key, and the last
    ok = np.empty(cap, dtype=np.uint64)
    ov = np.empty(cap, dtype=np.uint64)
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    offsets = np.ascontiguousarray(offsets, dtype=np.uint64)
    count = lib.rmi_cache_fix(_ptr(keys), _ptr(offsets), n, line_size, _ptr(ok), _ptr(ov))
    if count < 0:
        raise RuntimeError("native cache_fix failed")
    return ok[:count].copy(), ov[:count].copy()


class NativeRMI:
    """The native artifact server: loads an artifact's metadata JSON and
    serves lookups and bounded searches on the host's CPU, of u32, u64 or
    f64 keys as the artifact's key type says.  Its search compares the
    keys' 64-bit words, which order f64 keys as their values only where
    none is negative."""

    def __init__(self, meta_path: str):
        self._lib = load()
        self._h = self._lib.rmi_load(os.fspath(meta_path).encode())
        if not self._h:
            raise RuntimeError(f"rmi_load failed for {meta_path}")

    def close(self):
        if self._h:
            self._lib.rmi_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def lookup(self, queries: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(guess, err) per query, u64."""
        q = _key_words(queries)
        guess = np.empty(q.shape[0], dtype=np.uint64)
        err = np.empty(q.shape[0], dtype=np.uint64)
        self._lib.rmi_lookup_batch(self._h, _ptr(q), q.shape[0], _ptr(guess), _ptr(err))
        return guess, err

    def search(self, queries: np.ndarray, keys: np.ndarray) -> np.ndarray:
        """Lower bounds of the queries in ``keys`` (the original keys of a
        cachefix index), u64."""
        q, k = _key_words(queries), _key_words(keys)
        out = np.empty(q.shape[0], dtype=np.uint64)
        self._lib.rmi_search_batch(self._h, _ptr(q), q.shape[0], _ptr(k), k.shape[0],
                                   _ptr(out))
        return out
