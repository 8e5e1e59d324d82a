"""CacheFix: the error-bounded greedy spline over unique keys
(cache_fix.rs:5-150; counterpart of rmi_tpu/cache_fix.py).

Knots (key, offset) such that for every training point the interpolated
prediction lands in the point's cache line:
trunc(lerp(key)) / line_size == offset / line_size (cache_fix.rs:96-103).
Before each unique key an extra knot candidate at key - 1 keeps
lower-bound semantics (cache_fix.rs:118-128).

The one sequential algorithm of the build runs on the host, in the
repo's native C++ (native.py).  ``_cache_fix_py`` is its plain version,
which the tests hold the native spline to.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Tuple

import numpy as np

from rmi_tpu_torch import native
from rmi_tpu_torch.data import RMIDataset


def _fma(a: float, b: float, c: float) -> float:
    """a * b + c rounded once, as f64::mul_add (cache_fix.rs:41): Fraction
    arithmetic is exact and float() rounds correctly."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _predict(fx: int, fy: int, tx: int, ty: int, x: int) -> int:
    """Spline::predict (cache_fix.rs:36-42): the f64 lerp with mul_add,
    cast to usize.  The double-rounded lerp is within an ulp of the fused
    one, so where truncation is stable under a +/-5e-16 relative wiggle it
    is the fused result; only values near an integer pay for the exact
    fma."""
    t = float(x - fx) / float(tx - fx)
    a, b, c = 1.0 - t, float(fy), t * float(ty)
    v = a * b + c
    lo = int(v * (1.0 - 5e-16))
    if lo == int(v * (1.0 + 5e-16)):
        return lo
    return int(_fma(a, b, c))


def _cache_fix_py(keys: np.ndarray, offsets: np.ndarray,
                  line_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The greedy SplineFit (cache_fix.rs:45-104) over the candidate-point
    stream (cache_fix.rs:117-136), in Python: the native spline's plain
    version."""
    out_k, out_v = [], []
    have = False
    fx = fy = tx = ty = 0
    curr = []                  # points the current spline must keep covering

    def add_point(px: int, py: int):
        nonlocal have, fx, fy, tx, ty, curr
        if not have:
            have = True
            fx, fy, tx, ty = px, py, px, py
            out_k.append(px)
            out_v.append(py)
            return
        # proposal: the same origin, a new destination (cache_fix.rs:67-87)
        curr.append((tx, ty))
        ok = px != fx and all(
            _predict(fx, fy, px, py, cx) // line_size == cy // line_size
            for cx, cy in curr)
        if ok:
            tx, ty = px, py
        else:
            out_k.append(tx)
            out_v.append(ty)
            fx, fy = tx, ty
            tx, ty = px, py
            curr = [(px, py)]

    last_key = 0
    for k, off in zip(keys.tolist(), offsets.tolist()):
        if k - 1 != last_key:
            add_point(k - 1, off)
        add_point(k, off)
        last_key = k
    if have:
        out_k.append(tx)
        out_v.append(ty)
    return (np.asarray(out_k, dtype=np.uint64),
            np.asarray(out_v, dtype=np.uint64))


def cache_fix(data: RMIDataset, line_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Spline knots (keys, offsets), u64, for --bounded
    (cache_fix.rs:106-150), from the native spline over ``data.unique()``."""
    if data.n <= line_size:
        raise ValueError(
            "Cannot apply a cachefix with fewer items than the line size")
    uk, uo = data.unique()
    return native.cache_fix(uk.astype(np.uint64), uo, int(line_size))
