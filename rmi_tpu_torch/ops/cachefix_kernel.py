"""The cachefix serving path (csrc/cachefix.cu): the bounded lower bound
and the spline's interpolation quantized to the cache line.

  bounded_lower_bound  first index i in [guess - err, guess + err]
                       (clamped to [0, n]) with keys[i] >= q (with
                       ``exact``, the lower bound where the window misses
                       it): one launch of rmi_bounded_lower_bound on CUDA
                       tensors, bounded_lower_bound_plain on CPU tensors;
  cachefix_interp      the knot pair from that search over the knots
                       around the RMI's (start, err), the double-rounded
                       lerp of their values, quantized: one launch of
                       rmi_cachefix_interp (its knots searched first in
                       their sample knots[::KNOT_STRIDE], knot_sample,
                       which the caller may cache), or
                       cachefix_interp_plain.

Counterparts of rmi_tpu's bounded_lower_bound / _bounded_search_jit and
_cachefix_interp (rmi_tpu/lookup.py:67-140), which rmi_tpu runs as XLA
beside K4, no Pallas call of their own.  The plain versions are rmi_tpu's
steps in torch: a branchless fixed-trip binary search, ``iters`` steps
covering the widest window, then the lerp in f64.  The kernels search
sorted keys and knots by whole 32-byte sectors, placed by interpolation
(csrc/cachefix.cu), wherever ``iters`` covers the query's window, where
every exact search answers alike, and halve as the plain version does
where it does not, so they answer what the plain versions answer on every
input, including a trip count too short for a window.
"""

from __future__ import annotations

import math

import torch

from rmi_tpu_torch import keys as keymod
from rmi_tpu_torch.ops import _build


def _check(fn, **tensors):
    dev = None
    for name, t in tensors.items():
        if t.dtype != torch.int64 or t.dim() != 1:
            raise ValueError(f"{fn}: {name} must be 1-D int64")
        if dev is not None and t.device != dev:
            raise ValueError(f"{fn}: every tensor must lie on one device ({name} is on "
                             f"{t.device}, not {dev})")
        dev = t.device
    q = tensors["queries"]
    for name in ("guess", "err", "start"):
        if name in tensors and tensors[name].shape != q.shape:
            raise ValueError(f"{fn}: {name} must be shaped like queries")


def _halving(keys, queries, lo, hi, n: int, iters: int):
    """The first i in [lo, hi) with keys[i] >= q, by ``iters`` fixed
    halving steps (a lane whose window is empty keeps it)."""
    for _ in range(iters):
        active = lo < hi
        mid = (lo + hi) >> 1
        go_right = keys[mid.clamp(0, n - 1)] < queries
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def full_trips(n: int) -> int:
    """Halving steps that cover [0, n): the bits of n, and one more."""
    return n.bit_length() + 1 if n > 0 else 1


def bounded_lower_bound_plain(keys, queries, guess, err, n: int, iters: int,
                              exact: bool = False):
    """First index i in [guess - err, guess + err] with keys[i] >= q:
    a branchless fixed-trip binary search, ``iters`` covering the
    widest window (rmi_tpu/lookup.py:67-90).  With ``exact``, a lane
    whose answer is not its lower bound in keys[0 : n] (its window missed
    it) searches all of [0, n): a cachefix index's window covers its keys
    and not every query between them, which rmi_tpu's search leaves
    answered wrong."""
    lo = _halving(keys, queries, (guess - err).clamp(0, n), (guess + err + 1).clamp(0, n),
                  n, iters)
    if not exact or n == 0:
        return lo
    below = (lo > 0) & (keys[(lo - 1).clamp(0, n - 1)] >= queries)
    above = (lo < n) & (keys[lo.clamp(0, n - 1)] < queries)
    missed = below | above
    return _halving(keys, queries, torch.where(missed, 0, lo), torch.where(missed, n, lo), n,
                    full_trips(n))


def bounded_lower_bound(keys, queries, guess, err, n: int, iters: int, exact: bool = False):
    """[m] int64 lower bounds of ``queries`` in keys[0 : n] inside each
    query's window, or with ``exact`` wherever the window misses it
    (bounded_lower_bound_plain): on the card one launch of
    rmi_bounded_lower_bound, on the CPU the plain version."""
    _check("bounded_lower_bound", keys=keys, queries=queries, guess=guess, err=err)
    if n > keys.shape[0] or n < 0:
        raise ValueError(f"bounded_lower_bound: n = {n} outside the {keys.shape[0]} keys")
    if queries.is_cpu:
        return bounded_lower_bound_plain(keys, queries, guess, err, n, iters, exact)
    m = queries.shape[0]
    if m == 0:
        return torch.empty_like(queries)
    return _build.launch("rmi_bounded_lower_bound", keys, keys.shape[0], queries, guess, err,
                         m, m, int(n), int(iters), int(exact))


# every KNOT_STRIDE-th knot: the sample the kernel searches first where a
# window holds more knots than this (csrc/cachefix.cu)
KNOT_STRIDE = 32


def knot_sample(spline_keys: torch.Tensor) -> torch.Tensor:
    """The knots' sample the kernel searches first: spline_keys[::KNOT_STRIDE],
    contiguous (ceil(num_pts / KNOT_STRIDE) entries, 8 B each)."""
    return spline_keys[::KNOT_STRIDE].contiguous()


def interp_iters(num_pts: int) -> int:
    """rmi_tpu's trip count over the knots: ceil(log2(num_pts + 1)) + 1."""
    return max(1, math.ceil(math.log2(num_pts + 1)) + 1)


def interp_eps(total_keys: int) -> float:
    """The margin toward the upper line: max(total_keys, 1) 2^-40."""
    return max(total_keys, 1) * (2.0 ** -40)


def cachefix_interp_plain(spline_keys, spline_vals, queries, start, err_s,
                          line_size: int, total_keys: int) -> torch.Tensor:
    """rmi_tpu's _cachefix_interp (rmi_tpu/lookup.py:97-140) in torch: the
    knot pair from the bounded search of the knots (images
    ``spline_keys``, int64 values ``spline_vals``) around the RMI's
    (start, err_s), the double-rounded lerp, floor((v + eps) / line_size)
    clamped at 0, times line_size; total_keys - 1 past the last knot."""
    num_pts = spline_keys.shape[0]
    res = bounded_lower_bound_plain(spline_keys, queries, start, err_s, num_pts,
                                    interp_iters(num_pts))
    return knot_positions(spline_keys, spline_vals, queries, res, line_size, total_keys)


def knot_positions(spline_keys, spline_vals, queries, res, line_size: int,
                   total_keys: int) -> torch.Tensor:
    """The cachefix positions from each query's knot search result ``res``
    (cachefix_interp_plain's lerp and quantization)."""
    num_pts = spline_keys.shape[0]
    past_end = res >= num_pts
    r = res.clamp(1, num_pts - 1)
    k1 = keymod.as_float(spline_keys[r - 1])
    k2 = keymod.as_float(spline_keys[r])
    v0 = spline_vals[r - 1].double()
    v1 = spline_vals[r].double()
    t = (keymod.as_float(queries) - k1) / torch.clamp(k2 - k1, min=1.0)
    v = (1.0 - t) * v0 + t * v1
    line = torch.floor((v + interp_eps(total_keys)) / line_size)
    pos = line.to(torch.int64).clamp(min=0) * line_size
    return torch.where(past_end, total_keys - 1, pos)


def cachefix_interp(spline_keys, spline_vals, queries, start, err_s,
                    line_size: int, total_keys: int, sample=None) -> torch.Tensor:
    """[m] int64 cachefix positions (cachefix_interp_plain): on the card
    one launch of rmi_cachefix_interp over the knots and ``sample``, their
    knot_sample (made here when None; lookup caches an index's), on the
    CPU the plain version, which needs no sample."""
    _check("cachefix_interp", spline_keys=spline_keys, spline_vals=spline_vals,
           queries=queries, start=start, err=err_s)
    num_pts = spline_keys.shape[0]
    if spline_vals.shape[0] != num_pts or num_pts < 1:
        raise ValueError("cachefix_interp: want as many knot values as knots, at least one")
    if line_size < 1:
        raise ValueError(f"cachefix_interp: line_size {line_size} < 1")
    if queries.is_cpu:
        return cachefix_interp_plain(spline_keys, spline_vals, queries, start, err_s,
                                     line_size, total_keys)
    m = queries.shape[0]
    if m == 0:
        return torch.empty_like(queries)
    if sample is None:
        sample = knot_sample(spline_keys)
    _check("cachefix_interp", queries=queries, sample=sample)
    if sample.shape[0] != -(-num_pts // KNOT_STRIDE):
        raise ValueError("cachefix_interp: sample must be knot_sample(spline_keys)")
    return _build.launch("rmi_cachefix_interp", spline_keys, spline_vals, num_pts, sample,
                         sample.shape[0], KNOT_STRIDE, queries, start, err_s, m, m,
                         int(line_size), int(total_keys), interp_eps(total_keys),
                         interp_iters(num_pts))
