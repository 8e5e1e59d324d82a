"""Batched serving: lookup and exact search (counterpart of
rmi_tpu/lookup.py:39-94, 143-159, 223-305).

  guess, err = lookup(rmi, queries)   # key -> top eval -> leaf eval -> err (K4)
  idx = search(rmi, queries)          # exact lower bounds, any order
  idx = search_sorted(rmi, queries)   # exact lower bounds, sorted batch
  guess, err, idx = lookup_and_search(rmi, queries)

Queries are int64 key images (rmi_tpu_torch.keys.to_image) on the
index's device.  ``lookup`` feeds the top and the leaf their model
inputs (the normalized keys, or a "raw" model's f64 keys), the top
function the build assigned leaves with and the leaf kernel and kernel
input the build measured errors with, so |guess - lower_bound| <= err
holds for every key.  ``search`` routes as rmi_tpu's does for an index without
cache fix: batches of SORT_SERVE_MIN or more, dense enough for K5's
windows (lookup_fast.sorts), go through sort -> K5 -> unsort, the rest
through the packed plan's two counts (lookup_fast.fast_search);
``search_route`` names the route a batch takes.  An index without a
packed plan (a top that is not monotone, leaves too wide) serves every
batch through lookup and the hierarchical plan's counts.
``search_sorted`` sends sorted batches of a packed plan straight to K5.
rmi_tpu keeps its sort route off where its kernel runs interpreted; here the route is the same on every device,
since on the CPU each kernel wrapper runs its plain version.  ``search``
given other ``keys`` than the index's searches them with lookup and the
bounded binary search, as rmi_tpu does.

A cachefix index (train_bounded, --bounded) is an RMI over the spline's
knots: ``lookup`` finds the query's knot pair with the RMI and the
bounded search over the knots, then interpolates and quantizes to the
cache line (rmi_tpu/lookup.py:97-140), and ``search`` needs the original
keys.  Both bounded searches and the interpolation are the kernels of
ops/cachefix_kernel.py (csrc/cachefix.cu): on the card the cachefix
lookup is one fused K4 launch and one rmi_cachefix_interp (over the knots
and their sample, made on first use and kept on the index), its search
one more rmi_bounded_lower_bound, and ``bounded_search`` one fused K4
launch and one rmi_bounded_lower_bound.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rmi_tpu_torch import lookup_fast
from rmi_tpu_torch.ops import cachefix_kernel, eval_kernel

# Batch size from which search sorts and serves through K5: rmi_tpu's
# value, calibrated on the TPU v5e (rmi_tpu/lookup.py:242-245); the
# H100's crossover is measured by chip_smoke.py's serving curve.
SORT_SERVE_MIN = 1 << 20


def lookup(rmi, queries: torch.Tensor):
    """Batched lookup(key, &err): (guess, err) as int64 tensors, from one
    launch of K4's fused entry over the index's lookup table and its top's
    operands (made on their first use on the card), or for a lognormal top
    or leaf, which has no lookup table, from the top eval in torch and
    K4's per-element entry, or a hint-table leaf's gather in torch
    (eval_kernel.lookup_clamped).  An index saved without its errors
    answers err 0, as rmi_tpu's does.  A cachefix index answers the
    spline's quantized position and err = line_size (codegen.rs:412-419)."""
    guess, err = _rmi_lookup(rmi, queries)
    if rmi.cache_fix is None:
        return guess, err
    line_size, _, spline_vals = rmi.cache_fix
    if rmi.spline_vals_cache is None:
        rmi.spline_vals_cache = torch.from_numpy(
            spline_vals.astype(np.int64)).to(rmi.keys.device)
    if rmi.knot_sample_cache is None and not queries.is_cpu:
        rmi.knot_sample_cache = cachefix_kernel.knot_sample(rmi.keys)
    pos = cachefix_kernel.cachefix_interp(rmi.keys, rmi.spline_vals_cache, queries, guess,
                                          err, line_size, rmi.num_data_rows,
                                          sample=rmi.knot_sample_cache)
    return pos, torch.full_like(pos, line_size)


def _rmi_lookup(rmi, queries: torch.Tensor):
    errors = rmi.leaf_errors
    if errors is None:
        errors = torch.zeros(rmi.branching_factor, dtype=torch.int64,
                             device=queries.device)
    if (rmi.lookup_table_cache is None and not queries.is_cpu
            and eval_kernel.fused_lookup(rmi.top_type, rmi.leaf_type)):
        rmi.lookup_top_cache = eval_kernel.top_operands(
            rmi.top_type, rmi.device_top_params, queries.device, errors.shape[0],
            rmi.leaf_type)
        rmi.lookup_table_cache = eval_kernel.lookup_rows(
            rmi.device_leaf_params, errors, rmi.lookup_top_cache, errors.shape[0])
    return eval_kernel.lookup_clamped(
        queries, rmi.device_top_params, rmi.device_leaf_params, errors,
        rmi.num_rmi_rows, rmi.norm_offset, rmi.norm_scale,
        top_type=rmi.top_type, leaf_type=rmi.leaf_type, table=rmi.lookup_table_cache,
        top_args=rmi.lookup_top_cache, key_type=rmi.key_type)


def err_iters(max_err: int) -> int:
    """Trip count of the bounded search: ceil(log2(2 max_err + 2)) + 1."""
    return max(1, math.ceil(math.log2(2 * max_err + 2)) + 1)


def bounded_search(rmi, queries: torch.Tensor, keys=None) -> torch.Tensor:
    """Exact lower bounds in ``keys`` (the index's own when None) through
    lookup and the bounded binary search: how ``search`` serves keys
    other than the index's (rmi_tpu/lookup.py:283-287).

    A query above the largest key has lower bound n, which the error
    bound does not cover when the keys end in a duplicate run: the
    reference never flushes the final run into the leaf errors
    (lower_bound_correction.rs:104-125), so those queries are answered
    by one comparison with the last key."""
    keys = rmi.keys if keys is None else keys
    n = rmi.num_rmi_rows
    guess, err = lookup(rmi, queries)
    lb = cachefix_kernel.bounded_lower_bound(keys, queries, guess, err, n,
                                             err_iters(rmi.model_max_error))
    return torch.where(queries > keys[-1], n, lb)


def search(rmi, queries: torch.Tensor, keys=None) -> torch.Tensor:
    """Exact lower-bound indices (searchsorted side='left') per query,
    in the index's keys, or in ``keys`` (images) when given: a cachefix
    index needs its ORIGINAL keys here (rmi_tpu/lookup.py:265-282).  A
    cachefix index's window, its position +- (line_size + 1), holds the
    lower bound of every key but not of every query between two keys (one
    after a run of equal keys may lie a run away): such a query is
    searched over all the keys (bounded_lower_bound's ``exact``), where
    rmi_tpu answers inside the window."""
    route = search_route(rmi, queries.shape[0], keys)
    if route == "cachefix":
        if keys is None:
            raise ValueError("cache_fix search needs the original key array")
        pos, err = lookup(rmi, queries)
        iters = max(1, math.ceil(math.log2(2 * rmi.cache_fix[0] + 2)) + 2)
        return cachefix_kernel.bounded_lower_bound(keys, queries, pos, err + 1,
                                                   rmi.num_data_rows, iters, exact=True)
    if route == "sort":
        return lookup_fast.serve_via_sort(rmi, lookup_fast.get_plan(rmi), queries)
    if route != "bounded":
        return lookup_fast.fast_search(rmi, queries)
    if keys is None and rmi.keys is None:
        raise ValueError("this index holds no keys: pass the keys it was built on")
    return bounded_search(rmi, queries, keys)


def search_route(rmi, nq: int, keys=None) -> str:
    """The route ``search`` takes for a batch of nq queries: "cachefix";
    "sort" (sort -> K5's scatter entry -> unsort: SORT_SERVE_MIN queries
    or more, dense enough for lookup_fast.sorts); the plan's kind
    ("packed", "packed_wide" or "hier": its counts, fast_search); or
    "bounded" (lookup and the bounded binary search)."""
    if rmi.cache_fix is not None:
        return "cachefix"
    if keys is None and lookup_fast.supports_fast_path(rmi):
        plan = lookup_fast.get_plan(rmi)
        if nq >= SORT_SERVE_MIN and lookup_fast.sorts(plan, nq):
            return "sort"
        return plan.kind
    return "bounded"


def search_sorted(rmi, queries: torch.Tensor) -> torch.Tensor:
    """Exact lower bounds of a NON-DECREASING batch: the bulk shape
    (merge joins, range scans, sorted probe streams), served by K5
    without the sort."""
    if rmi.cache_fix is None and lookup_fast.supports_fast_path(rmi):
        return lookup_fast.fast_search_sorted(rmi, queries)
    return search(rmi, queries)


def lookup_and_search(rmi, queries: torch.Tensor, keys=None):
    """(guess, err, exact lower bound) of each query, for benchmarks
    (rmi_tpu/lookup.py:308-312)."""
    guess, err = lookup(rmi, queries)
    return guess, err, search(rmi, queries, keys=keys)
