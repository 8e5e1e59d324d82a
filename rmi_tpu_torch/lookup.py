"""Batched serving: lookup and exact search (counterpart of
rmi_tpu/lookup.py:39-94, 143-159, 223-305).

  guess, err = lookup(rmi, queries)   # key -> top eval -> leaf eval -> err (K4)
  idx = search(rmi, queries)          # exact lower bounds, any order
  idx = search_sorted(rmi, queries)   # exact lower bounds, sorted batch

Queries are int64 key images (rmi_tpu_torch.keys.to_image) on the
index's device.  ``lookup`` feeds the top and the leaf their model
inputs (the normalized keys, or a "raw" model's f64 keys), the top
function the build assigned leaves with and the leaf kernel and kernel
input the build measured errors with, so |guess - lower_bound| <= err
holds for every key.  ``search`` routes as rmi_tpu's does for an index without
cache fix: batches of SORT_SERVE_MIN or more go through sort -> K5 ->
unsort (lookup_fast.fast_search_via_sort), smaller ones through the
packed plan's two counts (lookup_fast.fast_search); an index whose
leaves are too wide for a packed plan serves every batch through lookup
and the bounded binary search (bounded_search).  ``search_sorted`` sends
sorted batches straight to K5.  rmi_tpu keeps its sort route off where
its kernel runs interpreted; here the route is the same on every device,
since on the CPU each kernel wrapper runs its plain version.
"""

from __future__ import annotations

import math

import torch

from rmi_tpu_torch import lookup_fast
from rmi_tpu_torch.ops import eval_kernel

# Batch size from which search sorts and serves through K5: rmi_tpu's
# value, calibrated on the TPU v5e (rmi_tpu/lookup.py:242-245); the
# H100's crossover is measured by chip_smoke.py's serving curve.
SORT_SERVE_MIN = 1 << 20


def lookup(rmi, queries: torch.Tensor):
    """Batched lookup(key, &err): (guess, err) as int64 tensors, from one
    launch of K4's fused entry over the index's lookup table (made on its
    first use on the card), or for a lognormal top or leaf, which has no
    lookup table, from the top eval in torch and K4's per-element entry
    (eval_kernel.lookup_clamped)."""
    if (rmi.lookup_table_cache is None and not queries.is_cpu
            and eval_kernel.fused_lookup(rmi.top_type, rmi.leaf_type)):
        rmi.lookup_table_cache = eval_kernel.lookup_table(rmi.device_leaf_params,
                                                          rmi.leaf_errors)
    return eval_kernel.lookup_clamped(
        queries, rmi.device_top_params, rmi.device_leaf_params, rmi.leaf_errors,
        rmi.num_rmi_rows, rmi.norm_offset, rmi.norm_scale,
        top_type=rmi.top_type, leaf_type=rmi.leaf_type, table=rmi.lookup_table_cache)


def bounded_lower_bound(keys, queries, guess, err, n: int, iters: int):
    """First index i in [guess - err, guess + err] with keys[i] >= q:
    a branchless fixed-trip binary search, ``iters`` covering the
    widest window."""
    lo = (guess - err).clamp(0, n)
    hi = (guess + err + 1).clamp(0, n)
    for _ in range(iters):
        active = lo < hi
        mid = (lo + hi) >> 1
        go_right = keys[mid.clamp(0, n - 1)] < queries
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def err_iters(max_err: int) -> int:
    """Trip count of the bounded search: ceil(log2(2 max_err + 2)) + 1."""
    return max(1, math.ceil(math.log2(2 * max_err + 2)) + 1)


def bounded_search(rmi, queries: torch.Tensor) -> torch.Tensor:
    """Exact lower bounds through lookup and the bounded binary search:
    how a "bounded" plan (lookup_fast.get_plan) serves.

    A query above the largest key has lower bound n, which the error
    bound does not cover when the keys end in a duplicate run: the
    reference never flushes the final run into the leaf errors
    (lower_bound_correction.rs:104-125), so those queries are answered
    by one comparison with the last key."""
    n = rmi.num_rmi_rows
    guess, err = lookup(rmi, queries)
    lb = bounded_lower_bound(rmi.keys, queries, guess, err, n,
                             err_iters(rmi.model_max_error))
    return torch.where(queries > rmi.keys[-1], n, lb)


def search(rmi, queries: torch.Tensor) -> torch.Tensor:
    """Exact lower-bound indices (searchsorted side='left') per query."""
    if lookup_fast.supports_fast_path(rmi):
        if queries.shape[0] >= SORT_SERVE_MIN:
            return lookup_fast.fast_search_via_sort(rmi, queries)
        return lookup_fast.fast_search(rmi, queries)
    return bounded_search(rmi, queries)


def search_sorted(rmi, queries: torch.Tensor) -> torch.Tensor:
    """Exact lower bounds of a NON-DECREASING batch: the bulk shape
    (merge joins, range scans, sorted probe streams), served by K5
    without the sort."""
    if lookup_fast.supports_fast_path(rmi):
        return lookup_fast.fast_search_sorted(rmi, queries)
    return search(rmi, queries)
