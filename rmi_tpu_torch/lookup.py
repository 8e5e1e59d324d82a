"""Batched serving: lookup and exact search (counterpart of
rmi_tpu/lookup.py:39-94, 143-159, 223-285).

  guess, err = lookup(rmi, queries)   # top eval -> leaf eval (K4) -> err
  idx = search(rmi, queries)          # + bounded lower_bound over the keys

Queries are int64 key images (rmi_tpu_torch.keys.to_image) on the
index's device.  Serving evaluates in the normalized key domain with the
top function the build assigned leaves with and the leaf function the
build measured errors with, so |guess - lower_bound| <= err holds for
every key.  Every batch goes through this 2-gather path; the sorted-batch
kernel the JAX package uses for batches of 2^20 or more (K5) and its
packed/sort serving plans come with the next slice.
"""

from __future__ import annotations

import math

import torch

from rmi_tpu_torch.models import get_model
from rmi_tpu_torch.ops import eval_kernel
from rmi_tpu_torch.train import two_layer


def lookup(rmi, queries: torch.Tensor):
    """Batched lookup(key, &err): (guess, err) as int64 tensors."""
    n, B = rmi.num_rmi_rows, rmi.branching_factor
    xn = two_layer.normalize(queries, rmi.norm_offset, rmi.norm_scale)
    midx = two_layer.predict_top_assignment(
        get_model(rmi.top_type), rmi.device_top_params, xn, B - 1)
    # final clamp to n - 1 (codegen.rs:713-717)
    guess = eval_kernel.leaf_eval_clamped(xn, rmi.device_leaf_params, midx,
                                          n - 1).long()
    return guess, rmi.leaf_errors[midx]


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


def search(rmi, queries: torch.Tensor) -> torch.Tensor:
    """Exact lower-bound indices (searchsorted side='left') per query.

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
