"""Equi-depth histogram top model (counterpart of
rmi_tpu/models/histogram.py; histogram.rs:14-104 of the reference).

num_bins is the container's last raw target after scaling,
trunc((n - 1) B / n) (histogram.rs:24); the pivots are the keys at
multiples of n // num_bins, and a key's bin is upper_bound(pivots, key)
- 1 (histogram.rs:57-61).  A key below the first pivot wraps to u64::MAX
as the reference's usize underflow does, and clamp_int sends it to the
last leaf.  The 20-bit radix index over the pivots (utils.rs:55-102) is
built for the artifact, as rmi_tpu builds it; prediction does not read
it.
"""

from __future__ import annotations

import sys

import torch

from rmi_tpu_torch.keys import shr, u64_bits
from rmi_tpu_torch.models.base import ModelDef, Restriction, register
from rmi_tpu_torch.utils import segments as seg

RADIX_INDEX_BITS = 20  # histogram.rs:48


def build_radix_index(pivots: torch.Tensor, num_bits: int = RADIX_INDEX_BITS):
    """radix_index (utils.rs:55-102) of sorted pivot images: for each of
    the 2^num_bits top-bit buckets the index of the first pivot whose top
    bits reach it, then one entry of len(pivots)."""
    radix = shr(u64_bits(pivots), 64 - num_bits)
    idx = seg.sorted_starts(radix, 1 << num_bits)
    return torch.cat([idx, idx.new_full((1,), pivots.shape[0])])


def _histogram_fit_top(keys, ys, B, scale):
    n = keys.shape[0]
    # map_scale's truncation of the raw offset n - 1 (models/mod.rs:238-250)
    num_bins = int(float(n - 1) * scale) if abs(scale - 1.0) > sys.float_info.epsilon \
        else n - 1
    if num_bins <= 0 or n // num_bins < 1:
        raise ValueError("not enough items for equidepth histogram")  # histogram.rs:27
    pivots = keys[torch.arange(num_bins, device=keys.device) * (n // num_bins)]
    return {"count": torch.tensor(num_bins, device=keys.device), "pivots": pivots,
            "radix_index": build_radix_index(pivots)}


def _histogram_predict(params, leaf_ids, keys):
    # upper_bound: #{pivots <= key} (rmi_tpu's hier_count), as images
    return torch.searchsorted(params["pivots"], keys, right=True) - 1


register(ModelDef(
    name="histogram", ppm=3, fit_top=_histogram_fit_top, fit_leaves=None,
    predict=_histogram_predict, constant_params=None, leaf_kernel=None,
    bytes_per_model=None, function_name="ed_histogram", input_domain="int",
    output_int=True, restriction=Restriction.MUST_BE_TOP, leaf_capable=False,
    needs_bounds_check=False))
