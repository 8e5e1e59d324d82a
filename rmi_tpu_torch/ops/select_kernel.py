"""K2: per-leaf centered moments of the linear-family and normal leaf
fits (csrc/moments.cu).

Counterpart of rmi_tpu/ops/select_kernel.py:window_moments plus the
per-leaf range sums that follow it (rmi_tpu/utils/segments.py:683-720).
The kernel fuses the per-key products into the per-leaf sums.  Three C
entry points, one per variant of the TPU kernel, behind two wrappers:
``aug_centered_moments`` launches ``rmi_aug_moments`` (linear leaves) or,
given 0/1 weights, ``rmi_aug_moments_weighted`` (``has_w``, loglinear
leaves); ``aug_centered_xx`` launches ``rmi_aug_moments_xx`` (``xx_only``:
the variance of x alone, normal and lognormal leaves).
"""

from __future__ import annotations

import torch

from rmi_tpu_torch.ops import _build


def _check(name, tensors, per_leaf):
    """``tensors``: (name, tensor) pairs, every one 1-D int64 (the range
    bounds) or f64 (the rest); the first is x, each per-key one as long
    as x, each of ``per_leaf`` as long as the first of them."""
    for what, a in tensors:
        dt = torch.int64 if what.startswith("aug_") else torch.float64
        if a.dtype != dt or a.dim() != 1:
            raise ValueError(f"{name}: {what} must be 1-D {dt}")
    per_key = [a for what, a in tensors if what not in per_leaf]
    if any(a.shape != per_key[0].shape for a in per_key):
        raise ValueError(f"{name}: the per-key arrays differ in length")
    B = {a.shape[0] for what, a in tensors if what in per_leaf}
    if len(B) != 1:
        raise ValueError(f"{name}: the per-leaf arrays differ in length")


_PER_LEAF = ("mean_x", "mean_y", "aug_starts", "aug_ends")


def span_elements(starts, ends):
    """(leaf, elem): every element index of every range
    [starts[j], ends[j]) and the leaf j it belongs to, leaf by leaf."""
    B = starts.shape[0]
    lengths = ends - starts
    leaf = torch.repeat_interleave(torch.arange(B, device=starts.device), lengths)
    first = torch.cumsum(lengths, 0) - lengths
    elem = (torch.arange(leaf.shape[0], device=starts.device) - first[leaf]
            + starts[leaf])
    return leaf, elem


def aug_centered_moments_plain(x, y, mean_x, mean_y, aug_starts, aug_ends, *,
                               weights=None):
    """The plain PyTorch version of K2 and K2 weighted: the same terms,
    expanded per element of each augmented range and summed per leaf
    with index_add_; a weighted term is the product times its weight."""
    leaf, elem = span_elements(aug_starts, aug_ends)
    dx = x[elem] - mean_x[leaf]
    xx, xy = dx * dx, dx * (y[elem] - mean_y[leaf])
    if weights is not None:
        wt = weights[elem]
        xx, xy = xx * wt, xy * wt
    m2 = torch.zeros_like(mean_x).index_add_(0, leaf, xx)
    return m2, torch.zeros_like(mean_x).index_add_(0, leaf, xy)


def aug_centered_moments(x, y, mean_x, mean_y, aug_starts, aug_ends, *,
                         weights=None):
    """(m2, c) [B] f64: per leaf j, sum (x - mean_x[j])^2 and
    sum (x - mean_x[j]) (y - mean_y[j]) over [aug_starts[j], aug_ends[j]),
    each term times weights[i] when 0/1 ``weights`` are given
    (``rmi_aug_moments_weighted``, else ``rmi_aug_moments``).  Sums
    differ from the plain version's by summation order only."""
    named = [("x", x), ("y", y), ("mean_x", mean_x), ("mean_y", mean_y),
             ("aug_starts", aug_starts), ("aug_ends", aug_ends)]
    if weights is not None:
        named.append(("weights", weights))
    _check("aug_centered_moments", named, _PER_LEAF)
    if x.is_cpu:
        return aug_centered_moments_plain(x, y, mean_x, mean_y, aug_starts,
                                          aug_ends, weights=weights)
    _build.check_cuda("aug_centered_moments", *(a for _, a in named))
    B = mean_x.shape[0]
    m2 = torch.empty(B, dtype=torch.float64, device=x.device)
    c = torch.empty(B, dtype=torch.float64, device=x.device)
    if weights is None:
        _build.launch("rmi_aug_moments", x, y, mean_x, mean_y, aug_starts,
                      aug_ends, m2, c, B)
    else:
        _build.launch("rmi_aug_moments_weighted", x, y, weights, mean_x, mean_y,
                      aug_starts, aug_ends, m2, c, B)
    return m2, c


def aug_centered_xx_plain(x, mean_x, aug_starts, aug_ends):
    """The plain PyTorch version of K2 xx."""
    leaf, elem = span_elements(aug_starts, aug_ends)
    dx = x[elem] - mean_x[leaf]
    return torch.zeros_like(mean_x).index_add_(0, leaf, dx * dx)


def aug_centered_xx(x, mean_x, aug_starts, aug_ends):
    """m2 [B] f64: per leaf j, sum (x - mean_x[j])^2 over its augmented
    range, reading x alone (``rmi_aug_moments_xx``)."""
    named = [("x", x), ("mean_x", mean_x), ("aug_starts", aug_starts),
             ("aug_ends", aug_ends)]
    _check("aug_centered_xx", named, _PER_LEAF)
    if x.is_cpu:
        return aug_centered_xx_plain(x, mean_x, aug_starts, aug_ends)
    _build.check_cuda("aug_centered_xx", x, mean_x, aug_starts, aug_ends)
    B = mean_x.shape[0]
    m2 = torch.empty(B, dtype=torch.float64, device=x.device)
    _build.launch("rmi_aug_moments_xx", x, mean_x, aug_starts, aug_ends, m2, B)
    return m2
