"""K2: per-leaf centered moments of the linear leaf fit (csrc/moments.cu).

Counterpart of rmi_tpu/ops/select_kernel.py:window_moments plus the
per-leaf range sums that follow it (rmi_tpu/utils/segments.py:683-720).
The kernel fuses the per-key products into the per-leaf sums; the
weighted and ``xx_only`` variants serve loglinear and normal leaves and
come with those leaves.
"""

from __future__ import annotations

import torch

from rmi_tpu_torch.ops import _build


def _check(x, y, mean_x, mean_y, aug_starts, aug_ends):
    for name, a, dt in (("x", x, torch.float64), ("y", y, torch.float64),
                        ("mean_x", mean_x, torch.float64),
                        ("mean_y", mean_y, torch.float64),
                        ("aug_starts", aug_starts, torch.int64),
                        ("aug_ends", aug_ends, torch.int64)):
        if a.dtype != dt or a.dim() != 1:
            raise ValueError(f"aug_centered_moments: {name} must be 1-D {dt}")
    if x.shape != y.shape:
        raise ValueError("aug_centered_moments: x and y differ in length")
    B = mean_x.shape[0]
    if not (mean_y.shape[0] == aug_starts.shape[0] == aug_ends.shape[0] == B):
        raise ValueError("aug_centered_moments: per-leaf arrays differ in length")


def aug_centered_moments_plain(x, y, mean_x, mean_y, aug_starts, aug_ends):
    """The plain PyTorch version: the same terms, expanded per element
    of each augmented range and summed per leaf with index_add_."""
    B = mean_x.shape[0]
    lengths = aug_ends - aug_starts
    leaf = torch.repeat_interleave(
        torch.arange(B, device=x.device), lengths)
    first = torch.cumsum(lengths, 0) - lengths
    elem = (torch.arange(leaf.shape[0], device=x.device) - first[leaf]
            + aug_starts[leaf])
    dx = x[elem] - mean_x[leaf]
    m2 = torch.zeros(B, dtype=torch.float64, device=x.device)
    c = torch.zeros(B, dtype=torch.float64, device=x.device)
    m2.index_add_(0, leaf, dx * dx)
    c.index_add_(0, leaf, dx * (y[elem] - mean_y[leaf]))
    return m2, c


def aug_centered_moments(x, y, mean_x, mean_y, aug_starts, aug_ends):
    """(m2, c) [B] f64: per leaf j, sum (x - mean_x[j])^2 and
    sum (x - mean_x[j]) (y - mean_y[j]) over [aug_starts[j], aug_ends[j]).
    Sums differ from the plain version's by summation order only."""
    _check(x, y, mean_x, mean_y, aug_starts, aug_ends)
    if x.device.type == "cpu":
        return aug_centered_moments_plain(x, y, mean_x, mean_y, aug_starts,
                                          aug_ends)
    _build.check_cuda("aug_centered_moments", x, y, mean_x, mean_y,
                      aug_starts, aug_ends)
    B = mean_x.shape[0]
    m2 = torch.empty(B, dtype=torch.float64, device=x.device)
    c = torch.empty(B, dtype=torch.float64, device=x.device)
    _build.launch("rmi_aug_moments", x, y, mean_x, mean_y, aug_starts,
                  aug_ends, m2, c, B)
    return m2, c
