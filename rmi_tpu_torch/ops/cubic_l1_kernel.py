"""K6: per-leaf L1 sums of the cubic leaf fit's two candidates
(csrc/cubic_l1.cu).

Counterpart of rmi_tpu/ops/select_kernel.py:window_select together with
what rmi_tpu's cubic leaf fit does with its output
(rmi_tpu/models/cubic.py:127-173, 216-265): the TPU kernel hands each key
its leaf's six candidate parameters as f32 hi/lo pairs, XLA evaluates
both candidates and range-sums |pred - y| per leaf.  The card needs no
per-key rows: the kernel evaluates and sums in one pass, one warp per
leaf, with the leaf evaluations K3 and K4 use (csrc/leaf_eval.cuh).

Its plain version is rmi_tpu's CPU reference _abs_err_sum: per-key
|pred - y| through each key's gathered row, the interior [starts, ends)
summed by prefix differences, then the edge terms at starts - 1 and at
ends.  Kernel and plain version add in different orders, so their sums
agree to rounding only, and on a near tie the choice l_err < c_err may
differ (chip_smoke.py counts such leaves).
"""

from __future__ import annotations

import torch

from rmi_tpu_torch.models.base import leaf_predict
from rmi_tpu_torch.ops import _build
from rmi_tpu_torch.utils import segments as seg


# How far the kernel's sums may lie from the plain version's: RTOL of the
# sum for the kernel's own order, and ATOL_OF_TOTAL of the total over all
# leaves, the scale of the prefix sums whose differences the plain
# version takes.
RTOL = 1e-10
ATOL_OF_TOTAL = 1e-12


def sum_tolerance(want: torch.Tensor) -> torch.Tensor:
    """Per-leaf tolerance of kernel sums against the plain ``want``."""
    return RTOL * want.abs() + ATOL_OF_TOTAL * want.sum()


def _check(x, y, cubic_w, lin_w, spans):
    if x.dtype != torch.float64 or x.dim() != 1:
        raise ValueError("cubic_l1_sums: x must be 1-D float64")
    if y.dtype != torch.int32 or y.shape != x.shape:
        raise ValueError("cubic_l1_sums: y must be int32 shaped like x")
    B = spans.B
    if cubic_w.dtype != torch.float64 or cubic_w.shape != (B, 4):
        raise ValueError("cubic_l1_sums: cubic_w must be a [B, 4] float64 table")
    if lin_w.dtype != torch.float64 or lin_w.shape != (B, 2):
        raise ValueError("cubic_l1_sums: lin_w must be a [B, 2] float64 table")


def cubic_l1_sums_plain(x, y, cubic_w, lin_w, spans: seg.Spans):
    """The plain PyTorch version: rmi_tpu's _abs_err_sum for both
    candidates (rmi_tpu/models/cubic.py:298-322)."""
    n = x.shape[0]
    yf = y.double()
    t = spans.t.long()
    leaf_ids = torch.arange(spans.B, device=x.device)
    # an edge is a point of the augmented range outside [starts, ends);
    # that range may be empty where a shard holds a leaf's edge alone
    # (parallel/dp_trainer.py), never where the augmented range is
    nonempty = spans.aug_starts < spans.aug_ends
    has_prev = nonempty & (spans.aug_starts < spans.starts)
    has_next = nonempty & (spans.aug_ends > spans.ends)
    ip = (spans.starts - 1).clamp(0, n - 1)
    inx = spans.ends.clamp(0, n - 1)
    sums = []
    for leaf_type, w in (("cubic", cubic_w), ("linear", lin_w)):
        d = (leaf_predict(leaf_type, w, t, x) - yf).abs_()
        interior = seg.range_sum(d, spans.starts, spans.ends)
        del d
        prev = (leaf_predict(leaf_type, w, leaf_ids, x[ip]) - yf[ip]).abs()
        nxt = (leaf_predict(leaf_type, w, leaf_ids, x[inx]) - yf[inx]).abs()
        sums.append(interior + torch.where(has_prev, prev, 0.0)
                    + torch.where(has_next, nxt, 0.0))
    return tuple(sums)


def cubic_l1_sums(x, y, cubic_w, lin_w, spans: seg.Spans):
    """(c_err, l_err) [B] f64: per leaf j, over its augmented range
    [aug_starts[j], aug_ends[j]),
        c_err[j] = sum |fma(fma(fma(a, x, b), x, c), x, d) - y|
        l_err[j] = sum |fma(lb, x, la) - y|
    with (a, b, c, d) = cubic_w[j] and (la, lb) = lin_w[j]."""
    _check(x, y, cubic_w, lin_w, spans)
    if x.is_cpu:
        return cubic_l1_sums_plain(x, y, cubic_w, lin_w, spans)
    B = spans.B
    return _build.launch("rmi_cubic_l1", x, y, cubic_w, lin_w, spans.aug_starts,
                         spans.aug_ends, B, B, B)
