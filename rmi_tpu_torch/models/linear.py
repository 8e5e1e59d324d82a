"""Linear models: linear and robust_linear (counterpart of
rmi_tpu/models/linear.py, its linear and robust_linear parts).

Least squares with the reference's 0/1-item and zero-variance cases
(linear.rs:12-59), fitted per leaf from two-pass centered moments over
the augmented spans; robust_linear trims max(1, 0.01% of the container)
items from each end first (linear.rs:238-260).  The weighted (loglinear)
and endpoint (linear_spline) variants come with a later slice; only
``spline_from_endpoints`` is here, for the cubic model's L1 fallback.

Rounding follows the JAX build as it runs under jit on the CPU, where
XLA contracts a multiply feeding an add into one FMA: the prediction is
fma(beta, x, alpha) (linear.rs:87-90) and the intercept
fma(-beta, mean_x, mean_y).  ``torch.addcmul`` computes exactly that
FMA on the CPU.  The top's whole-array sums follow XLA's order
(segments.whole_array_sum), and its means multiply by 1 / count, which
XLA folds because the count is known when it compiles the top fit.
"""

from __future__ import annotations

import torch

from rmi_tpu_torch.models.base import ModelDef, leaf_columns, register
from rmi_tpu_torch.utils import segments as seg


def linear_predict(w, leaf_ids, x):
    """fma(beta, x, alpha) with each element's row (alpha, beta)."""
    alpha, beta = leaf_columns(w, leaf_ids)
    return torch.addcmul(alpha, beta, x)


def _trimmed(spans: seg.Spans) -> seg.Spans:
    """robust_linear's containers: each augmented span without its
    first and last bnd = max(1, trunc(len * 1e-4)) items
    (linear.rs:247-252).  The reference asserts 2 bnd + 1 < len and would
    abort on a smaller container; rmi_tpu keeps the untrimmed span there
    (rmi_tpu/models/linear.py:54-75), and so does the port."""
    total = spans.aug_ends - spans.aug_starts
    bnd = (total.double() * 1e-4).long().clamp(min=1)
    ok = 2 * bnd + 1 < total
    lo = torch.where(ok, spans.aug_starts + bnd, spans.aug_starts)
    hi = torch.where(ok, torch.maximum(spans.aug_ends - bnd, lo), spans.aug_ends)
    return seg.Spans(t=spans.t, starts=lo, ends=hi, aug_starts=lo, aug_ends=hi,
                     nonempty=lo < hi, n=spans.n, B=spans.B)


def _slr_ranges(xf, yf, spans, trim: bool = False):
    """Per-leaf (alpha, beta) least squares over augmented spans, [B, 2];
    ``trim`` fits robust_linear's trimmed spans instead."""
    use = _trimmed(spans) if trim else spans
    sx = seg.range_sum(xf, use.aug_starts, use.aug_ends)
    sy = seg.range_sum(yf, use.aug_starts, use.aug_ends)
    cnt = seg.aug_count(use)
    safe_cnt = cnt.clamp(min=1.0)
    if use.B == 1:
        inv = 1.0 / safe_cnt           # folded by XLA: the top's count is static
        mean_x, mean_y = sx * inv, sy * inv
    else:
        mean_x, mean_y = sx / safe_cnt, sy / safe_cnt
    m2, c = seg.aug_centered_moments(use, xf, yf, mean_x, mean_y)
    return _slr_from_moments(cnt, mean_x, mean_y, m2, c)


def _slr_from_moments(cnt, mean_x, mean_y, m2, c):
    """(alpha, beta) from count, means and centered moments, with the
    reference's degenerate cases (linear.rs:37-55): 0 items -> (0, 0);
    1 item or zero variance -> (mean_y, 0)."""
    var_zero = m2 <= 0.0
    beta = torch.where(var_zero, 0.0, c / torch.where(var_zero, 1.0, m2))
    alpha = torch.addcmul(mean_y, beta, mean_x, value=-1)
    alpha = torch.where(cnt == 0, 0.0,
                        torch.where((cnt == 1) | var_zero, mean_y, alpha))
    beta = torch.where((cnt <= 1) | var_zero, 0.0, beta)
    return torch.stack([alpha, beta], dim=-1)


def spline_from_endpoints(x0, y0, x1, y1, cnt):
    """(intercept, slope) through two points with the reference's
    fallbacks (linear_spline.rs:13-35): 0 items -> (0, 0); 1 item or
    all duplicates (x0 == x1) -> (y0, 0)."""
    degenerate = x0 == x1
    dx = torch.where(degenerate, 1.0, x0 - x1)
    slope = torch.where(degenerate, 0.0, (y0 - y1) / dx)
    intercept = torch.addcmul(y0, slope, x0, value=-1)
    intercept = torch.where(cnt == 0, 0.0,
                            torch.where((cnt == 1) | degenerate, y0, intercept))
    slope = torch.where((cnt <= 1) | degenerate, 0.0, slope)
    return intercept, slope


def _const_linear(value_f):
    """set_to_constant_model => (c, 0) (linear.rs:116-119)."""
    return torch.stack([value_f, torch.zeros_like(value_f)], dim=-1)


for _name, _trim in (("linear", False), ("robust_linear", True)):
    register(ModelDef(
        name=_name, ppm=2,
        fit_top=lambda xf, yf, ep_first, ep_last, _trim=_trim: _slr_ranges(
            xf, yf, seg.whole_array_spans(xf.shape[0], xf.device), _trim),
        fit_leaves=lambda xf, yfix, spans, _trim=_trim: _slr_ranges(
            xf, yfix.double(), spans, _trim),
        predict=linear_predict, constant_params=_const_linear,
        leaf_kernel="linear"))
