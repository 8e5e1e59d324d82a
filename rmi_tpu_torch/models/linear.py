"""Linear model (counterpart of rmi_tpu/models/linear.py, linear part).

Least squares with the reference's 0/1-item and zero-variance cases
(linear.rs:12-59), fitted per leaf from two-pass centered moments over
the augmented spans.  The trimmed (robust_linear), weighted (loglinear)
and endpoint (linear_spline) variants come with a later slice; only
``spline_from_endpoints`` is here, for the cubic top's L1 fallback.

Rounding follows the JAX build as it runs under jit on the CPU, where
XLA contracts a multiply feeding an add into one FMA: the prediction is
fma(beta, x, alpha) (linear.rs:87-90) and the intercept
fma(-beta, mean_x, mean_y).  ``torch.addcmul`` computes exactly that
FMA on the CPU.
"""

from __future__ import annotations

import torch

from rmi_tpu_torch.models.base import ModelDef, register
from rmi_tpu_torch.utils import segments as seg


def linear_predict(alpha, beta, x):
    """fma(beta, x, alpha): the leaf evaluation every plain path shares
    (the kernels' is csrc/leaf_eval.cuh)."""
    return torch.addcmul(alpha, beta, x)


def _slr_ranges(xf, yf, spans):
    """Per-leaf (alpha, beta) least squares over augmented spans, [B, 2]."""
    sx = seg.range_sum(xf, spans.aug_starts, spans.aug_ends)
    sy = seg.range_sum(yf, spans.aug_starts, spans.aug_ends)
    cnt = seg.aug_count(spans)
    safe_cnt = cnt.clamp(min=1.0)
    mean_x = sx / safe_cnt
    mean_y = sy / safe_cnt
    m2, c = seg.aug_centered_moments(spans, xf, yf, mean_x, mean_y)
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


def _linear_top_predict(w, x):
    return linear_predict(w[0, 0], w[0, 1], x)


def _linear_fit_top(xf, yf, ep_y_first, ep_y_last):
    return _slr_ranges(xf, yf, seg.whole_array_spans(xf.shape[0], xf.device))


def _const_linear(value_f):
    """set_to_constant_model => (c, 0) (linear.rs:116-119)."""
    return torch.stack([value_f, torch.zeros_like(value_f)], dim=-1)


register(ModelDef(
    name="linear", fit_top=_linear_fit_top, fit_leaves=_slr_ranges,
    predict=_linear_top_predict, constant_params=_const_linear))
