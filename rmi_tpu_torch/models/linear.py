"""Linear-family models: linear, robust_linear, loglinear and
linear_spline (counterpart of rmi_tpu/models/linear.py).

Least squares with the reference's 0/1-item and zero-variance cases
(linear.rs:12-59), fitted per leaf from two-pass centered moments over
the augmented spans; robust_linear trims max(1, 0.01% of the container)
items from each end first (linear.rs:238-260); loglinear regresses ln y
on x, dropping the items whose log is not finite through 0/1 weights,
and predicts through exp1 (linear.rs:61-72, 156-180); linear_spline is
the line through the container's first and last points
(linear_spline.rs:13-35).  rmi_tpu's chunked masked fit
(_masked_slr_chunked) is not ported: it exists because 200M f64
temporaries did not fit 16 GB of TPU memory, and the card has 80 GB.

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


def exp1(v):
    """(1 + v/64)^64 by six squarings, the reference's EXP1
    (linear.rs:156-166, stdlib.rs:17-33).  v / 64 is exact, so the add
    rounds once, as the FMA into which XLA folds it."""
    b = 1.0 + v / 64.0
    for _ in range(6):
        b = b * b
    return b


def loglinear_predict(w, leaf_ids, x):
    """exp1(fma(beta, x, alpha)) (linear.rs:177-180)."""
    return exp1(linear_predict(w, leaf_ids, x))


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


def _slr_ranges(xf, yf, spans, trim: bool = False, weights=None):
    """Per-leaf (alpha, beta) least squares over augmented spans, [B, 2];
    ``trim`` fits robust_linear's trimmed spans instead, and 0/1
    ``weights`` drop items (loglinear)."""
    use = _trimmed(spans) if trim else spans
    if weights is None:
        sx = seg.range_sum(xf, use.aug_starts, use.aug_ends)
        sy = seg.range_sum(yf, use.aug_starts, use.aug_ends)
        cnt = seg.aug_count(use)
    else:
        cnt, sx, sy = seg.aug_masked_stats(use, weights, xf, yf)
    safe_cnt = cnt.clamp(min=1.0)
    if use.B == 1 and weights is None:
        inv = 1.0 / safe_cnt           # folded by XLA: the top's count is static
        mean_x, mean_y = sx * inv, sy * inv
    else:
        mean_x, mean_y = sx / safe_cnt, sy / safe_cnt
    m2, c = seg.aug_centered_moments(use, xf, yf, mean_x, mean_y, weights)
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


def spline_from_endpoints(x0, y0, x1, y1, cnt, fused: bool = True):
    """(intercept, slope) through two points with the reference's
    fallbacks (linear_spline.rs:13-35): 0 items -> (0, 0); 1 item or
    all duplicates (x0 == x1) -> (y0, 0).  The intercept y0 - slope x0
    is one FMA where XLA contracts it in rmi_tpu (the cubic fit's spline
    candidate); ``fused=False`` rounds the product first, as XLA leaves
    rmi_tpu's linear_spline leaf fit (found by trial against
    jax.jit(_linear_spline_fit_leaves))."""
    degenerate = x0 == x1
    dx = torch.where(degenerate, 1.0, x0 - x1)
    slope = torch.where(degenerate, 0.0, (y0 - y1) / dx)
    intercept = (torch.addcmul(y0, slope, x0, value=-1) if fused
                 else y0 - slope * x0)
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


def log_targets(yf):
    """(ln y with non-finite logs set to 0, 0/1 weights that drop them)
    (linear.rs:63-67).  y = 0, the first key's position, gives -inf."""
    ln = torch.log(yf)
    keep = torch.isfinite(ln)
    return torch.where(keep, ln, 0.0), keep.double()


def _loglinear_fit(xf, yf, spans):
    ln, w = log_targets(yf)
    return _slr_ranges(xf, ln, spans, weights=w)


# empty loglinear leaves keep the (0, 0) row of an empty fit, exp1(0) = 1:
# rmi_tpu does not patch them (two_layer.py:235-243)
register(ModelDef(
    name="loglinear", ppm=2,
    fit_top=lambda xf, yf, ep_first, ep_last: _loglinear_fit(
        xf, yf, seg.whole_array_spans(xf.shape[0], xf.device)),
    fit_leaves=lambda xf, yfix, spans: _loglinear_fit(xf, yfix.double(), spans),
    predict=loglinear_predict, constant_params=None, leaf_kernel="loglinear"))


def _linear_spline_top(xf, yf, ep_first, ep_last):
    """The line through the first and last keys, at their raw (not
    FixDups) scaled positions (models/mod.rs:268-274)."""
    n = xf.shape[0]
    x0, x1 = xf[:1], xf[n - 1:]
    a, b = spline_from_endpoints(x0, torch.full_like(x0, ep_first), x1,
                                 torch.full_like(x1, ep_last),
                                 torch.full_like(x0, float(n)))
    return torch.stack([a, b], dim=-1)


def _linear_spline_leaves(xf, yfix, spans):
    first, last = seg.aug_first_last(spans)
    yf = yfix.double()
    a, b = spline_from_endpoints(xf[first], yf[first], xf[last], yf[last],
                                 seg.aug_count(spans), fused=False)
    return torch.stack([a, b], dim=-1)


register(ModelDef(
    name="linear_spline", ppm=2, fit_top=_linear_spline_top,
    fit_leaves=_linear_spline_leaves, predict=linear_predict,
    constant_params=_const_linear, leaf_kernel="linear"))
