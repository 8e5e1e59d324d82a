"""Monotone cubic spline as the top model (counterpart of
rmi_tpu/models/cubic.py:33-197, 298-340, for the single whole-array span).

Fit: Hermite cubic through the first and last points scaled to the unit
square, endpoint slopes from the nearest distinct points, the
monotonicity clamp m1^2 + m2^2 <= 9, closed-form coefficients, and a
fallback to the linear spline through the endpoints whenever that has
the lower total L1 error (cubic_spline.rs:18-136).

Cubic LEAVES need the per-leaf L1 comparison, which the JAX package runs
through the window-select kernel (K6); they come with the second slice.

Prediction is three chained FMAs (cubic_spline.rs:140-150), as JAX
computes the Horner chain under jit on the CPU.  In the normalized key
domain the top's first point is (0, 0) exactly, so every product-sum
in ``_coeffs`` rounds the same whether or not it is contracted.
"""

from __future__ import annotations

import torch

from rmi_tpu_torch.models.base import ModelDef, register
from rmi_tpu_torch.models.linear import linear_predict, spline_from_endpoints


def cubic_predict(w, x):
    """fma(fma(fma(a, x, b), x, c), x, d) with the top row w[0]."""
    v = torch.addcmul(w[0, 1], w[0, 0], x)
    v = torch.addcmul(w[0, 2], v, x)
    return torch.addcmul(w[0, 3], v, x)


def _coeffs(xmin, ymin, xmax, ymax, m1, m2):
    """Closed-form a, b, c, d (cubic_spline.rs:74-99)."""
    span = xmax - xmin
    span3 = span * span * span
    a = (m1 + m2 - 2.0) / span3
    b = -(xmax * (2.0 * m1 + m2 - 3.0) + xmin * (m1 + 2.0 * m2 - 3.0)) / span3
    c = (m1 * (xmax * xmax) + m2 * (xmin * xmin)
         + xmax * xmin * (2.0 * m1 + 2.0 * m2 - 6.0)) / span3
    d = -xmin * (m1 * (xmax * xmax) + xmax * xmin * (m2 - 3.0)
                 + xmin * xmin) / span3
    ys = ymax - ymin
    return a * ys, b * ys, c * ys, d * ys + ymin


def _cubic_fit_top(xf, yf, ep_y_first, ep_y_last):
    """[1, 4] cubic parameters over the whole array.  ``ep_y_*`` are the
    container's endpoint targets (scaled raw indices)."""
    n = xf.shape[0]
    xmin, xmax = xf[:1], xf[n - 1:]
    ymin = torch.full_like(xmin, ep_y_first)
    ymax = torch.full_like(xmin, ep_y_last)
    degenerate = xmin == xmax          # all duplicates or a single point

    # first row with x > xmin and last row with x < xmax
    # (cubic_spline.rs:46-65)
    i1 = torch.searchsorted(xf, xmin, right=True).clamp(0, n - 1)
    i2 = (torch.searchsorted(xf, xmax) - 1).clamp(0, n - 1)

    safe_span = torch.where(degenerate, 1.0, xmax - xmin)
    safe_yspan = torch.where(ymax == ymin, 1.0, ymax - ymin)
    sxn = (xf[i1] - xmin) / safe_span
    syn = (yf[i1] - ymin) / safe_yspan
    sxp = (xf[i2] - xmin) / safe_span
    syp = (yf[i2] - ymin) / safe_yspan

    m1 = syn / torch.where(sxn == 0.0, 1.0, sxn)
    m2 = (1.0 - syp) / torch.where(sxp == 1.0, 1.0, 1.0 - sxp)

    # monotonicity clamp (cubic_spline.rs:67-72)
    norm2 = m1 * m1 + m2 * m2
    tau = torch.where(norm2 > 9.0, 3.0 / torch.sqrt(norm2.clamp(min=1e-300)),
                      1.0)
    m1, m2 = m1 * tau, m2 * tau
    a, b, c, d = _coeffs(xmin, ymin, xmax, ymax, m1, m2)

    # one point or all duplicates -> constant (0, 0, 0, y)
    # (cubic_spline.rs:19-36)
    const_case = degenerate | (n == 1)
    zero = torch.zeros_like(a)
    cubic_w = torch.stack([torch.where(const_case, zero, a),
                           torch.where(const_case, zero, b),
                           torch.where(const_case, zero, c),
                           torch.where(const_case, ymin, d)], dim=-1)

    # L1 comparison against the linear spline through the same endpoints
    # (cubic_spline.rs:113-135)
    cnt = torch.full_like(xmin, float(n))
    ls_a, ls_b = spline_from_endpoints(xmin, ymin, xmax, ymax, cnt)
    c_err = (cubic_predict(cubic_w, xf) - yf).abs_().sum()
    l_err = (linear_predict(ls_a[0], ls_b[0], xf) - yf).abs_().sum()
    lin_as_cubic = torch.stack([zero, zero, ls_b, ls_a], dim=-1)
    return torch.where(l_err < c_err, lin_as_cubic, cubic_w)


register(ModelDef(
    name="cubic", fit_top=_cubic_fit_top, fit_leaves=None,
    predict=cubic_predict, constant_params=None))
