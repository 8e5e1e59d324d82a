"""Monotone cubic spline, as the top model or as leaves (counterpart of
rmi_tpu/models/cubic.py:33-197, 298-354).

Fit: Hermite cubic through each container's first and last points
scaled to the unit square, endpoint slopes from the nearest distinct
points, the monotonicity clamp m1^2 + m2^2 <= 9, closed-form
coefficients, and a fallback to the linear spline through the endpoints
whenever that has the lower total L1 error (cubic_spline.rs:18-136).
For leaves the L1 sums run in kernel K6 (ops/cubic_l1_kernel.py); the
top's are whole-array sums in XLA's order (segments.whole_array_sum).
``fit_cubic_aux`` also returns rmi_tpu's generator statistics (aux),
from which convert.py recomputes the artifact's raw coefficients.

Prediction is three chained FMAs (cubic_spline.rs:140-150), as JAX
computes the Horner chain under jit on the CPU.

Rounding of the leaf fit against rmi_tpu's, jitted on the CPU.  XLA
contracts a multiply feeding an add into an FMA and rewrites
(A / B) / C as A / (B * C); both are pinned here, found by trial
against jax.jit(rmi_tpu.models.cubic._fit_cubic_ranges): 7 FMAs (norm2,
the b, c and d numerators, d * ys + ymin) and the m1 quotient.  With
them every leaf whose slopes need no clamp is bit-equal to rmi_tpu's.
Where the clamp applies (norm2 > 9), XLA computes tau = 3 / sqrt(norm2)
as 3 * rsqrt(norm2) with an rsqrt that is not correctly rounded, so
tau may differ by 1 ulp and the clamped slopes m1 and m2 by up to 2;
the port keeps the rounded quotient.  The coefficients amplify such an ulp by
the cancellation in their closed forms, while the leaf's predictions
move by about an ulp of y (tests/test_torch_cubic_leaves.py states
the tolerance; PERF.md counts the leaves).
"""

from __future__ import annotations

import torch

from rmi_tpu_torch import keys as keymod
from rmi_tpu_torch.convert import (CUBIC_CASE_CONST, CUBIC_CASE_CUBIC,
                                   CUBIC_CASE_EMPTY, CUBIC_CASE_LINEAR)
from rmi_tpu_torch.models.base import ModelDef, leaf_columns, register
from rmi_tpu_torch.models.linear import linear_predict, spline_from_endpoints
from rmi_tpu_torch.ops import cubic_l1_kernel
from rmi_tpu_torch.utils import segments as seg


def cubic_predict(w, leaf_ids, x):
    """fma(fma(fma(a, x, b), x, c), x, d) with each element's row."""
    a, b, c, d = leaf_columns(w, leaf_ids)
    v = torch.addcmul(b, a, x)
    v = torch.addcmul(c, v, x)
    return torch.addcmul(d, v, x)


def _fma(a, b, c):
    """a * b + c rounded once (torch.addcmul is an exact FMA on the CPU)."""
    return torch.addcmul(c, a, b)


def _coeffs(xmin, ymin, xmax, ymax, m1, m2):
    """Closed-form a, b, c, d (cubic_spline.rs:74-99), with the FMAs
    that XLA contracts."""
    span = xmax - xmin
    span3 = span * span * span
    xx, nn, xn = xmax * xmax, xmin * xmin, xmax * xmin
    a = (m1 + m2 - 2.0) / span3
    # fma(xmax, 2 m1 + m2 - 3, xmin (m1 + 2 m2 - 3))
    b = -_fma(xmax, 2.0 * m1 + m2 - 3.0, xmin * (m1 + 2.0 * m2 - 3.0)) / span3
    # fma(xmax xmin, 2 m1 + 2 m2 - 6, fma(m1, xmax^2, m2 xmin^2))
    c = _fma(xn, 2.0 * m1 + 2.0 * m2 - 6.0, _fma(m1, xx, m2 * nn)) / span3
    # fma(xmin, xmin, fma(m1, xmax^2, xmax xmin (m2 - 3)))
    d = -xmin * _fma(xmin, xmin, _fma(m1, xx, xn * (m2 - 3.0))) / span3
    ys = ymax - ymin
    return a * ys, b * ys, c * ys, _fma(d, ys, ymin)     # d ys + ymin, contracted


def _slopes(xf, yf, xmin, ymin, xmax, ymax, degenerate):
    """Endpoint slopes (m1, m2) in the unit square, clamped to
    m1^2 + m2^2 <= 9 (cubic_spline.rs:46-72).  On the globally sorted
    keys the first point with x > xmin and the last with x < xmax are
    GLOBAL searches, clipped to the array but not to the leaf, as in
    rmi_tpu (cubic.py:81-89)."""
    n = xf.shape[0]
    i1 = torch.searchsorted(xf, xmin, right=True).clamp(0, n - 1)
    i2 = (torch.searchsorted(xf, xmax) - 1).clamp(0, n - 1)
    return slopes_from_points(xf[i1], yf[i1].double(), xf[i2], yf[i2].double(),
                              xmin, ymin, xmax, ymax, degenerate)


def slopes_from_points(x1, y1, x2, y2, xmin, ymin, xmax, ymax, degenerate):
    """_slopes' arithmetic from its two inner points (x1, y1), the first
    with x > xmin, and (x2, y2), the last with x < xmax, however they
    were found (parallel/dp_trainer.py gathers them across shards)."""
    safe_span = torch.where(degenerate, 1.0, xmax - xmin)
    safe_yspan = torch.where(ymax == ymin, 1.0, ymax - ymin)
    sxn = (x1 - xmin) / safe_span
    sxp = (x2 - xmin) / safe_span
    syp = (y2 - ymin) / safe_yspan
    # syn / sxn with syn = (y1 - ymin) / yspan, as XLA rewrites it
    m1 = (y1 - ymin) / (safe_yspan * torch.where(sxn == 0.0, 1.0, sxn))
    m2 = (1.0 - syp) / torch.where(sxp == 1.0, 1.0, 1.0 - sxp)
    norm2 = _fma(m1, m1, m2 * m2)          # m1 m1 + m2 m2, contracted
    tau = torch.where(norm2 > 9.0, 3.0 / torch.sqrt(norm2.clamp(min=1e-300)),
                      1.0)
    return m1 * tau, m2 * tau


def _fit_cubic_ranges(xf, yf, spans: seg.Spans, ep_y=None):
    """[B, 4] cubic rows over the augmented spans.  ``yf`` are the
    targets (f64, or the int32 FixDups positions of a leaf fit);
    ``ep_y`` = (first, last) overrides the y of the top container's
    endpoints, which bypass FixDups (cubic_spline.rs:38-41,
    models/mod.rs:268-274).  Each row is the cubic candidate, or the
    linear spline where its L1 error is lower (cubic_spline.rs:113-135)."""
    return fit_cubic_aux(xf, yf, spans, ep_y)[0]


def fit_cubic_aux(xf, yf, spans: seg.Spans, ep_y=None, keys=None,
                  key_type: keymod.KeyType = keymod.KeyType.U64):
    """(rows [B, 4], aux): _fit_cubic_ranges's rows and the generator
    statistics the raw conversion reads (rmi_tpu models/cubic.py:183-194):
    the endpoints xmin and xmax (the raw key floats of ``keys``, images
    of ``key_type`` keys, when given; the fit's inputs otherwise), ymin,
    ymax, the clamped slopes m1 and m2, and each row's case."""
    cubic_w, lin_w, st = _candidates(xf, yf, spans, ep_y)
    empty = st["empty"]
    if spans.B == 1:
        yd = yf.double()
        c_err = seg.whole_array_sum((cubic_predict(cubic_w, None, xf) - yd).abs_(), 0, spans.n)
        l_err = seg.whole_array_sum((linear_predict(lin_w, None, xf) - yd).abs_(), 0, spans.n)
    else:
        c_err, l_err = cubic_l1_kernel.cubic_l1_sums(xf, yf, cubic_w, lin_w, spans)
    w, use_lin = choose_candidates(cubic_w, lin_w, c_err, l_err, empty)

    case = torch.full_like(st["first"], CUBIC_CASE_CUBIC, dtype=torch.int32)
    case = torch.where(use_lin, CUBIC_CASE_LINEAR, case)
    case = torch.where(st["const_case"], CUBIC_CASE_CONST, case)
    case = torch.where(empty, CUBIC_CASE_EMPTY, case).to(torch.int32)
    first, last = st["first"], st["last"]
    if keys is None:
        xmin, xmax = xf[first], xf[last]
    else:
        xmin = keymod.as_float(keys[first], key_type)
        xmax = keymod.as_float(keys[last], key_type)
    aux = {"xmin": xmin, "xmax": xmax, "ymin": st["ymin"], "ymax": st["ymax"],
           "m1": st["m1"], "m2": st["m2"], "case": case}
    return w, aux


def _candidates(xf, yf, spans: seg.Spans, ep_y=None):
    """(cubic_w [B, 4], lin_w [B, 2], stats): each container's cubic with
    its special cases, the linear spline through its endpoints, and the
    statistics the fit's aux keeps ([B] each: the first and last indices,
    ymin, ymax, m1, m2, empty and const_case)."""
    first, last = seg.aug_first_last(spans)
    xmin, xmax = xf[first], xf[last]
    if ep_y is None:
        ymin, ymax = yf[first].double(), yf[last].double()
    else:
        ymin, ymax = torch.full_like(xmin, ep_y[0]), torch.full_like(xmin, ep_y[1])
    degenerate = xmin == xmax              # all duplicates or a single point
    m1, m2 = _slopes(xf, yf, xmin, ymin, xmax, ymax, degenerate)
    cubic_w, lin_w, st = candidates_from_slopes(xmin, ymin, xmax, ymax, m1, m2,
                                                seg.aug_count(spans))
    return cubic_w, lin_w, dict(st, first=first, last=last)


def candidates_from_slopes(xmin, ymin, xmax, ymax, m1, m2, cnt):
    """_candidates from each container's endpoints, clamped slopes and
    point count: (cubic_w, lin_w, the stats but the indices)."""
    a, b, c, d = _coeffs(xmin, ymin, xmax, ymax, m1, m2)
    # empty -> (0, 0, 1, 0); one point or all duplicates -> (0, 0, 0, y)
    # (cubic_spline.rs:19-36)
    empty = cnt == 0
    const_case = ~empty & ((cnt == 1) | (xmin == xmax))
    flat = empty | const_case
    zero = torch.zeros_like(a)
    cubic_w = torch.stack([
        torch.where(flat, zero, a), torch.where(flat, zero, b),
        torch.where(empty, 1.0, torch.where(const_case, zero, c)),
        torch.where(empty, zero, torch.where(const_case, ymin, d))], dim=-1)
    lin_w = torch.stack(spline_from_endpoints(xmin, ymin, xmax, ymax, cnt), dim=-1)
    return cubic_w, lin_w, {"ymin": ymin, "ymax": ymax, "m1": m1, "m2": m2,
                            "empty": empty, "const_case": const_case}


def choose_candidates(cubic_w, lin_w, c_err, l_err, empty):
    """Each row the cubic, or the linear spline as a cubic row where its
    L1 error is lower (cubic_spline.rs:113-135); and that choice."""
    use_lin = (l_err < c_err) & ~empty
    zero = torch.zeros_like(lin_w[:, 0])
    lin_as_cubic = torch.stack([zero, zero, lin_w[:, 1], lin_w[:, 0]], dim=-1)
    return torch.where(use_lin[:, None], lin_as_cubic, cubic_w), use_lin


def _const_cubic(value_f):
    """set_to_constant_model => (0, 0, 0, c) (cubic_spline.rs:188-191)."""
    z = torch.zeros_like(value_f)
    return torch.stack([z, z, z, value_f], dim=-1)


register(ModelDef(
    name="cubic", ppm=4,
    fit_top=lambda xf, yf, ep_first, ep_last: _fit_cubic_ranges(
        xf, yf, seg.whole_array_spans(xf.shape[0], xf.device),
        (ep_first, ep_last)),
    fit_leaves=_fit_cubic_ranges, predict=cubic_predict,
    constant_params=_const_cubic, leaf_kernel="cubic", bytes_per_model=32,
    function_name="cubic", fit_aux=fit_cubic_aux, needs_bounds_check=False))
