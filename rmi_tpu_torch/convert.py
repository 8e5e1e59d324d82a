"""Parameter-domain conversion: normalized (device) <-> raw (artifact),
the port's copy of rmi_tpu/convert.py, kept operation for operation:
the artifact's bytes depend on every rounding here.

Device fits and serving run in a normalized key domain
x' = (x - key_min) * (1 / key_span), so that per-leaf moments never
touch 2^63-magnitude products.  The ARTIFACT keeps the reference's
raw-domain parameter layout, so the generated C++ and the native
runtime evaluate exactly what the reference would.  Conversion runs on
the host in IEEE f64 (numpy).

Affine models (the linear family, the normal CDF) convert in closed
form; the cubic's raw coefficients are recomputed from its generator
statistics (endpoints and endpoint slopes m1/m2, models/cubic.py's
fit_cubic_aux) with the reference's own formulas, reproducing even
their cancellation on huge-offset keys.
"""

from __future__ import annotations

import numpy as np

# cubic case codes exported by the fit (models/cubic.py)
CUBIC_CASE_CUBIC = 0
CUBIC_CASE_LINEAR = 1      # L1 fallback chose the endpoint spline
CUBIC_CASE_CONST = 2       # single point / all duplicates
CUBIC_CASE_EMPTY = 3       # empty container -> (0,0,1,0)


def _affine_raw_from_norm(w_norm: np.ndarray, kmin: float, s: float):
    """(alpha', beta') in x' = (x-kmin)*s  ->  raw (alpha, beta)."""
    out = np.array(w_norm, dtype=np.float64, copy=True)
    beta_r = out[..., 1] * s
    out[..., 0] = out[..., 0] - beta_r * kmin
    out[..., 1] = beta_r
    return out


def _affine_norm_from_raw(w_raw: np.ndarray, kmin: float, s: float):
    out = np.array(w_raw, dtype=np.float64, copy=True)
    span = 1.0 / s if s != 0 else 1.0
    out[..., 0] = out[..., 0] + out[..., 1] * kmin
    out[..., 1] = out[..., 1] * span
    return out


def _normal_raw_from_norm(w_norm, kmin, s):
    out = np.array(w_norm, dtype=np.float64, copy=True)
    span = 1.0 / s if s != 0 else 1.0
    out[..., 0] = out[..., 0] * span + kmin
    out[..., 1] = out[..., 1] * span
    return out


def _normal_norm_from_raw(w_raw, kmin, s):
    out = np.array(w_raw, dtype=np.float64, copy=True)
    out[..., 0] = (out[..., 0] - kmin) * s
    out[..., 1] = out[..., 1] * s
    return out


def cubic_raw_from_aux(aux: dict) -> np.ndarray:
    """Raw (a,b,c,d) per model from generator stats, using the
    reference's closed forms (cubic_spline.rs:74-99) in host f64."""
    xmin = np.asarray(aux["xmin"], dtype=np.float64)
    ymin = np.asarray(aux["ymin"], dtype=np.float64)
    xmax = np.asarray(aux["xmax"], dtype=np.float64)
    ymax = np.asarray(aux["ymax"], dtype=np.float64)
    m1 = np.asarray(aux["m1"], dtype=np.float64)
    m2 = np.asarray(aux["m2"], dtype=np.float64)
    case = np.asarray(aux["case"])

    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        span3 = (xmax - xmin) ** 3
        a = (m1 + m2 - 2.0) / span3
        b = -(xmax * (2.0 * m1 + m2 - 3.0)
              + xmin * (m1 + 2.0 * m2 - 3.0)) / span3
        c = (m1 * xmax ** 2 + m2 * xmin ** 2
             + xmax * xmin * (2.0 * m1 + 2.0 * m2 - 6.0)) / span3
        d = -xmin * (m1 * xmax ** 2 + xmax * xmin * (m2 - 3.0)
                     + xmin ** 2) / span3
        ys = ymax - ymin
        a, b, c, d = a * ys, b * ys, c * ys, d * ys + ymin

        # L1-fallback rows: the endpoint spline (cubic_spline.rs:128-134)
        dx = np.where(xmax == xmin, 1.0, xmin - xmax)
        slope = (ymin - ymax) / dx
        intercept = ymin - slope * xmin

    out = np.stack([a, b, c, d], axis=-1)
    z = np.zeros_like(a)
    lin_rows = np.stack([z, z, slope, intercept], axis=-1)
    const_rows = np.stack([z, z, z, ymin], axis=-1)
    empty_rows = np.stack([z, z, np.ones_like(a), z], axis=-1)
    out = np.where((case == CUBIC_CASE_LINEAR)[..., None], lin_rows, out)
    out = np.where((case == CUBIC_CASE_CONST)[..., None], const_rows, out)
    out = np.where((case == CUBIC_CASE_EMPTY)[..., None], empty_rows, out)
    return out


def raw_leaf_params(leaf_type: str, device_params, aux, patch_mask,
                    patch_values, kmin: float, s: float) -> np.ndarray:
    """Raw-domain [B, ppm] leaf parameters for the artifact."""
    dev = np.asarray(device_params, dtype=np.float64)
    if leaf_type in ("linear", "robust_linear", "linear_spline",
                     "loglinear"):
        raw = _affine_raw_from_norm(dev, kmin, s)
    elif leaf_type in ("normal",):
        raw = _normal_raw_from_norm(dev, kmin, s)
    elif leaf_type == "lognormal":
        raw = dev.copy()           # fit runs in raw ln-domain already
    elif leaf_type == "cubic":
        raw = cubic_raw_from_aux(aux)
    else:
        raise ValueError(leaf_type)

    if patch_mask is not None:
        pm = np.asarray(patch_mask)
        pv = np.asarray(patch_values, dtype=np.float64)
        if leaf_type == "cubic":
            rows = np.zeros_like(raw)
            rows[..., 3] = pv
        else:
            rows = np.zeros_like(raw)
            rows[..., 0] = pv
        raw = np.where(pm[..., None], rows, raw)
    return raw


def raw_top_params(top_type: str, device_params: dict, aux,
                   kmin: float, s: float) -> dict:
    """Raw-domain top parameters (int models pass through)."""
    if top_type in ("linear", "robust_linear", "linear_spline",
                    "loglinear"):
        return {"w": _affine_raw_from_norm(
            np.asarray(device_params["w"]), kmin, s)}
    if top_type == "normal":
        return {"w": _normal_raw_from_norm(
            np.asarray(device_params["w"]), kmin, s)}
    if top_type == "lognormal":
        return {"w": np.asarray(device_params["w"], dtype=np.float64)}
    if top_type == "cubic":
        return {"w": cubic_raw_from_aux(aux)}
    return {k: np.asarray(v) for k, v in device_params.items()}


def device_leaf_params(leaf_type: str, raw: np.ndarray, kmin: float,
                       s: float) -> np.ndarray:
    """Normalized-domain params from raw (for load_artifact)."""
    if leaf_type in ("linear", "robust_linear", "linear_spline",
                     "loglinear"):
        return _affine_norm_from_raw(raw, kmin, s)
    if leaf_type == "normal":
        return _normal_norm_from_raw(raw, kmin, s)
    if leaf_type == "lognormal":
        return np.asarray(raw, dtype=np.float64)
    if leaf_type == "cubic":
        # compose p(x) with x = x'/s + kmin (host f64; accuracy is
        # bounded by the raw coefficients' own conditioning)
        a = raw[..., 0]
        b = raw[..., 1]
        c = raw[..., 2]
        d = raw[..., 3]
        span = 1.0 / s if s != 0 else 1.0
        t0 = kmin
        an = a * span ** 3
        bn = (3.0 * a * t0 + b) * span ** 2
        cn = (3.0 * a * t0 ** 2 + 2.0 * b * t0 + c) * span
        dn = ((a * t0 + b) * t0 + c) * t0 + d
        return np.stack([an, bn, cn, dn], axis=-1)
    raise ValueError(leaf_type)


def device_top_params(top_type: str, raw: dict, kmin: float,
                      s: float) -> dict:
    if top_type in ("linear", "robust_linear", "linear_spline",
                    "loglinear", "normal", "lognormal", "cubic"):
        return {"w": device_leaf_params(top_type, np.asarray(raw["w"]),
                                        kmin, s)}
    return raw
