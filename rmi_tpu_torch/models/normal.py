"""Normal-CDF models: normal and lognormal (counterpart of
rmi_tpu/models/normal.py).

Parameters are (mean, stdev, scale) per container: stdev is the BIASED
standard deviation (divide by n, normal.rs:46-47) and scale the largest
target, which over non-decreasing FixDups targets is the last one of the
augmented range.  An empty container keeps the reference's values
(normal.rs:28-50 with n = 0): mean 0, stdev 0/0 = NaN, scale -inf; its
predictions are NaN, which clamp to 0, and rmi_tpu does not patch it
(two_layer.py:235-243).

Prediction is phi((x - mean) / stdev) * scale with the logistic
approximation phi(z) = 1 / (1 + exp1(-1.65451 z)) (normal.rs:24-26).

lognormal fits and predicts on the keys' raw f64 values (input_domain
"raw") and keeps rmi_tpu's quirk: training uses ln x with non-finite
logs mapped to 0 (normal.rs:58-68), prediction max(ln x, 0) with NaN
mapped to 0 (normal.rs:163-167).  The prediction's transform is
models.base.log_input: the sweep, the probes and lookup apply it outside
the kernels (kernel_input), which then serve lognormal leaves as normal
ones.
"""

from __future__ import annotations

import torch

from rmi_tpu_torch.models.base import ModelDef, leaf_columns, log_input, register
from rmi_tpu_torch.utils import segments as seg

# -1.65451 / 64: XLA folds the two constants of -1.65451 z / 64
_PHI_K64 = -1.65451 / 64.0


def phi(z):
    """1 / (1 + exp1(-1.65451 z)), rounded as rmi_tpu's phi under jit on
    the CPU, found by trial against jax.jit(rmi_tpu.models.normal.phi):
    XLA folds the constants into z * (-1.65451 / 64) and contracts each
    add that follows a multiply, so exp1's base is
    fma(z, -1.65451 / 64, 1) and 1 + exp1 is fma(b5, b5, 1), with b5 the
    fifth of the six squarings (csrc/leaf_eval.cuh pins the same two)."""
    one = z.new_ones(())
    b = torch.addcmul(one, z, z.new_tensor(_PHI_K64))
    for _ in range(5):
        b = b * b
    return 1.0 / torch.addcmul(one, b, b)


def normal_predict(w, leaf_ids, x):
    """phi((x - mean) / stdev) * scale with each element's row."""
    mean, stdev, scale = leaf_columns(w, leaf_ids)
    return phi((x - mean) / stdev) * scale


def lognormal_predict(w, leaf_ids, x):
    return normal_predict(w, leaf_ids, log_input(x))


def _ln_or_zero(x):
    """ln x with non-finite logs mapped to 0: lognormal's training input."""
    ln = torch.log(x)
    return torch.where(torch.isfinite(ln), ln, 0.0)


def _ncdf_ranges(xf, yf, spans: seg.Spans):
    """[B, 3] (mean, stdev, scale) per container; the variance runs in
    K2's variance-only variant for leaves (segments.aug_centered_dot)."""
    cnt = seg.aug_count(spans)
    safe_cnt = cnt.clamp(min=1.0)
    sx = seg.aug_sum(spans, xf)
    mean = torch.where(cnt == 0, 0.0, sx / safe_cnt)
    ss = seg.aug_centered_dot(spans, xf, mean)
    stdev = torch.sqrt(torch.where(cnt == 0, float("nan"),
                                   ss.clamp(min=0.0) / safe_cnt))
    scale = torch.where(cnt == 0, float("-inf"),
                        yf[seg.aug_first_last(spans)[1]].double())
    return torch.stack([mean, stdev, scale], dim=-1)


def _whole(xf):
    return seg.whole_array_spans(xf.shape[0], xf.device)


register(ModelDef(
    name="normal", ppm=3,
    fit_top=lambda xf, yf, ep_first, ep_last: _ncdf_ranges(xf, yf, _whole(xf)),
    fit_leaves=_ncdf_ranges, predict=normal_predict, constant_params=None,
    leaf_kernel="normal"))

register(ModelDef(
    name="lognormal", ppm=3,
    fit_top=lambda xf, yf, ep_first, ep_last: _ncdf_ranges(
        _ln_or_zero(xf), yf, _whole(xf)),
    fit_leaves=lambda xf, yfix, spans: _ncdf_ranges(_ln_or_zero(xf), yfix, spans),
    predict=lognormal_predict, constant_params=None, leaf_kernel="normal",
    input_domain="raw"))
