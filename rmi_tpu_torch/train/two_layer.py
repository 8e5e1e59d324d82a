"""Two-layer RMI build (counterpart of rmi_tpu/train/two_layer.py).

The reference streams the sorted keys four times (top fit, leaf
partition and fit, lower-bound correction, error sweep; two_layer.rs:
101-306).  Here each pass is a batched tensor program on the keys'
device, in three stages whose per-key temporaries are freed before the
next stage allocates:

  A  FixDups (kernel K1) + top fit + leaf assignment;
  B  per-leaf fits over overlap-augmented spans (kernel K2 for linear,
     loglinear and normal leaves, K6 for cubic ones) + lower-bound fills
     + empty-leaf patch;
  C  per-leaf error sweep (K3) + epsilon probes (K4) + the longest
     duplicate run per leaf (the run-length pass) + the reference's error
     metrics.

There is one build path: native f64 in the normalized key domain
x' = (x - key_min) * (1 / key_span) (the keys' raw f64 values for a
"raw" model, lognormal), with no staged, B-generic, df64 or
window-overflow variants.  The quirks of the JAX build are kept: the
array's final duplicate run is never flushed (lower_bound_correction.rs:
104-125) and the final leaf is never constant-patched
(two_layer.rs:182-202).
"""

from __future__ import annotations

import math
import sys

import torch
from torch.profiler import record_function

from rmi_tpu_torch import keys as keymod
from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.models import get_model, predict_clamped, validate_spec
# normalize, model_float_input and predict_top_assignment live with the
# models, where lookup's kernel wrapper (ops/eval_kernel.py) reaches them
from rmi_tpu_torch.models.base import (kernel_input, model_float_input,  # noqa: F401
                                       normalize, predict_top_assignment)
from rmi_tpu_torch.ops import eval_kernel, sweep_kernel
from rmi_tpu_torch.utils import segments as seg

_F64_EPS = sys.float_info.epsilon


def norm_constants(keys: torch.Tensor):
    """(offset, scale) of the normalized key domain for sorted key images:
    x' = (x - offset) * scale maps [min, max] onto [0, 1]."""
    kmin, kmax = keymod.as_float(keys[[0, -1]]).tolist()
    span = kmax - kmin
    return kmin, (1.0 / span if span > 0 else 1.0)


def top_assignment(mtop, top_w, keys: torch.Tensor, kminf: float, s: float,
                   bound: int) -> torch.Tensor:
    """predict_top_assignment of key images: the build's leaf assignment
    and serving's top eval both come here."""
    return predict_top_assignment(mtop, top_w,
                                  model_float_input(mtop, keys, kminf, s), bound)


def fixdups_i32(keys: torch.Tensor) -> torch.Tensor:
    """First-occurrence index per key as int32 (FixDups,
    models/mod.rs:143-185)."""
    n = keys.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=keys.device)
    changed = torch.ones(n, dtype=torch.bool, device=keys.device)
    torch.ne(keys[1:], keys[:-1], out=changed[1:])
    return seg.blocked_cummax(torch.where(changed, idx, 0))


def _scale(v, sf: float):
    """map_scale! (models/mod.rs:238-250): targets scaled by B/n and
    truncated; identity when sf == 1."""
    if abs(sf - 1.0) > _F64_EPS:
        return torch.trunc(v * sf) if torch.is_tensor(v) else float(math.trunc(v * sf))
    return v


def _assign_body(top_in, yfix, *, top_type: str, B: int):
    """Stage A after FixDups: top fit + leaf ids t (int32, non-decreasing),
    ``top_in`` the top's model_float_input."""
    n = top_in.shape[0]
    mtop = get_model(top_type)
    sf = float(B) / float(n)                  # two_layer.rs:109
    ys_scaled = _scale(yfix.double(), sf)
    top_w = mtop.fit_top(top_in, ys_scaled, _scale(0.0, sf),
                         _scale(float(n - 1), sf))
    del ys_scaled
    t = predict_top_assignment(mtop, top_w, top_in, B - 1).to(torch.int32)
    return top_w, t


def lower_bound_fills(spans: seg.Spans, keys: torch.Tensor,
                      key_type: KeyType):
    """next/prev-leaf fills of LowerBoundCorrection
    (lower_bound_correction.rs:30-80), all [B]-sized: the index and key
    of the next non-empty leaf's first row, and the key of the previous
    non-empty leaf's last row."""
    n = spans.n
    big = n + 1
    first_val = torch.where(spans.nonempty, spans.starts, big)
    suffix_min = torch.cummin(first_val.flip(0), 0).values.flip(0)
    next_start = torch.cat([suffix_min[1:], suffix_min.new_full((1,), big)])
    has_next_leaf = next_start < big
    next_idx = torch.where(has_next_leaf, next_start, n)
    safe = next_start.clamp(0, max(n - 1, 0))
    next_key = torch.where(has_next_leaf, keys[safe], key_type.max_image)

    last_val = torch.where(spans.nonempty, spans.ends - 1, -1)
    prefix_max = torch.cummax(last_val, 0).values
    prev_last = torch.cat([prefix_max.new_full((1,), -1), prefix_max[:-1]])
    has_prev_leaf = prev_last >= 0
    prev_key = torch.where(has_prev_leaf, keys[prev_last.clamp(min=0)],
                           keymod.IMAGE_MIN)
    return next_idx, next_key, prev_key


def _fit_body(leaf_in, yfix, spans: seg.Spans, next_idx, *, leaf_type: str):
    """Stage B: leaf rows [B, ppm] fitted on the leaf's model_float_input,
    constant-patched where a leaf is empty, except the final leaf (the
    reference's loop stops at B-1) and the models without a constant
    form (loglinear, normal, lognormal)."""
    mleaf = get_model(leaf_type)
    w = mleaf.fit_leaves(leaf_in, yfix, spans)
    if mleaf.constant_params is None:
        return w
    B = spans.B
    patch = ~spans.nonempty & (torch.arange(B, device=w.device) < B - 1)
    const_rows = mleaf.constant_params(next_idx.double())
    return torch.where(patch[:, None], const_rows, w)


def _error_between(pred, target, n: int):
    """error_between (two_layer.rs:14-18): clamp both to n, abs diff."""
    return (pred.clamp(max=n) - target.clamp(max=n)).abs()


def sweep_body(keys, leaf_in, yfix, spans: seg.Spans, leaf_w, next_idx,
               next_key, prev_key, kminf: float, s: float, key_type: KeyType, *,
               leaf_type: str):
    """Stage C: per-leaf errors [B] int64 and the metrics dict, from the
    leaf's model_float_input ``leaf_in``."""
    n, B = spans.n, spans.B
    mleaf = get_model(leaf_type)
    max_err = sweep_kernel.sweep_leaf_max(kernel_input(mleaf, leaf_in), yfix,
                                          spans.starts, spans.ends, leaf_w, n,
                                          leaf_type=leaf_type).long()

    # epsilon probes (two_layer.rs:226-259)
    leaf_ids = torch.arange(B, device=leaf_w.device)

    def probe(probe_keys):
        x = kernel_input(mleaf, model_float_input(mleaf, probe_keys, kminf, s))
        return eval_kernel.leaf_eval_clamped(x, leaf_w, leaf_ids, n,
                                             leaf_type=leaf_type).long()

    pred_up = probe(keymod.minus_epsilon(next_key, key_type))
    pred_lo = probe(keymod.plus_epsilon(prev_key, key_type))

    longest_run = sweep_kernel.span_run_max(keys, yfix, spans.starts,
                                            spans.ends).long()
    upper_err = _error_between(pred_up, next_idx + 1, n)
    first_idx = next_idx[(leaf_ids - 1).clamp(min=0)]
    lower_err = _error_between(pred_lo, first_idx, n)
    final_err = torch.maximum(torch.maximum(max_err, upper_err),
                              lower_err) + longest_run
    return final_err, error_metrics(final_err, spans.ends - spans.starts, n)


def error_metrics(final_err: torch.Tensor, cnt: torch.Tensor, n: int) -> dict:
    """The reference's metrics (two_layer.rs:266-287) from per-leaf
    errors and per-leaf key counts, fetched in one transfer."""
    B = final_err.shape[0]
    cnt_f = cnt.double()
    err_f = final_err.double()
    mx = final_err.max()
    vals = torch.stack([
        mx.double(),
        # Rust max_by_key returns the LAST maximal element
        ((B - 1) - torch.argmax(final_err.flip(0))).double(),
        (cnt_f * err_f).sum() / n,
        ((cnt_f * err_f) ** 2 / n).sum(),
        (cnt_f * torch.log2(2.0 * err_f + 2.0)).sum() / n,
        torch.log2(mx.double()),
    ]).tolist()
    return {
        "model_max_error": int(vals[0]),
        "model_max_error_idx": int(vals[1]),
        "model_avg_error": vals[2],
        "model_avg_l2_error": vals[3],
        "model_avg_log2_error": vals[4],
        "model_max_log2_error": vals[5],
    }


def train_two_layer(keys: torch.Tensor, key_type: KeyType, top_type: str,
                    leaf_type: str, B: int) -> dict:
    """Build a two-layer RMI over sorted key images on their device.

    Returns top_w [1, ppm] and leaf_w [B, ppm] (normalized domain),
    leaf_errors [B] int64, the metrics dict, and norm_offset/norm_scale.
    """
    validate_spec([top_type, leaf_type])
    n = keys.shape[0]
    if n >= 2**31:
        raise ValueError("single-device builds support < 2^31 rows")
    B = int(B)
    # the record_function ranges name the stages in a torch.profiler trace
    mtop, mleaf = get_model(top_type), get_model(leaf_type)
    with record_function("rmi.build.assign"):
        kminf, s = norm_constants(keys)
        top_in = model_float_input(mtop, keys, kminf, s)
        yfix = fixdups_i32(keys)
        top_w, t = _assign_body(top_in, yfix, top_type=top_type, B=B)
    with record_function("rmi.build.fit"):
        leaf_in = (top_in if mleaf.input_domain == mtop.input_domain
                   else model_float_input(mleaf, keys, kminf, s))
        del top_in
        spans = seg.make_spans(t, B)
        next_idx, next_key, prev_key = lower_bound_fills(spans, keys, key_type)
        leaf_w = _fit_body(leaf_in, yfix, spans, next_idx, leaf_type=leaf_type)
    with record_function("rmi.build.sweep"):
        leaf_errors, metrics = sweep_body(keys, leaf_in, yfix, spans, leaf_w,
                                          next_idx, next_key, prev_key, kminf,
                                          s, key_type, leaf_type=leaf_type)
    return {"top_w": top_w, "leaf_w": leaf_w, "leaf_errors": leaf_errors,
            "metrics": metrics, "norm_offset": kminf, "norm_scale": s}
