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

The integer-output models (radix, bradix, the radix hint tables,
histogram) fit and predict on the keys' bits in plain torch, as rmi_tpu
computes them in XLA outside its kernels: their top assignment, the
hint-table leaf fit, and for hint-table leaves the per-key sweep and the
probes (int_sweep_leaf_max).  Float leaves under an integer top run the
kernels as under any other top.

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
from rmi_tpu_torch.models import clamp_int, get_model, predict_clamped, validate_spec
# normalize, model_float_input and predict_top_assignment live with the
# models, where lookup's kernel wrapper (ops/eval_kernel.py) reaches them
from rmi_tpu_torch.models.base import (kernel_input, model_float_input,  # noqa: F401
                                       normalize, predict_top_assignment)
from rmi_tpu_torch.ops import eval_kernel, sweep_kernel
from rmi_tpu_torch.utils import profiling
from rmi_tpu_torch.utils import segments as seg

_F64_EPS = sys.float_info.epsilon


def norm_constants(keys: torch.Tensor, key_type: KeyType = KeyType.U64):
    """(offset, scale) of the normalized key domain for sorted images of
    ``key_type`` keys: x' = (x - offset) * scale maps [min, max] onto
    [0, 1]."""
    return norm_from_ends(keys[[0, -1]], key_type)


def norm_from_ends(ends: torch.Tensor, key_type: KeyType = KeyType.U64):
    """norm_constants from the images [2] of the first and last key."""
    kmin, kmax = keymod.as_float(ends, key_type).tolist()
    span = kmax - kmin
    return kmin, (1.0 / span if span > 0 else 1.0)


def top_assignment(mtop, top_w, keys: torch.Tensor, kminf: float, s: float,
                   bound: int, key_type: KeyType = KeyType.U64) -> torch.Tensor:
    """predict_top_assignment of images of ``key_type`` keys: the build's
    leaf assignment and serving's top eval both come here."""
    return predict_top_assignment(
        mtop, top_w, model_float_input(mtop, keys, kminf, s, key_type), bound)


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


def _assign_body(top_in, yfix, *, top_type: str, B: int, keys=None,
                 key_type: KeyType = KeyType.U64):
    """Stage A after FixDups: top fit + leaf ids t (int32, non-decreasing),
    ``top_in`` the top's model_float_input (an integer-output top's: the
    integer-key images).  Returns (top_w, t, top_aux), top_aux the fit's
    generator statistics (fit_aux; xmin and xmax from ``keys``, images of
    ``key_type`` keys), or None for a model without them."""
    n = top_in.shape[0]
    mtop = get_model(top_type)
    sf = float(B) / float(n)                  # two_layer.rs:109
    ys_scaled = _scale(yfix.double(), sf)
    top_aux = None
    if mtop.output_int:
        top_w = mtop.fit_top(top_in, ys_scaled, B, sf)
    elif mtop.fit_aux is not None:
        top_w, top_aux = mtop.fit_aux(
            top_in, ys_scaled, seg.whole_array_spans(n, top_in.device),
            (_scale(0.0, sf), _scale(float(n - 1), sf)), keys, key_type)
    else:
        top_w = mtop.fit_top(top_in, ys_scaled, _scale(0.0, sf),
                             _scale(float(n - 1), sf))
    del ys_scaled
    t = predict_top_assignment(mtop, top_w, top_in, B - 1).to(torch.int32)
    return top_w, t, top_aux


def lower_bound_fills(spans: seg.Spans, keys: torch.Tensor,
                      key_type: KeyType, key_at=None):
    """next/prev-leaf fills of LowerBoundCorrection
    (lower_bound_correction.rs:30-80), all [B]-sized: the index and key
    of the next non-empty leaf's first row (T::max_value() past the
    last), and the key of the previous non-empty leaf's last row
    (T::zero_value() before the first), as images of ``key_type`` keys.
    ``key_at(idx)`` reads the keys at global indices (``keys[idx]`` when
    None; the data-parallel build gathers them across shards)."""
    if key_at is None:
        key_at = keys.__getitem__
    n = spans.n
    big = n + 1
    first_val = torch.where(spans.nonempty, spans.starts, big)
    suffix_min = torch.cummin(first_val.flip(0), 0).values.flip(0)
    next_start = torch.cat([suffix_min[1:], suffix_min.new_full((1,), big)])
    has_next_leaf = next_start < big
    next_idx = torch.where(has_next_leaf, next_start, n)
    safe = next_start.clamp(0, max(n - 1, 0))
    next_key = torch.where(has_next_leaf, key_at(safe), key_type.max_image)

    last_val = torch.where(spans.nonempty, spans.ends - 1, -1)
    prefix_max = torch.cummax(last_val, 0).values
    prev_last = torch.cat([prefix_max.new_full((1,), -1), prefix_max[:-1]])
    has_prev_leaf = prev_last >= 0
    prev_key = torch.where(has_prev_leaf, key_at(prev_last.clamp(min=0)),
                           key_type.zero_image)
    return next_idx, next_key, prev_key


def _fit_body(leaf_in, yfix, spans: seg.Spans, next_idx, *, leaf_type: str,
              keys=None, key_type: KeyType = KeyType.U64):
    """Stage B: leaf rows [B, ppm] fitted on the leaf's model_float_input,
    constant-patched where a leaf is empty, except the final leaf (the
    reference's loop stops at B-1) and the models without a constant
    form (loglinear, normal, lognormal, and the hint tables, whose fit
    reads the exact key bits and returns a dict).  Returns (rows, aux,
    patch): the fit's generator statistics (fit_aux, or None) and the
    [B] mask of patched leaves (None where nothing is patched), which
    the raw conversion reads."""
    mleaf = get_model(leaf_type)
    aux = None
    if mleaf.fit_aux is not None:
        w, aux = mleaf.fit_aux(leaf_in, yfix, spans, None, keys, key_type)
    else:
        w = mleaf.fit_leaves(leaf_in, yfix, spans)
    if mleaf.constant_params is None:
        return w, aux, None
    B = spans.B
    patch = ~spans.nonempty & (torch.arange(B, device=w.device) < B - 1)
    const_rows = mleaf.constant_params(next_idx.double())
    return torch.where(patch[:, None], const_rows, w), aux, patch


def _error_between(pred, target, n: int):
    """error_between (two_layer.rs:14-18): clamp both to n, abs diff."""
    return (pred.clamp(max=n) - target.clamp(max=n)).abs()


# keys per step of an integer leaf layer's sweep: bounds its per-key
# temporaries (rmi_tpu two_layer.py:257, its _SWEEP_CHUNK)
INT_SWEEP_CHUNK = 1 << 25


def int_sweep_errors(keys, yfix, t, leaf_p, n: int, *, leaf_type: str):
    """Per-key |min(leaf(key), n) - min(yfix, n)| of an integer-output
    leaf layer (rmi_tpu two_layer.py:270-274), int64, each key (its
    integer-key image, keys.int_image) through its leaf t."""
    pred = clamp_int(get_model(leaf_type).predict(leaf_p, t, keys), n)
    return _error_between(pred, yfix.long(), n)


def int_sweep_leaf_max(keys, yfix, spans: seg.Spans, leaf_p, *, leaf_type: str):
    """[B] int64: the per-leaf maximum of int_sweep_errors (0 for an
    empty leaf) of integer-key images ``keys``, INT_SWEEP_CHUNK keys at
    a time: plain torch on every device, as rmi_tpu sweeps these leaves
    in XLA."""
    n = spans.n
    out = torch.zeros(spans.B, dtype=torch.int64, device=keys.device)
    for i in range(0, n, INT_SWEEP_CHUNK):
        t = spans.t[i:i + INT_SWEEP_CHUNK]
        err = int_sweep_errors(keys[i:i + INT_SWEEP_CHUNK], yfix[i:i + INT_SWEEP_CHUNK],
                               t, leaf_p, n, leaf_type=leaf_type)
        out.scatter_reduce_(0, t.long(), err, "amax")
    return out


def sweep_body(keys, leaf_in, yfix, spans: seg.Spans, leaf_w, next_idx,
               next_key, prev_key, kminf: float, s: float, key_type: KeyType, *,
               leaf_type: str):
    """Stage C: per-leaf errors [B] int64 and error_metrics' [6] tensor, from the
    leaf's model_float_input ``leaf_in`` and the images ``keys`` of
    ``key_type`` keys.  The epsilon probes move an f64 key by the
    absolute f64::EPSILON (keys.minus_epsilon), as rmi_tpu's do
    (two_layer.py:300-322), not its image by 1."""
    n = spans.n
    mleaf = get_model(leaf_type)
    if mleaf.output_int:
        max_err = int_sweep_leaf_max(leaf_in, yfix, spans, leaf_w, leaf_type=leaf_type)
    else:
        max_err = sweep_kernel.sweep_leaf_max(kernel_input(mleaf, leaf_in), yfix,
                                              spans.starts, spans.ends, leaf_w, n,
                                              leaf_type=leaf_type).long()
    longest_run = sweep_kernel.span_run_max(keys, yfix, spans.starts,
                                            spans.ends).long()
    return final_errors(max_err, longest_run, spans, leaf_w, next_idx, next_key,
                        prev_key, kminf, s, key_type, leaf_type=leaf_type)


def final_errors(max_err, longest_run, spans: seg.Spans, leaf_w, next_idx, next_key,
                 prev_key, kminf: float, s: float, key_type: KeyType, *,
                 leaf_type: str):
    """Stage C's tail, from the per-leaf maxima of the sweep [B] and of
    the counted duplicate runs [B] (int64): the epsilon probes, the
    per-leaf errors [B] int64 and error_metrics' [6] tensor."""
    n, B = spans.n, spans.B
    mleaf = get_model(leaf_type)
    # epsilon probes (two_layer.rs:226-259)
    leaf_ids = torch.arange(B, device=max_err.device)

    def probe(probe_keys):
        x = model_float_input(mleaf, probe_keys, kminf, s, key_type)
        if mleaf.output_int:
            return clamp_int(mleaf.predict(leaf_w, leaf_ids, x), n)
        x = kernel_input(mleaf, x)
        return eval_kernel.leaf_eval_clamped(x, leaf_w, leaf_ids, n,
                                             leaf_type=leaf_type).long()

    pred_up = probe(keymod.minus_epsilon(next_key, key_type))
    pred_lo = probe(keymod.plus_epsilon(prev_key, key_type))

    upper_err = _error_between(pred_up, next_idx + 1, n)
    first_idx = next_idx[(leaf_ids - 1).clamp(min=0)]
    lower_err = _error_between(pred_lo, first_idx, n)
    final_err = torch.maximum(torch.maximum(max_err, upper_err),
                              lower_err) + longest_run
    return final_err, error_metrics(final_err, spans.ends - spans.starts, n)


METRIC_NAMES = ("model_max_error", "model_max_error_idx", "model_avg_error",
                "model_avg_l2_error", "model_avg_log2_error", "model_max_log2_error")


def error_metrics(final_err: torch.Tensor, cnt: torch.Tensor, n: int) -> torch.Tensor:
    """The reference's metrics (two_layer.rs:266-287) from per-leaf
    errors and per-leaf key counts: one [6] f64 tensor on their device,
    in METRIC_NAMES' order (metrics_dict reads its host copy)."""
    B = final_err.shape[0]
    cnt_f = cnt.double()
    err_f = final_err.double()
    mx = final_err.max()
    return torch.stack([
        mx.double(),
        # Rust max_by_key returns the LAST maximal element
        ((B - 1) - torch.argmax(final_err.flip(0))).double(),
        (cnt_f * err_f).sum() / n,
        ((cnt_f * err_f) ** 2 / n).sum(),
        (cnt_f * torch.log2(2.0 * err_f + 2.0)).sum() / n,
        torch.log2(mx.double()),
    ])


def metrics_dict(vals) -> dict:
    """error_metrics' values, on the host (a numpy array or a list), as
    the dict TrainedRMI takes: the max error and its leaf as ints."""
    vals = [float(v) for v in vals]
    out = dict(zip(METRIC_NAMES, vals))
    out["model_max_error"] = int(vals[0])
    out["model_max_error_idx"] = int(vals[1])
    return out


def shared_inputs(keys: torch.Tensor, key_type: KeyType = KeyType.U64) -> dict:
    """What every build over the same sorted key images computes alike,
    for train_two_layer's keywords: ``norm`` (norm_constants, one host
    transfer) and ``yfix`` (FixDups, int32 [n] on the keys' device: 4
    bytes a key).  A sweep computes them once per dataset and device."""
    return {"norm": norm_constants(keys, key_type), "yfix": fixdups_i32(keys)}


def train_two_layer(keys: torch.Tensor, key_type: KeyType, top_type: str,
                    leaf_type: str, B: int, norm=None, yfix=None) -> dict:
    """Build a two-layer RMI over sorted key images on their device.

    ``norm`` and ``yfix`` are shared_inputs' of the same keys, computed
    here when not given; the build is the same bits either way.  Returns
    top_w [1, ppm] and leaf_w [B, ppm] (normalized domain; an
    integer-output model's parameter dict instead), leaf_errors [B]
    int64, ``metrics`` (error_metrics' [6] tensor, on the device: the
    build makes no transfer for it), norm_offset/norm_scale, and what the
    raw conversion reads: top_aux and leaf_aux (a cubic fit's generator
    statistics, else None), the patch mask (None where nothing is
    patched) and next_idx, the patched leaves' values.  Under
    RMI_PROFILE_BUILD=1 each stage is timed (utils/profiling.py).
    """
    validate_spec([top_type, leaf_type])
    n = keys.shape[0]
    if n >= 2**31:
        raise ValueError("single-device builds support < 2^31 rows")
    if yfix is not None and (yfix.shape != keys.shape or yfix.device != keys.device):
        raise ValueError("yfix must be FixDups of these keys, on their device")
    B = int(B)
    # the record_function ranges name the stages in a torch.profiler trace
    mtop, mleaf = get_model(top_type), get_model(leaf_type)
    timed = profiling.requested()
    with record_function("rmi.build.assign"), profiling.phase("assign", timed, keys.device):
        kminf, s = norm_constants(keys, key_type) if norm is None else norm
        top_in = model_float_input(mtop, keys, kminf, s, key_type)
        if yfix is None:
            yfix = fixdups_i32(keys)
        top_w, t, top_aux = _assign_body(top_in, yfix, top_type=top_type, B=B,
                                         keys=keys, key_type=key_type)
    with record_function("rmi.build.fit"), profiling.phase("fit", timed, keys.device):
        leaf_in = (top_in if mleaf.input_domain == mtop.input_domain
                   else model_float_input(mleaf, keys, kminf, s, key_type))
        del top_in
        spans = seg.make_spans(t, B)
        next_idx, next_key, prev_key = lower_bound_fills(spans, keys, key_type)
        leaf_w, leaf_aux, patch = _fit_body(leaf_in, yfix, spans, next_idx,
                                            leaf_type=leaf_type, keys=keys,
                                            key_type=key_type)
    with record_function("rmi.build.sweep"), profiling.phase("sweep", timed, keys.device):
        leaf_errors, metrics = sweep_body(keys, leaf_in, yfix, spans, leaf_w,
                                          next_idx, next_key, prev_key, kminf,
                                          s, key_type, leaf_type=leaf_type)
    return {"top_w": top_w, "leaf_w": leaf_w, "leaf_errors": leaf_errors,
            "metrics": metrics, "norm_offset": kminf, "norm_scale": s,
            "top_aux": top_aux, "leaf_aux": leaf_aux, "patch": patch,
            "next_idx": next_idx}
