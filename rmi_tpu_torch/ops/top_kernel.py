"""Stage A of the build on the card (csrc/top.cu): after FixDups, the
model's float input, the cubic top's two L1 sums and the leaf
assignment, each one launch over the keys.

  key_normalize    x = (as_float(key) - offset) * scale, f64 [n]: one
                   launch of rmi_key_normalize, or key_normalize_plain
                   (models.base.normalize);
  top_l1_cubic     the cubic top's whole-array sums of |pred - y| for its
                   cubic and its linear-spline candidate, y the FixDups
                   positions scaled in the kernel: rmi_top_l1_cubic, or
                   top_l1_cubic_plain;
  top_assign       each key's leaf id, int32 [n]: rmi_top_assign, or
                   top_assign_plain (predict_top_assignment).

Counterpart of rmi_tpu/train/two_layer.py:176 (_assign_body), one XLA
program with no Pallas call of its own.  The normalization and the
assignment are bit-equal to their plain versions under every key type
and top the kernels take; the sums add in another order than the plain
whole-array sum, which on the CPU follows XLA's
(segments.whole_array_sum), and agree to K6's tolerance
(cubic_l1_kernel.sum_tolerance).  The kernel's sums are the same bits in
every run (csrc/top.cu says how).

A "raw" model (lognormal) reads the keys' f64 values, not normalized
ones, and predicts through log, whose CUDA rounding differs from glibc's
on a few keys (eval_kernel.fused_lookup): its input stays
keys.as_float and its top's assignment top_assign_plain, in torch on
every device.
"""

from __future__ import annotations

import sys

import torch

from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.models.base import (get_model, leaf_predict, normalize,
                                       predict_top_assignment)
from rmi_tpu_torch.ops import _build, eval_kernel
from rmi_tpu_torch.utils import segments as seg

_F64_EPS = sys.float_info.epsilon
# blocks of rmi_top_l1_cubic's first pass at most (csrc/top.cu kL1Blocks):
# its scratch holds two partial sums a block
L1_BLOCKS = 1024


def scales(sf: float) -> bool:
    """Whether map_scale! scales the targets (models/mod.rs:238-250): sf
    further than f64::EPSILON from 1."""
    return abs(sf - 1.0) > _F64_EPS


def scaled_targets(y: torch.Tensor, sf: float) -> torch.Tensor:
    """trunc(y * sf) in f64 of FixDups positions ``y``, or y itself where
    sf does not scale: the top fits' targets (two_layer._scale)."""
    y = y.double()
    return torch.trunc(y * sf) if scales(sf) else y


def key_normalize(keys: torch.Tensor, offset: float, scale: float,
                  key_type: KeyType = KeyType.U64) -> torch.Tensor:
    """[n] f64: (as_float(key) - offset) * scale of int64 images ``keys``
    of ``key_type`` keys, bit-equal to models.base.normalize."""
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError("key_normalize: keys must be 1-D int64 key images")
    if keys.is_cpu:
        return key_normalize_plain(keys, offset, scale, key_type)
    n = keys.shape[0]
    return _build.launch("rmi_key_normalize", keys, eval_kernel.key_kind(key_type), n, n,
                         float(offset), float(scale))


def key_normalize_plain(keys: torch.Tensor, offset: float, scale: float,
                        key_type: KeyType = KeyType.U64) -> torch.Tensor:
    """The plain PyTorch version: models.base.normalize."""
    return normalize(keys, offset, scale, key_type)


def top_l1_cubic_plain(x, yfix, sf: float, cubic_w, lin_w):
    """The plain PyTorch version: rmi_tpu's _abs_err_sum over the one span
    of _top_spans (rmi_tpu/models/cubic.py:298, :331) for each candidate,
    on the targets scaled_targets(yfix, sf) made whole, added as
    segments.whole_array_sum adds (on the CPU XLA's order, so that the top
    fit equals rmi_tpu's)."""
    y = scaled_targets(yfix, sf)
    n = x.shape[0]
    return tuple(seg.whole_array_sum((leaf_predict(kind, w, None, x) - y).abs_(), 0, n)
                 for kind, w in (("cubic", cubic_w), ("linear", lin_w)))


def _check_l1(x, yfix, cubic_w, lin_w):
    if x.dtype != torch.float64 or x.dim() != 1 or x.shape[0] < 1:
        raise ValueError("top_l1_cubic: x must be a non-empty 1-D float64 tensor")
    if yfix.dtype != torch.int32 or yfix.shape != x.shape:
        raise ValueError("top_l1_cubic: yfix must be int32 shaped like x")
    for name, w, width in (("cubic_w", cubic_w, 4), ("lin_w", lin_w, 2)):
        if w.dtype != torch.float64 or w.shape != (1, width):
            raise ValueError(f"top_l1_cubic: {name} must be a [1, {width}] float64 row")


def top_l1_cubic(x, yfix, sf: float, cubic_w, lin_w):
    """(c_err [1], l_err [1]) f64 over the n keys, with targets
    y = trunc(yfix * sf) (yfix itself where sf does not scale):
        c_err = sum |fma(fma(fma(a, x, b), x, c), x, d) - y|
        l_err = sum |fma(beta, x, alpha) - y|
    for the cubic row (a, b, c, d) = cubic_w[0] and the spline's
    (alpha, beta) = lin_w[0].  On the card the sums are the same bits in
    every run and lie within cubic_l1_kernel.sum_tolerance of the plain
    version's."""
    _check_l1(x, yfix, cubic_w, lin_w)
    if x.is_cpu:
        return top_l1_cubic_plain(x, yfix, sf, cubic_w, lin_w)
    _, sums = _build.launch("rmi_top_l1_cubic", x, yfix, x.shape[0], float(sf),
                            int(scales(sf)), cubic_w, lin_w, 2 * L1_BLOCKS, L1_BLOCKS, 2)
    return sums[:1], sums[1:]


def top_assign_plain(top_type: str, top_w, top_in: torch.Tensor, B: int) -> torch.Tensor:
    """The plain PyTorch version: predict_top_assignment to B - 1, as
    int32."""
    return predict_top_assignment(get_model(top_type), top_w, top_in, B - 1).to(torch.int32)


def top_assign(top_type: str, top_w, top_in: torch.Tensor, B: int) -> torch.Tensor:
    """[n] int32: min(B - 1, predict_to_int(top(x))) of each element of
    ``top_in``, the top's model_float_input (an integer top's: the
    integer-key images, and clamp_int of its prediction), bit-equal to
    top_assign_plain.  A lognormal top takes top_assign_plain on every
    device (the module docstring says why)."""
    mtop = get_model(top_type)
    if not 1 <= B <= eval_kernel.MAX_BOUND + 1:
        raise ValueError(f"top_assign: B = {B} outside [1, 2^31]")
    want = torch.int64 if mtop.output_int else torch.float64
    if top_in.dtype != want or top_in.dim() != 1:
        raise ValueError(f"top_assign: {top_type} takes a 1-D {want} input")
    if top_in.is_cpu or mtop.input_domain == "raw":
        return top_assign_plain(top_type, top_w, top_in, B)
    n, kind = top_in.shape[0], eval_kernel.top_kind(top_type)
    f64, i64, i32 = [torch.empty(0, dtype=t, device=top_in.device)
                     for t in (torch.float64, torch.int64, torch.int32)]
    if not mtop.output_int:
        if top_w.dtype != torch.float64 or top_w.shape != (1, mtop.ppm):
            raise ValueError(f"top_assign: {top_type} takes a [1, {mtop.ppm}] float64 row")
        return _build.launch("rmi_top_assign", top_in, i64, top_w, kind, i64, i32, i64, 0,
                             n, n, int(B))
    # lookup's operands (a hint table narrowed to B); the route is lookup's,
    # the assignment reads every operand in place
    _, top_int, table, pivots, top_len, _ = eval_kernel.top_operands(
        top_type, top_w, top_in.device, B, "linear")
    return _build.launch("rmi_top_assign", f64, top_in, f64, kind, top_int, table, pivots,
                         top_len, n, n, int(B))
