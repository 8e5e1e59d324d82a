"""Stage A of the build on the card (csrc/top.cu, csrc/top_fit.cu):
after FixDups, the model's float input, the top's fit and the leaf
assignment, each a launch over the keys with no host step between them.

  key_normalize         x = (as_float(key) - offset) * scale, f64 [n]: one
                        launch of rmi_key_normalize, or key_normalize_plain
                        (models.base.normalize);
  top_cubic_candidates  the cubic top's two candidates and fit statistics
                        (models/cubic._candidates over the whole array) in
                        one [CAND] f64 buffer: rmi_top_cubic_candidates, or
                        top_cubic_candidates_plain;
  top_l1_cubic          the candidates' whole-array sums of |pred - y|, y
                        the FixDups positions scaled in the kernel, the
                        chosen row and its case: rmi_top_l1_cubic, or
                        top_l1_cubic_plain;
  top_l1_partial        the same two sums over one rank's shard in the
                        data-parallel build, which adds them across ranks
                        and chooses: rmi_top_l1_partial, or
                        top_l1_partial_plain (the dp build's eager chain);
  top_moments           the linear, robust_linear and normal tops' whole
                        fit from the FixDups positions: rmi_top_moments,
                        or top_moments_plain (the model's fit_top);
  top_table_fit         a hint-table top's fit (radix8/18/22/26/28):
                        rmi_top_table_fit, or top_table_fit_plain;
  top_assign            each key's leaf id, int32 [n]: rmi_top_assign, or
                        top_assign_plain (predict_top_assignment).

Counterpart of rmi_tpu/train/two_layer.py:176 (_assign_body), one XLA
program with no Pallas call of its own.  The normalization, the cubic
candidates, the moments tops' rows, the hint tables and the assignment
are bit-equal to their plain versions on the CPU (the moments add in
XLA's order, as segments.whole_array_sum does there); the L1 sums add in
another order than the plain whole-array sum and agree to K6's
tolerance (cubic_l1_kernel.sum_tolerance), so the choice between the
candidates may differ only on a near tie.  Every kernel gives the same
bits in every run (csrc/top.cu and csrc/top_fit.cu say how).

A "raw" model (lognormal) reads the keys' f64 values, not normalized
ones, and predicts through log, whose CUDA rounding differs from glibc's
on a few keys (eval_kernel.fused_lookup): its input stays
keys.as_float and its top's assignment top_assign_plain, in torch on
every device; its fit, the loglinear, linear_spline, radix, bradix and
histogram tops' stay the model's fit_top in torch.
"""

from __future__ import annotations

import sys

import torch

from rmi_tpu_torch import keys as keymod
from rmi_tpu_torch.convert import (CUBIC_CASE_CONST, CUBIC_CASE_CUBIC,
                                   CUBIC_CASE_LINEAR)
from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.models.base import (get_model, leaf_predict, normalize,
                                       predict_top_assignment)
from rmi_tpu_torch.ops import _build, eval_kernel
from rmi_tpu_torch.utils import segments as seg

_F64_EPS = sys.float_info.epsilon
# blocks of rmi_top_l1_cubic's first pass at most (csrc/top.cu kL1Blocks):
# its scratch holds two partial sums a block
L1_BLOCKS = 1024
# rmi_top_cubic_candidates' buffer (csrc/top.cu kCand): the cubic row
# [0:4], the linear spline's (intercept, slope) [4:6], fit_cubic_aux's
# statistics at CAND_AUX, and 1.0 where the container is a constant case
CAND = 16
CAND_AUX = {"xmin": 6, "xmax": 7, "ymin": 8, "ymax": 9, "m1": 10, "m2": 11}
CAND_CONST = 12
# steps of aten's binary search that a round of rmi_top_cubic_candidates'
# warp searches takes (csrc/top.cu kSearchLevels): 2^SEARCH_LEVELS - 1
# midpoints read at once a round, one a lane
SEARCH_LEVELS = 5
# the tops rmi_top_moments fits, and its model argument for each
MOMENT_TOPS = {"linear": 0, "robust_linear": 0, "normal": 1}


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


def _check_fit(name, x, yfix):
    if x.dim() != 1 or x.shape[0] < 1:
        raise ValueError(f"{name}: want a non-empty 1-D input")
    if yfix.dtype != torch.int32 or yfix.shape != x.shape:
        raise ValueError(f"{name}: yfix must be int32 shaped like the keys")


def top_cubic_candidates_plain(x, yfix, sf: float, ep_y=None, keys=None,
                               key_type: KeyType = KeyType.U64):
    """The plain PyTorch version: models/cubic._candidates over the one
    span of the n keys, packed as the kernel writes them (CAND)."""
    from rmi_tpu_torch.models import cubic      # the models import this module
    n = x.shape[0]
    cubic_w, lin_w, st = cubic._candidates(x, yfix, seg.whole_array_spans(n, x.device),
                                           ep_y, sf)
    ends = x[[0, n - 1]] if keys is None else keymod.as_float(keys[[0, n - 1]], key_type)
    out = x.new_zeros(CAND)
    out[:CAND_CONST + 1] = torch.cat([cubic_w[0], lin_w[0], ends, st["ymin"], st["ymax"],
                                      st["m1"], st["m2"], st["const_case"].double()])
    return out


def top_cubic_candidates(x, yfix, sf: float, ep_y=None, keys=None,
                         key_type: KeyType = KeyType.U64):
    """[CAND] f64: the cubic fit's candidates over the n keys' normalized
    ``x`` and int32 FixDups positions ``yfix`` (the targets scaled by
    ``sf``): the endpoints' targets ``ep_y`` = (first, last) where given
    (the top's, which bypass FixDups), the two global searches for the
    inner points, the clamped slopes, the cubic's coefficients and the
    linear spline through the endpoints, with the aux statistics xmin and
    xmax (the raw floats of ``keys``, images of ``key_type`` keys, where
    given), ymin, ymax, m1, m2 and the constant case.  Bit-equal to
    top_cubic_candidates_plain."""
    _check_fit("top_cubic_candidates", x, yfix)
    if x.dtype != torch.float64:
        raise ValueError("top_cubic_candidates: x must be float64")
    if keys is not None and (keys.dtype != torch.int64 or keys.shape != x.shape):
        raise ValueError("top_cubic_candidates: keys must be int64 images shaped like x")
    if x.is_cpu:
        return top_cubic_candidates_plain(x, yfix, sf, ep_y, keys, key_type)
    ep0, ep1 = (0.0, 0.0) if ep_y is None else ep_y
    if keys is None:
        keys = torch.empty(0, dtype=torch.int64, device=x.device)
    return _build.launch("rmi_top_cubic_candidates", x, yfix, keys,
                         eval_kernel.key_kind(key_type), x.shape[0], float(sf),
                         int(scales(sf)), int(ep_y is not None), float(ep0), float(ep1), CAND)


def top_l1_cubic_plain(x, yfix, sf: float, cand):
    """The plain PyTorch version: rmi_tpu's _abs_err_sum over the one span
    of _top_spans (rmi_tpu/models/cubic.py:298, :331) for each candidate,
    on the targets scaled_targets(yfix, sf) made whole, added as
    segments.whole_array_sum adds (on the CPU XLA's order, so that the top
    fit equals rmi_tpu's), then models/cubic.choose_candidates and the
    case fit_cubic_aux gives."""
    from rmi_tpu_torch.models import cubic      # the models import this module
    y = scaled_targets(yfix, sf)
    n = x.shape[0]
    cubic_w, lin_w = cand[None, :4], cand[None, 4:6]
    c_err, l_err = (seg.whole_array_sum((leaf_predict(kind, w, None, x) - y).abs_(), 0, n)
                    for kind, w in (("cubic", cubic_w), ("linear", lin_w)))
    w, use_lin = cubic.choose_candidates(cubic_w, lin_w, c_err, l_err,
                                         torch.zeros(1, dtype=torch.bool, device=x.device))
    case = torch.where(cand[CAND_CONST:CAND_CONST + 1] != 0, CUBIC_CASE_CONST,
                       torch.where(use_lin, CUBIC_CASE_LINEAR, CUBIC_CASE_CUBIC))
    return torch.cat([c_err, l_err]), w, case.to(torch.int32)


def top_l1_cubic(x, yfix, sf: float, cand):
    """(sums [2], row [1, 4], case [1] int32) over the n keys, with targets
    y = trunc(yfix * sf) (yfix itself where sf does not scale):
        sums[0] = sum |fma(fma(fma(a, x, b), x, c), x, d) - y|
        sums[1] = sum |fma(beta, x, alpha) - y|
    for the cubic row (a, b, c, d) = cand[0:4] and the spline's (alpha,
    beta) = cand[4:6] of top_cubic_candidates' buffer ``cand``; the row
    the cubic, or the spline as (0, 0, beta, alpha) where sums[1] <
    sums[0], and its case (convert.CUBIC_CASE_*).  On the card the sums
    are the same bits in every run and lie within
    cubic_l1_kernel.sum_tolerance of the plain version's."""
    _check_fit("top_l1_cubic", x, yfix)
    if x.dtype != torch.float64:
        raise ValueError("top_l1_cubic: x must be float64")
    if cand.dtype != torch.float64 or cand.shape != (CAND,):
        raise ValueError(f"top_l1_cubic: cand must be a [{CAND}] float64 buffer")
    if x.is_cpu:
        return top_l1_cubic_plain(x, yfix, sf, cand)
    _, sums, row, case = _build.launch("rmi_top_l1_cubic", x, yfix, x.shape[0], float(sf),
                                       int(scales(sf)), cand, 2 * L1_BLOCKS, L1_BLOCKS, 2,
                                       (1, 4), 1)
    return sums, row, case


def top_l1_partial_plain(x, yfix, sf: float, cand, hi: int):
    """The plain PyTorch version, the data-parallel build's eager chain
    (parallel/dp_trainer._dist_cubic over the top's one span): each
    candidate's |pred - y| over the whole shard, y scaled_targets(yfix,
    sf), its f64 prefix sum and the difference at [0, hi)."""
    from rmi_tpu_torch.models.cubic import cubic_predict   # the models import this module
    from rmi_tpu_torch.models.linear import linear_predict
    y = scaled_targets(yfix, sf)
    sums = [seg.prefix_sum_exclusive((predict(w, None, x) - y).abs_())
            for predict, w in ((cubic_predict, cand[None, :4]), (linear_predict, cand[None, 4:6]))]
    return torch.stack([c[hi] - c[0] for c in sums])


def top_l1_partial(x, yfix, sf: float, cand, hi: int):
    """sums [2] f64: top_l1_cubic's two sums (cubic, linear) over rows [0,
    hi) of one rank's shard (its rows below n: the pads lie past them),
    with no choice: the partials the data-parallel build adds across ranks
    in rank order before choose_candidates.  On the card one launch of
    rmi_top_l1_partial over x[:hi] and yfix[:hi] (hi may be 0), its sums in
    rmi_top_l1_cubic's fixed tree, the same bits in every run, within
    cubic_l1_kernel.sum_tolerance of the plain version's."""
    _check_fit("top_l1_partial", x, yfix)
    if x.dtype != torch.float64:
        raise ValueError("top_l1_partial: x must be float64")
    if cand.dtype != torch.float64 or cand.shape != (CAND,):
        raise ValueError(f"top_l1_partial: cand must be a [{CAND}] float64 buffer")
    if not 0 <= hi <= x.shape[0]:
        raise ValueError(f"top_l1_partial: hi = {hi} outside [0, {x.shape[0]}]")
    if x.is_cpu:
        return top_l1_partial_plain(x, yfix, sf, cand, hi)
    _, sums = _build.launch("rmi_top_l1_partial", x[:hi], yfix[:hi], hi, float(sf),
                            int(scales(sf)), cand, 2 * L1_BLOCKS, L1_BLOCKS, 2)
    return sums


def top_span(top_type: str, n: int):
    """[lo, hi), the keys a moments top fits over: all n, or
    robust_linear's trimmed span (models/linear.trim_bounds of one span,
    on host tensors, so no device sync)."""
    if top_type != "robust_linear":
        return 0, n
    from rmi_tpu_torch.models import linear     # the models import this module
    lo, hi = linear.trim_bounds(torch.zeros(1, dtype=torch.int64),
                                torch.full((1,), n, dtype=torch.int64))
    return int(lo), int(hi)


def moments_scratch(n: int) -> int:
    """Doubles enough for rmi_top_moments' scratch at n keys: csrc/
    top_fit.cu's Tree owns the layout (the means, the window counters, two
    channels of sums from level 2 up, about n / 512 doubles) and the entry
    refuses a scratch smaller than Tree(n).doubles(); this bound holds it
    with room to spare at every n."""
    return 64 + n // 256


def top_moments_plain(top_type: str, x, yfix, sf: float):
    """The plain PyTorch version: the model's fit_top on the targets
    scaled_targets(yfix, sf) made whole (models/linear._slr_ranges,
    models/normal._ncdf_ranges over one span)."""
    return get_model(top_type).fit_top(x, scaled_targets(yfix, sf), None, None)


def top_moments(top_type: str, x, yfix, sf: float):
    """[1, ppm] f64: the fitted row of a linear, robust_linear or normal
    top over the keys' normalized ``x`` and int32 FixDups positions
    ``yfix``, the targets scaled by ``sf`` in the kernel (no [n] copy of
    them is made), robust_linear over top_span's trimmed keys.  Bit-equal
    to top_moments_plain on the CPU, whose whole-array sums follow XLA's
    order; the same bits in every run.

    On the card one rmi_top_moments call (csrc/top_fit.cu): a memset of
    the scratch's window counters, then a pass two kernels, bound by
    memory: each pass reads x and yfix, 12 bytes a key (8 for the normal
    top), twice in all since the centered sums need the means.  The first
    design (2.25 ms for a linear top at 200M keys on an H100, 1.26 for the
    normal one) spent 0.23-0.26 ms a pass in one-block tails that read the
    level-2 sums a window a thread through one SM, and its pass-1 grid held
    242 registers a thread (8 warps an SM, 0.75 of the pass's bound).
    This one walks the level-2 windows with each warp's next window
    streamed into shared memory by cp.async (no key in a register while in
    flight; 0.90-0.94 of the pass's bound), then adds the sums above level
    2 across the card (the warp that completes a window adds it, counted
    with an integer atomicAdd; 0.012 ms), whose last warp finishes the
    pass.  Counting the sums in during the walk cost a fence, which waits
    for the warp's copies in flight: 1.06-1.47 ms a pass."""
    if top_type not in MOMENT_TOPS:
        raise ValueError(f"top_moments: {top_type} is not one of {sorted(MOMENT_TOPS)}")
    _check_fit("top_moments", x, yfix)
    if x.dtype != torch.float64:
        raise ValueError("top_moments: x must be float64")
    if x.is_cpu:
        return top_moments_plain(top_type, x, yfix, sf)
    n = x.shape[0]
    lo, hi = top_span(top_type, n)
    cap = moments_scratch(n)
    _, row = _build.launch("rmi_top_moments", x, yfix, n, lo, hi, float(sf), int(scales(sf)),
                           MOMENT_TOPS[top_type], cap, cap, (1, get_model(top_type).ppm))
    return row


def top_table_fit_plain(images, yfix, sf: float, bits: int):
    """The plain PyTorch version: the hint-table model's fit_top on the
    targets scaled_targets(yfix, sf) made whole (models/radix.py)."""
    return get_model(f"radix{bits}").fit_top(images, scaled_targets(yfix, sf), None, None)


def top_table_fit(images, yfix, sf: float, bits: int):
    """A hint-table top's parameters {"w_int": [prefix, bits] int64,
    "table": [2^bits] int32} over the sorted integer-key images
    ``images`` (keys.int_image) and their int32 FixDups positions, the
    targets scaled by ``sf``: table[b] the target of the first key whose
    bucket is at least b, the size past the last key's bucket, table[0] =
    0.  Bit-equal to top_table_fit_plain.

    On the card one rmi_top_table_fit launch (csrc/top_fit.cu), bound by the
    latency of dependent reads and the count of random 64-byte blocks of
    the keys: a slot's first key is a search of n keys.  The first design
    (0.0885 ms for path 5's radix18 table at 200M keys on an H100) ran a
    binary search a slot over all n keys: log2(n) dependent reads, the
    last ~10 in the slot's own blocks.  This one still gives a thread a
    slot, searched from the keys' two ends, but reads a 64-byte block a
    round, placed by interpolation between the masked key bits known on
    either side: 4.4 reads a slot on path 5's keys
    (tools/count_torch_table_reads.py replays it)."""
    _check_fit("top_table_fit", images, yfix)
    if images.dtype != torch.int64:
        raise ValueError("top_table_fit: images must be int64")
    from rmi_tpu_torch.models import radix      # the models import this module
    if bits not in radix.TABLE_BITS:
        raise ValueError(f"top_table_fit: no hint table of {bits} bits")
    if images.is_cpu:
        return top_table_fit_plain(images, yfix, sf, bits)
    table, w_int = _build.launch("rmi_top_table_fit", images, yfix, images.shape[0], float(sf),
                                 int(scales(sf)), int(bits), 1 << bits, 2)
    return {"w_int": w_int, "table": table}


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
