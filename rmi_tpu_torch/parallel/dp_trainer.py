"""Data-parallel two-layer build over the ranks of a torch.distributed
group (counterpart of rmi_tpu/parallel/dp_trainer.py).

The sorted key array is cut into one equal shard per rank (``local_shard``:
rank r holds global rows [r m, (r + 1) m), the last shard padded with
max-key sentinels), each rank calls ``dp_train_two_layer`` on its shard,
and every rank gets the same index back.  Per-leaf [B] statistics are
replicated; every pass over the keys runs on the rank's shard alone and
is joined by a few collectives:

  * ``global_range_sum``    sums over global ranges, from the shard's
                            fixed-order prefix sums;
  * ``global_value_at``     the owner's value, zero elsewhere, summed;
  * ``global_searchsorted`` local counts, summed (leaf ids and keys are
                            globally sorted);

and the runs of equal keys that cross shards as carries: every rank's
first and last key and the ends of its first and last run (shard_edges:
two binary searches) gathered in one collective, the running max and min
across the ranks taken by K1 over that [world] vector (run_carries).
The passes over a rank's m keys are the port's kernels: FixDups
with its carry (rmi_fixdups_carry), the normalization and the leaf
assignment (stage A's), the cubic top's L1 sums over the shard's rows
below n (rmi_top_l1_partial), each leaf's sums over its clip of the
leaf's augmented span (rmi_aug_fit_sums: the linear family, loglinear
and normal leaves) and, about the means those sums give once added
across ranks, its centered moments over the clip (K2, reading the int32
FixDups targets; K2 xx for the normal models), K6 for cubic leaves, the
error sweep (K3) and the counted duplicate runs (rmi_span_run_max_carry)
over the rank's clips; the partials are added across ranks, the maxima
met in one all_reduce(MAX); the epsilon probes (K4) and the metrics run
on the replicated [B] statistics as in the single-device build
(train/two_layer.final_errors).  The pads are the shard's rows past n
(a count, never a mask).  What stays eager over [m]: the one-span fits of
the linear-family, loglinear, normal and lognormal tops (the scaled
targets and whole-shard prefix sums), lognormal leaves' max(ln x, 0),
and the radix and bradix tops' bit arithmetic.

Floats are added in a fixed order, so a build over a fixed world and
fixed shapes gives the same bits every time and on every rank: a
shard's sums in its row-scan order (utils/segments.prefix_sum_exclusive,
what the CPU runs: each kernel's plain version is that eager chain) or
its kernel's, and the ranks' partial sums gathered and added in rank
order (``DPGroup.sum_f64``).  Integer sums, maxima and the owner's
value reduce with all_reduce, which is exact.  The sums group
differently from the single-device build's, so the two agree to
rounding (rmi_tpu's dp tolerance).

Collectives are plain all_reduce, all_gather and broadcast: gloo (the
CPU, and ranks sharing a card) and NCCL take them on the ranks' tensors.
Gloo's point-to-point operations take no CUDA tensors, so a neighbour's
edge key comes from the all_gather of shard_edges, not from rmi_tpu's
ppermute.  Not ported (TPU workarounds): the shard_map
shims, jit of the mapped core, and the hier_count ladder (a histogram's
leaf is torch.searchsorted of the pivots).

Scope, as rmi_tpu's: every scalar-parameter top (DP_TOP_MODELS) and every
float-output leaf (DP_LEAF_MODELS); radix hint-table leaves are built on
one device.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

from rmi_tpu_torch.keys import KeyType, u64_bits
from rmi_tpu_torch.models import get_model, validate_spec
from rmi_tpu_torch.models.base import kernel_input, model_float_input
from rmi_tpu_torch.models.cubic import (candidates_from_slopes, choose_candidates,
                                        slopes_from_points)
from rmi_tpu_torch.models.histogram import build_radix_index
from rmi_tpu_torch.models.linear import (_slr_from_moments, log_targets,
                                         spline_from_endpoints, trimmed)
from rmi_tpu_torch.models.normal import _ln_or_zero
from rmi_tpu_torch.models.radix import bradix_fit, common_prefix_size, num_bits
from rmi_tpu_torch.ops import (cubic_l1_kernel, scan_kernel, select_kernel, sweep_kernel,
                               top_kernel)
from rmi_tpu_torch.train import api, two_layer
from rmi_tpu_torch.utils import segments as seg

DP_TOP_MODELS = ("linear", "robust_linear", "linear_spline", "cubic",
                 "loglinear", "normal", "lognormal", "radix", "bradix",
                 "histogram")
DP_LEAF_MODELS = ("linear", "robust_linear", "linear_spline", "cubic",
                  "loglinear", "normal", "lognormal")

SUM, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MAX
INT32_MAX = (1 << 31) - 1


class DPGroup:
    """The process group a build runs over (the default one for None),
    this rank's place in it, and, when ``timed``, the host seconds spent
    inside its collectives and their count: the device is synchronized
    before and after each, so a timed build is slower than an untimed
    one."""

    def __init__(self, group=None, timed: bool = False):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.timed = timed
        self.seconds = 0.0
        self.calls = 0

    @contextlib.contextmanager
    def _clock(self, t: torch.Tensor):
        self.calls += 1
        if not self.timed:
            yield
            return
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        yield
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        self.seconds += time.perf_counter() - t0

    def all_reduce(self, t: torch.Tensor, op=SUM) -> torch.Tensor:
        """``t`` reduced over the ranks (in place; returned)."""
        with self._clock(t):
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[world, *t.shape]: every rank's ``t``, in rank order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        with self._clock(t):
            dist.all_gather(parts, t, group=self.group)
        return torch.stack(parts)

    def sum_f64(self, partial: torch.Tensor) -> torch.Tensor:
        """The ranks' f64 partial sums added in rank order: the same bits
        on every rank and in every run, whatever the backend's reduction
        order."""
        parts = self.all_gather(partial)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total


def _comm(group) -> DPGroup:
    return group if isinstance(group, DPGroup) else DPGroup(group)


def _offset(m: int, comm: DPGroup) -> int:
    return comm.rank * m


# ---------------------------------------------------------------------------
# distributed primitives (called on every rank with its shard)
# ---------------------------------------------------------------------------

def global_range_sum(v_local, a, b, comm: DPGroup):
    """sum(v_global[a_j:b_j]) [k] f64 for replicated global bounds a, b [k]."""
    return _range_sums((v_local,), a, b, comm)[0]


def _range_sums(vs, a, b, comm: DPGroup):
    """[len(vs), k]: global_range_sum of each of ``vs`` (shards of one
    length), in one collective."""
    m = vs[0].shape[0]
    off = _offset(m, comm)
    lo = (a - off).clamp(0, m)
    hi = (b - off).clamp(0, m)
    partial = []
    for v in vs:
        c = seg.prefix_sum_exclusive(v)
        partial.append(c[hi] - c[lo])
        del c
    return comm.sum_f64(torch.stack(partial))


def global_value_at(v_local, g, comm: DPGroup):
    """v_global[g_j] for replicated global indices g (each in [0, n_pad)):
    the owner's value, 0 on the other ranks, summed.  Exact for integers
    (u64 keys as their int64 images) and for floats (x + 0)."""
    m = v_local.shape[0]
    gi = g - _offset(m, comm)
    owns = (gi >= 0) & (gi < m)
    val = torch.where(owns, v_local[gi.clamp(0, m - 1)], torch.zeros_like(v_local[:1]))
    return comm.all_reduce(val, SUM)


def global_searchsorted(sorted_local, queries, comm: DPGroup, side: str = "left"):
    """Global lower (or upper) bound int64 of each query in the globally
    sorted, sharded array: the shards' counts summed."""
    local = torch.searchsorted(sorted_local, queries, right=side == "right")
    return comm.all_reduce(local.long(), SUM)


# ---------------------------------------------------------------------------
# the runs that cross shards: FixDups and the duplicate runs
# ---------------------------------------------------------------------------

class Carries(NamedTuple):
    """What a rank's runs of equal keys take from the other ranks."""
    continues_left: torch.Tensor    # [1] bool: its first key is the previous rank's last
    start: torch.Tensor             # int32: the global start of the run in progress at
                                    # the end of the ranks before (0 on rank 0)
    continues_right: torch.Tensor   # [1] bool: its last key is the next rank's first
    end: torch.Tensor               # int32: the first run end of the ranks after (n - 1
                                    # on the last)


def shard_edges(keys_local):
    """[4] int64 of one shard of sorted key images: its first and last
    key, the position of its last run's first key and of its first run's
    last key (two binary searches, no pass over the shard)."""
    return torch.cat([keys_local[[0, -1]],
                      torch.searchsorted(keys_local, keys_local[-1:]),
                      torch.searchsorted(keys_local, keys_local[:1], right=True) - 1])


def run_carries(edges, m: int, n: int, rank: int) -> Carries:
    """Rank ``rank``'s Carries from every rank's shard_edges [world, 4]
    (shards of m keys, n real ones in all): the running max of the ranks'
    last run starts (each the global index of the last key at which a run
    starts in the shard, 0 where none starts there: the value at its last
    key of rmi_tpu's cummax of where(changed, i, 0)) before it, and the
    running min of their first run ends (n - 1 where none ends in the
    shard) after it, both K1 over the [world] values (exact: rmi_tpu's
    _carry_max and _carry_min_rev)."""
    world, dev = edges.shape[0], edges.device
    first, last, last_start, first_end = edges.unbind(1)
    off = torch.arange(world, device=dev) * m
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    cont_left = torch.cat([no, first[1:] == last[:-1]])
    cont_right = torch.cat([last[:-1] == first[1:], no])
    starts = torch.where((last_start > 0) | ~cont_left, off + last_start, 0).to(torch.int32)
    ends = torch.where((first_end < m - 1) | ~cont_right, (off + first_end).clamp(max=n - 1),
                       n - 1).to(torch.int32)
    before = scan_kernel.scan_i32(starts, is_max=True, fill=0)
    after = scan_kernel.scan_i32(ends, is_max=False, fill=INT32_MAX, reverse=True)
    start = torch.cat([before.new_zeros(1), before[:-1]])[rank]
    end = torch.cat([after[1:], after.new_full((1,), n - 1)])[rank]
    return Carries(cont_left[rank:rank + 1], start, cont_right[rank:rank + 1], end)


def dist_carries(keys_local, n: int, comm: DPGroup) -> Carries:
    """This rank's Carries: shard_edges gathered in one collective, then
    run_carries."""
    return run_carries(comm.all_gather(shard_edges(keys_local)), keys_local.shape[0], n,
                       comm.rank)


def dist_fixdups(keys_local, comm: DPGroup, carries: Carries = None):
    """Each key's global first-occurrence index, int32: one launch of
    rmi_fixdups_carry (scan_kernel.fixdups_carry) with the run carried in
    from the shards before."""
    m = keys_local.shape[0]
    if carries is None:
        carries = dist_carries(keys_local, m * comm.world, comm)
    return scan_kernel.fixdups_carry(keys_local, _offset(m, comm), carries.continues_left,
                                     carries.start)


def dist_run_bounds(keys_local, run_start, n: int, comm: DPGroup, carries: Carries = None):
    """(run_start, run_end): the global first and last index of each key's
    duplicate run, int32, ``run_start`` being dist_fixdups' (rmi_tpu
    scans it again); run_end is K1's reverse running min of the run ends
    with the carry of the shards after, n - 1 past the last shard.  The
    build takes the per-leaf longest runs in one kernel instead
    (sweep_kernel.span_run_max_carry)."""
    m = keys_local.shape[0]
    if carries is None:
        carries = dist_carries(keys_local, n, comm)
    return run_start, sweep_kernel.shard_run_ends(
        keys_local, _offset(m, comm), n, carries.continues_right, carries.end,
        lambda v: scan_kernel.scan_i32(v, is_max=False, fill=INT32_MAX, reverse=True))


# ---------------------------------------------------------------------------
# distributed model fits
# ---------------------------------------------------------------------------

def _local_spans(spans: seg.Spans, t_local, m: int, comm: DPGroup) -> seg.Spans:
    """The rank's clip of global spans: each range intersected with the
    shard's rows, in shard coordinates.  A leaf can be empty here and not
    globally, or hold only an edge point of its augmented range here."""
    off = _offset(m, comm)

    def clip(v):
        return (v - off).clamp(0, m)

    lo, hi = clip(spans.starts), clip(spans.ends)
    return seg.Spans(t=t_local, starts=lo, ends=hi, aug_starts=clip(spans.aug_starts),
                     aug_ends=clip(spans.aug_ends), nonempty=lo < hi, n=m, B=spans.B)


def _dist_slr_top(x, y, spans, comm, weights=None):
    """Least squares (alpha, beta) [1, 2] over a top's one span (or a
    one-leaf layer's), ``y`` its f64 targets, with 0/1 ``weights`` for a
    loglinear top: models/linear.py's fit in eager torch, its sums and
    centered sums each an f64 prefix sum over the whole shard (ROADMAP: the
    whole-array moments still to be a kernel's walk over a shard)."""
    a, b = spans.aug_starts, spans.aug_ends
    if weights is None:
        cnt = (b - a).double()
        sx, sy = _range_sums((x, y), a, b, comm)
    else:
        cnt, sx, sy = _range_sums((weights, x * weights, y * weights), a, b, comm)
    safe = cnt.clamp(min=1.0)
    mean_x, mean_y = sx / safe, sy / safe
    dx, dy = x - mean_x[0], y - mean_y[0]
    xx, xy = dx * dx, dx * dy
    if weights is not None:
        xx, xy = xx * weights, xy * weights
    m2, c = _range_sums((xx, xy), a, b, comm)
    return _slr_from_moments(cnt, mean_x, mean_y, m2, c)


def _dist_slr_leaves(x, yfix, spans, t_local, comm, trim=False, log=False):
    """Least squares (alpha, beta) [B, 2] per augmented span of the int32
    FixDups targets: linear, robust_linear (``trim``) and loglinear
    (``log``: ln y over the keys where it is finite), models/linear.py's
    fit with its sums across shards.  Each rank's clip gives its sums
    (rmi_aug_fit_sums), added across ranks into the means, then its
    centered moments about them (K2 on the targets), added too.  One span
    (B = 1) takes _dist_slr_top."""
    use = trimmed(spans) if trim else spans
    if use.B == 1:
        yf = yfix.double()
        if log:
            ln, w = log_targets(yf)
            return _dist_slr_top(x, ln, use, comm, weights=w)
        return _dist_slr_top(x, yf, use, comm)
    local = _local_spans(use, t_local, x.shape[0], comm)
    cnt, sx, sy = select_kernel.aug_fit_sums(x, yfix, local.aug_starts, local.aug_ends,
                                             log=log)
    if log:
        cnt, sx, sy = comm.sum_f64(torch.stack([cnt, sx, sy]))
    else:
        sx, sy = comm.sum_f64(torch.stack([sx, sy]))
        cnt = (use.aug_ends - use.aug_starts).double()
    safe = cnt.clamp(min=1.0)
    mean_x, mean_y = sx / safe, sy / safe
    m2, c = comm.sum_f64(torch.stack(select_kernel.aug_centered_moments(
        x, yfix, mean_x, mean_y, local.aug_starts, local.aug_ends, log=log)))
    return _slr_from_moments(cnt, mean_x, mean_y, m2, c)


def _dist_fit_ncdf_leaves(xv, yfix, spans, t_local, n: int, comm, sf: float = 1.0):
    """(mean, biased stdev, scale) [B, 3] per augmented span of the normal
    models (models/normal.py), ``xv`` their training input, the scale the
    last target (``yfix`` scaled by ``sf``, a top's).  Leaves: each rank's
    clip gives its sum of x (rmi_aug_fit_sums), added across ranks, then
    its centered sum about the mean (K2 xx), added; one span in eager
    torch (whole-shard prefix sums)."""
    cnt = (spans.aug_ends - spans.aug_starts).double()
    safe = cnt.clamp(min=1.0)
    if spans.B == 1:
        sx = global_range_sum(xv, spans.aug_starts, spans.aug_ends, comm)
        mean = torch.where(cnt == 0, 0.0, sx / safe)
        dx = xv - mean[0]
        ss = global_range_sum(dx * dx, spans.aug_starts, spans.aug_ends, comm)
    else:
        local = _local_spans(spans, t_local, xv.shape[0], comm)
        sx = comm.sum_f64(select_kernel.aug_fit_sums(xv, None, local.aug_starts,
                                                     local.aug_ends)[1])
        mean = torch.where(cnt == 0, 0.0, sx / safe)
        ss = comm.sum_f64(select_kernel.aug_centered_xx(xv, mean, local.aug_starts,
                                                        local.aug_ends))
    stdev = torch.sqrt(torch.where(cnt == 0, float("nan"), ss.clamp(min=0.0) / safe))
    last = (spans.aug_ends - 1).clamp(0, n - 1)
    scale = torch.where(cnt == 0, float("-inf"),
                        two_layer._scale(global_value_at(yfix, last, comm).double(), sf))
    return torch.stack([mean, stdev, scale], dim=-1)


def _dist_cubic(xf, yfix, spans, t_local, n: int, comm, ep_y=None, sf: float = 1.0):
    """Cubic rows [B, 4] (models/cubic.py's fit): each span's endpoints and
    inner points gathered from their owners (their targets ``yfix`` scaled
    by ``sf``, a top's, after the gather), the L1 comparison with the
    endpoint spline by K6 over the rank's clips for leaves, for one span
    (the top) by rmi_top_l1_partial over the shard's rows below n, the
    partials added across ranks before the choice."""
    first, last = seg.aug_first_last(spans)
    B = spans.B
    ends_x = global_value_at(xf, torch.cat([first, last]), comm)
    xmin, xmax = ends_x[:B], ends_x[B:]
    if ep_y is None:
        ends_y = two_layer._scale(global_value_at(yfix, torch.cat([first, last]),
                                                  comm).double(), sf)
        ymin, ymax = ends_y[:B], ends_y[B:]
    else:
        ymin, ymax = torch.full_like(xmin, ep_y[0]), torch.full_like(xmin, ep_y[1])
    inner = torch.cat([global_searchsorted(xf, xmin, comm, side="right"),
                       global_searchsorted(xf, xmax, comm) - 1]).clamp(0, n - 1)
    px = global_value_at(xf, inner, comm)
    py = two_layer._scale(global_value_at(yfix, inner, comm).double(), sf)
    m1, m2 = slopes_from_points(px[:B], py[:B], px[B:], py[B:], xmin, ymin, xmax, ymax,
                                xmin == xmax)
    cnt = (spans.aug_ends - spans.aug_starts).double()
    cubic_w, lin_w, st = candidates_from_slopes(xmin, ymin, xmax, ymax, m1, m2, cnt)
    if B == 1:
        m = xf.shape[0]
        cand = torch.cat([cubic_w[0], lin_w[0], cubic_w.new_zeros(top_kernel.CAND - 6)])
        real = max(0, min(m, n - _offset(m, comm)))
        c_err, l_err = comm.sum_f64(top_kernel.top_l1_partial(xf, yfix, sf, cand,
                                                              real)).split(1)
    else:
        local = _local_spans(spans, t_local, xf.shape[0], comm)
        c_err, l_err = comm.sum_f64(torch.stack(
            cubic_l1_kernel.cubic_l1_sums(xf, yfix, cubic_w, lin_w, local)))
    return choose_candidates(cubic_w, lin_w, c_err, l_err, st["empty"])[0]


def _dist_fit_leaves(leaf_type, leaf_in, yfix, spans, t_local, n: int, comm):
    """Leaf rows [B, ppm] over the global augmented spans."""
    if leaf_type in ("linear", "robust_linear"):
        return _dist_slr_leaves(leaf_in, yfix, spans, t_local, comm,
                                trim=leaf_type == "robust_linear")
    if leaf_type == "loglinear":
        return _dist_slr_leaves(leaf_in, yfix, spans, t_local, comm, log=True)
    if leaf_type == "normal":
        return _dist_fit_ncdf_leaves(leaf_in, yfix, spans, t_local, n, comm)
    if leaf_type == "lognormal":
        return _dist_fit_ncdf_leaves(_ln_or_zero(leaf_in), yfix, spans, t_local, n, comm)
    if leaf_type == "linear_spline":
        first, last = seg.aug_first_last(spans)
        idx = torch.cat([first, last])
        x = global_value_at(leaf_in, idx, comm)
        y = global_value_at(yfix, idx, comm).double()
        B = spans.B
        a, b = spline_from_endpoints(x[:B], y[:B], x[B:], y[B:],
                                     seg.aug_count(spans), fused=False)
        return torch.stack([a, b], dim=-1)
    if leaf_type == "cubic":
        return _dist_cubic(leaf_in, yfix, spans, t_local, n, comm)
    raise NotImplementedError(leaf_type)


def _global_bitword_reduce(ki_local, n: int, comm: DPGroup):
    """The leading bits no key varies (common_prefix_size, utils.rs:23-36):
    rmi_tpu reduces every key's word by OR and AND across shards; over
    sorted keys that prefix is clz(first ^ last), so the two words
    gathered are the global first and last key's (pads lie past n - 1)."""
    ends = torch.tensor([0, n - 1], dtype=torch.int64, device=ki_local.device)
    return common_prefix_size(global_value_at(ki_local, ends, comm))


def _dist_fit_top(top_type, top_in, yfix, sf: float, ep, real: int, n: int, B: int, comm):
    """The top's parameters and each shard key's leaf id (int32, before
    the pads are routed; top_kernel.top_assign), ``top_in`` the top's
    model input on the shard, its targets the FixDups positions ``yfix``
    scaled by ``sf``, ``real`` the shard's rows below n."""
    dev = top_in.device
    whole = seg.whole_array_spans(n, dev)
    if top_type in ("linear", "robust_linear", "loglinear"):
        ys = two_layer._scale(yfix.double(), sf)
        if top_type == "loglinear":
            ln, w = log_targets(ys)
            top_w = _dist_slr_top(top_in, ln, whole, comm, weights=w)
        else:
            top_w = _dist_slr_top(top_in, ys, trimmed(whole) if top_type == "robust_linear"
                                  else whole, comm)
        del ys
    elif top_type == "normal":
        top_w = _dist_fit_ncdf_leaves(top_in, yfix, whole, None, n, comm, sf)
    elif top_type == "lognormal":
        top_w = _dist_fit_ncdf_leaves(_ln_or_zero(top_in), yfix, whole, None, n, comm, sf)
    elif top_type == "linear_spline":
        x = global_value_at(top_in, torch.tensor([0, n - 1], device=dev), comm)
        x0, x1 = x[:1], x[1:]
        a, b = spline_from_endpoints(x0, torch.full_like(x0, ep[0]), x1,
                                     torch.full_like(x1, ep[1]),
                                     torch.full_like(x0, float(n)))
        top_w = torch.stack([a, b], dim=-1)
    elif top_type == "cubic":
        top_w = _dist_cubic(top_in, yfix, whole, None, n, comm, ep_y=ep, sf=sf)
    elif top_type in ("radix", "bradix"):
        last = global_value_at(yfix, torch.tensor([n - 1], device=dev), comm)
        max_output = two_layer._scale(last.double(), sf)[0].to(torch.int64)
        prefix = _global_bitword_reduce(top_in, n, comm)
        if top_type == "radix":
            top_w = {"w_int": torch.stack([prefix, num_bits(max_output)])}
        else:
            slots = torch.arange(B + 1, device=dev)

            def bucket_starts(bucket):
                # the shard's rows below n: the pads are in no count
                return global_searchsorted(bucket[:real], slots, comm)

            top_w = bradix_fit(u64_bits(top_in), max_output, prefix, n, B, bucket_starts)
    elif top_type == "histogram":
        sf = float(B) / float(n)
        num_bins = int(float(n - 1) * sf) if abs(sf - 1.0) > two_layer._F64_EPS else n - 1
        if num_bins <= 0 or n // num_bins < 1:
            raise ValueError("not enough items for equidepth histogram")
        pidx = torch.arange(num_bins, device=dev) * (n // num_bins)
        pivots = global_value_at(top_in, pidx, comm)
        top_w = {"count": torch.tensor(num_bins, device=dev), "pivots": pivots,
                 "radix_index": build_radix_index(pivots)}
    else:
        raise NotImplementedError(top_type)
    return top_w, top_kernel.top_assign(top_type, top_w, top_in, B)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def local_shard(keys: torch.Tensor, key_type: KeyType, group=None):
    """(keys_local, n): this rank's shard of the sorted key images ``keys``
    [n], a copy on their device: rows [r m, (r + 1) m) with m = ceil(n /
    world), the last shard padded with max-key sentinels as rmi_tpu pads
    (dp_trainer.py:822-828)."""
    comm = _comm(group)
    n = keys.shape[0]
    if n == 0:
        raise ValueError("cannot train on an empty key array")
    m = -(-n // comm.world)
    lo = min(comm.rank * m, n)
    part = keys[lo:min(lo + m, n)]
    pad = m - part.shape[0]
    if pad:
        return torch.cat([part, part.new_full((pad,), key_type.max_image)]), n
    return part.clone(), n


def dp_train_two_layer(keys_local: torch.Tensor, n: int, key_type: KeyType,
                       top_type: str, leaf_type: str, B: int, group=None):
    """Data-parallel two-layer build: call on every rank of ``group`` (the
    default group for None, or a DPGroup, whose ``timed`` counts the time
    in collectives) with its shard (local_shard) of n sorted key images,
    on the shard's device.

    Returns rmi_tpu's (top_params, leaf_params, leaf_errors, metrics) on
    every rank, bit-equal across ranks: the parameters in the normalized
    key domain of the global first and last key (norm_constants), as
    train_two_layer's (a [1, ppm] / [B, ppm] f64 table, an integer
    model's dict of int64 bits), the per-leaf errors [B] int64, and the
    metrics as a dict (metrics_dict: one transfer to the host).
    ``trained_rmi`` makes a servable index of them."""
    if top_type not in DP_TOP_MODELS:
        raise NotImplementedError(
            f"dp trainer supports tops {DP_TOP_MODELS}; use the single-device "
            f"build for {top_type}")
    if leaf_type not in DP_LEAF_MODELS:
        raise NotImplementedError(f"dp trainer supports leaves {DP_LEAF_MODELS}")
    validate_spec([top_type, leaf_type])
    comm = _comm(group)
    m = keys_local.shape[0]
    B = int(B)
    if n <= 0:
        raise ValueError("cannot train on an empty key array")
    if m * comm.world < n or m * comm.world >= 2**31:
        raise ValueError(f"{comm.world} shards of {m} keys do not hold n = {n} "
                         f"below 2^31")
    dev = keys_local.device
    mtop, mleaf = get_model(top_type), get_model(leaf_type)
    off = _offset(m, comm)
    real = max(0, min(m, n - off))      # the shard's rows below n; the pads follow

    ends = global_value_at(keys_local, torch.tensor([0, n - 1], device=dev), comm)
    kminf, s = two_layer.norm_from_ends(ends, key_type)
    top_in = model_float_input(mtop, keys_local, kminf, s, key_type)
    carries = dist_carries(keys_local, n, comm)
    yfix = dist_fixdups(keys_local, comm, carries)

    # top fit and leaf ids; pad lanes go to the last leaf, which keeps the
    # ids sorted while ends[B - 1] = n keeps them out of every span
    sf = float(B) / float(n)
    ep = (two_layer._scale(0.0, sf), two_layer._scale(float(n - 1), sf))
    top_w, t_local = _dist_fit_top(top_type, top_in, yfix, sf, ep, real, n, B, comm)
    t_local[real:] = B - 1

    starts = global_searchsorted(t_local, torch.arange(B, dtype=torch.int32, device=dev),
                                 comm)
    spans = seg.spans_from_starts(None, starts, n)
    leaf_in = (top_in if mleaf.input_domain == mtop.input_domain
               else model_float_input(mleaf, keys_local, kminf, s, key_type))
    del top_in
    leaf_w = _dist_fit_leaves(leaf_type, leaf_in, yfix, spans, t_local, n, comm)
    next_idx, next_key, prev_key = two_layer.lower_bound_fills(
        spans, keys_local, key_type,
        key_at=lambda idx: global_value_at(keys_local, idx, comm))
    if mleaf.constant_params is not None:
        patch = ~spans.nonempty & (torch.arange(B, device=dev) < B - 1)
        leaf_w = torch.where(patch[:, None], mleaf.constant_params(next_idx.double()),
                             leaf_w)

    # the per-leaf maxima: K3's sweep over the rank's clips, and the counted
    # duplicate runs (the array's final run, and the pads, count 0)
    local = _local_spans(spans, t_local, m, comm)
    max_err = sweep_kernel.sweep_leaf_max(kernel_input(mleaf, leaf_in), yfix, local.starts,
                                          local.ends, leaf_w, n, leaf_type=leaf_type)
    del leaf_in
    longest = sweep_kernel.span_run_max_carry(keys_local, yfix, local.starts, local.ends, off,
                                              n, carries.continues_right, carries.end)
    maxima = comm.all_reduce(torch.stack([max_err.long(), longest.long()]), MAX).clamp(min=0)
    maxima = torch.where(spans.nonempty, maxima, 0)
    final_err, metrics = two_layer.final_errors(
        maxima[0], maxima[1], spans, leaf_w, next_idx, next_key, prev_key, kminf, s,
        key_type, leaf_type=leaf_type)
    return top_w, leaf_w, final_err, two_layer.metrics_dict(api.fetch_host(metrics))


def trained_rmi(keys: torch.Tensor, key_type: KeyType, top_type: str, leaf_type: str,
                B: int, outputs) -> "api.TrainedRMI":
    """A TrainedRMI that lookup and search serve, from dp_train_two_layer's
    ``outputs`` over all n sorted key images ``keys`` (on the outputs'
    device; the normalization is the build's, norm_constants of them)."""
    top_w, leaf_w, errors, metrics = outputs
    kminf, s = two_layer.norm_constants(keys, key_type)
    return api.trained_from_tensors(f"{top_type},{leaf_type}", B, key_type, keys, top_w,
                                    leaf_w, errors, kminf, s, metrics=metrics)
