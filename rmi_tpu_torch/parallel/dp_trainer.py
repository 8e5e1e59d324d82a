"""Data-parallel two-layer build over the ranks of a torch.distributed
group (counterpart of rmi_tpu/parallel/dp_trainer.py).

The sorted key array is cut into one equal shard per rank (``local_shard``:
rank r holds global rows [r m, (r + 1) m), the last shard padded with
max-key sentinels), each rank calls ``dp_train_two_layer`` on its shard,
and every rank gets the same index back.  Per-leaf [B] statistics are
replicated; every pass over the keys runs on the rank's shard alone,
with the port's kernels where the single-device build runs them, and
is joined by a few collectives:

  * ``global_range_sum``    sums over global ranges, from the shard's
                            fixed-order prefix sums;
  * ``global_value_at``     the owner's value, zero elsewhere, summed;
  * ``global_searchsorted`` local counts, summed (leaf ids and keys are
                            globally sorted);

and the running max and min across shards (FixDups' run starts, the
duplicate runs' ends) as the shard's own scan (kernel K1) plus a carry
gathered from the other ranks.  Each leaf's sums are a rank's kernel
call over its clip of the leaf's augmented span (K2 for the linear
family and the normal models, K6 for cubic leaves), the partials added
across ranks; the per-leaf maxima of the error sweep (K3) and of the
counted duplicate runs are maxima across ranks; the epsilon probes
(K4) and the metrics run on the replicated [B] statistics as in the
single-device build (train/two_layer.final_errors).

Floats are added in a fixed order, so a build over a fixed world and
fixed shapes gives the same bits every time and on every rank: a
shard's sums in its row-scan order (utils/segments.prefix_sum_exclusive)
or its kernel's, and the ranks' partial sums gathered and added in rank
order (``DPGroup.sum_f64``).  Integer sums, maxima and the owner's
value reduce with all_reduce, which is exact.  The sums group
differently from the single-device build's, so the two agree to
rounding (rmi_tpu's dp tolerance).

Collectives are plain all_reduce, all_gather and broadcast: gloo (the
CPU, and ranks sharing a card) and NCCL take them on the ranks' tensors.
Gloo's point-to-point operations take no CUDA tensors, so a neighbour's
edge key comes from an all_gather of every rank's first and last key, not
from rmi_tpu's ppermute.  Not ported (TPU workarounds): the shard_map
shims, jit of the mapped core, and the hier_count ladder (a histogram's
leaf is torch.searchsorted of the pivots).

Scope, as rmi_tpu's: every scalar-parameter top (DP_TOP_MODELS) and every
float-output leaf (DP_LEAF_MODELS); radix hint-table leaves are built on
one device.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

from rmi_tpu_torch.keys import KeyType, u64_bits
from rmi_tpu_torch.models import get_model, validate_spec
from rmi_tpu_torch.models.base import kernel_input, model_float_input, predict_top_assignment
from rmi_tpu_torch.models.cubic import (candidates_from_slopes, choose_candidates,
                                        cubic_predict, slopes_from_points)
from rmi_tpu_torch.models.histogram import build_radix_index
from rmi_tpu_torch.models.linear import (_slr_from_moments, linear_predict, log_targets,
                                         spline_from_endpoints, trimmed)
from rmi_tpu_torch.models.normal import _ln_or_zero
from rmi_tpu_torch.models.radix import bradix_fit, common_prefix_size, num_bits
from rmi_tpu_torch.ops import cubic_l1_kernel, scan_kernel, select_kernel, sweep_kernel
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


def _carry_max(v, comm: DPGroup, fill):
    """max(fill, v of every rank before this one), for a running max's
    carry into this shard."""
    allv = comm.all_gather(v.reshape(1))[:, 0]
    before = torch.arange(comm.world, device=allv.device) < comm.rank
    return torch.where(before, allv, torch.full_like(allv, fill)).max()


def _carry_min_rev(v, comm: DPGroup, fill):
    """min(fill, v of every rank after this one), for a reverse running
    min's carry into this shard."""
    allv = comm.all_gather(v.reshape(1))[:, 0]
    after = torch.arange(comm.world, device=allv.device) > comm.rank
    return torch.where(after, allv, torch.full_like(allv, fill)).min()


def _edge_keys(keys_local, comm: DPGroup):
    """[world, 2]: every rank's first and last key."""
    return comm.all_gather(keys_local[[0, -1]])


def _neighbor_last_key(keys_local, comm: DPGroup):
    """The previous rank's last key (rank 0: the last rank's)."""
    return _edge_keys(keys_local, comm)[(comm.rank - 1) % comm.world, 1]


def _neighbor_first_key(keys_local, comm: DPGroup):
    """The next rank's first key (the last rank: rank 0's)."""
    return _edge_keys(keys_local, comm)[(comm.rank + 1) % comm.world, 0]


def _global_idx(m: int, comm: DPGroup, device):
    off = _offset(m, comm)
    return torch.arange(off, off + m, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# distributed FixDups and duplicate runs
# ---------------------------------------------------------------------------

def dist_fixdups(keys_local, comm: DPGroup):
    """Each key's global first-occurrence index, int32: K1's running max
    of the run starts, with the carry of the shards before."""
    m = keys_local.shape[0]
    changed = torch.ones(m, dtype=torch.bool, device=keys_local.device)
    torch.ne(keys_local[1:], keys_local[:-1], out=changed[1:])
    left_last = _neighbor_last_key(keys_local, comm)
    if comm.rank > 0:
        changed[:1] = keys_local[:1] != left_last
    starts = torch.where(changed, _global_idx(m, comm, keys_local.device), 0)
    local = scan_kernel.scan_i32(starts, is_max=True, fill=0)
    return torch.maximum(local, _carry_max(local[-1], comm, 0))


def dist_run_bounds(keys_local, run_start, n: int, comm: DPGroup):
    """(run_start, run_end): the global first and last index of each key's
    duplicate run, int32, ``run_start`` being dist_fixdups' (rmi_tpu
    scans it again); run_end is K1's reverse running min of the run ends,
    n - 1 past the last shard."""
    m = keys_local.shape[0]
    gidx = _global_idx(m, comm, keys_local.device)
    ends = torch.ones(m, dtype=torch.bool, device=keys_local.device)
    torch.ne(keys_local[1:], keys_local[:-1], out=ends[:-1])
    right_first = _neighbor_first_key(keys_local, comm)
    if comm.rank < comm.world - 1:
        ends[-1:] = keys_local[-1:] != right_first
    rev = torch.where(ends, gidx, n - 1)
    # INT32_MAX, min's identity: the kernel's result is the plain scan's
    local = scan_kernel.scan_i32(rev, is_max=False, fill=INT32_MAX, reverse=True)
    return run_start, torch.minimum(local, _carry_min_rev(local[0], comm, n - 1))


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


def _centered_sums(x, y, mean_x, mean_y, spans, local, comm, weights=None):
    """(m2, c): sum (x - mx)^2 and sum (x - mx)(y - my) over each
    augmented span, a term times its 0/1 weight when given.  Leaves: K2
    over the rank's clip, the partials added across ranks; a top's one
    span: the products summed over the whole array."""
    if spans.B == 1:
        a, b = spans.aug_starts, spans.aug_ends
        dx, dy = x - mean_x[0], y - mean_y[0]
        xx, xy = dx * dx, dx * dy
        if weights is not None:
            xx, xy = xx * weights, xy * weights
        return tuple(_range_sums((xx, xy), a, b, comm))
    m2, c = select_kernel.aug_centered_moments(x, y, mean_x, mean_y, local.aug_starts,
                                               local.aug_ends, weights=weights)
    return tuple(comm.sum_f64(torch.stack([m2, c])))


def _dist_slr_leaves(x, y, spans, t_local, comm, weights=None, trim=False):
    """Least squares (alpha, beta) [B, 2] per augmented span: linear,
    robust_linear (``trim``) and, with 0/1 ``weights``, loglinear
    (models/linear.py's fit, its sums across shards)."""
    use = trimmed(spans) if trim else spans
    local = _local_spans(use, t_local, x.shape[0], comm)
    a, b = use.aug_starts, use.aug_ends
    if weights is None:
        cnt = (b - a).double()
        sx, sy = _range_sums((x, y), a, b, comm)
    else:
        cnt, sx, sy = _range_sums((weights, x * weights, y * weights), a, b, comm)
    safe = cnt.clamp(min=1.0)
    mean_x, mean_y = sx / safe, sy / safe
    m2, c = _centered_sums(x, y, mean_x, mean_y, use, local, comm, weights)
    return _slr_from_moments(cnt, mean_x, mean_y, m2, c)


def _dist_fit_ncdf_leaves(xv, yf, spans, t_local, n: int, comm):
    """(mean, biased stdev, scale) [B, 3] per augmented span of the
    normal models (models/normal.py), ``xv`` their training input."""
    local = _local_spans(spans, t_local, xv.shape[0], comm)
    cnt = (spans.aug_ends - spans.aug_starts).double()
    safe = cnt.clamp(min=1.0)
    sx = global_range_sum(xv, spans.aug_starts, spans.aug_ends, comm)
    mean = torch.where(cnt == 0, 0.0, sx / safe)
    if spans.B == 1:
        dx = xv - mean[0]
        ss = global_range_sum(dx * dx, spans.aug_starts, spans.aug_ends, comm)
    else:
        ss = comm.sum_f64(select_kernel.aug_centered_xx(xv, mean, local.aug_starts,
                                                        local.aug_ends))
    stdev = torch.sqrt(torch.where(cnt == 0, float("nan"), ss.clamp(min=0.0) / safe))
    last = (spans.aug_ends - 1).clamp(0, n - 1)
    scale = torch.where(cnt == 0, float("-inf"),
                        global_value_at(yf, last, comm).double())
    return torch.stack([mean, stdev, scale], dim=-1)


def _dist_cubic(xf, yf, spans, t_local, n: int, comm, ep_y=None):
    """Cubic rows [B, 4] (models/cubic.py's fit): each span's endpoints and
    inner points gathered from their owners, the L1 comparison with the
    endpoint spline by K6 over the rank's clips for leaves, over the
    whole array for the top."""
    first, last = seg.aug_first_last(spans)
    B = spans.B
    ends_x = global_value_at(xf, torch.cat([first, last]), comm)
    xmin, xmax = ends_x[:B], ends_x[B:]
    if ep_y is None:
        ends_y = global_value_at(yf, torch.cat([first, last]), comm).double()
        ymin, ymax = ends_y[:B], ends_y[B:]
    else:
        ymin, ymax = torch.full_like(xmin, ep_y[0]), torch.full_like(xmin, ep_y[1])
    inner = torch.cat([global_searchsorted(xf, xmin, comm, side="right"),
                       global_searchsorted(xf, xmax, comm) - 1]).clamp(0, n - 1)
    px = global_value_at(xf, inner, comm)
    py = global_value_at(yf, inner, comm).double()
    m1, m2 = slopes_from_points(px[:B], py[:B], px[B:], py[B:], xmin, ymin, xmax, ymax,
                                xmin == xmax)
    cnt = (spans.aug_ends - spans.aug_starts).double()
    cubic_w, lin_w, st = candidates_from_slopes(xmin, ymin, xmax, ymax, m1, m2, cnt)
    if B == 1:
        yd = yf.double()
        a, b = spans.aug_starts, spans.aug_ends
        c_err, l_err = _range_sums(((cubic_predict(cubic_w, None, xf) - yd).abs_(),
                                    (linear_predict(lin_w, None, xf) - yd).abs_()),
                                   a, b, comm)
    else:
        local = _local_spans(spans, t_local, xf.shape[0], comm)
        c_err, l_err = comm.sum_f64(torch.stack(
            cubic_l1_kernel.cubic_l1_sums(xf, yf, cubic_w, lin_w, local)))
    return choose_candidates(cubic_w, lin_w, c_err, l_err, st["empty"])[0]


def _dist_fit_leaves(leaf_type, leaf_in, yfix, spans, t_local, n: int, comm):
    """Leaf rows [B, ppm] over the global augmented spans."""
    if leaf_type in ("linear", "robust_linear"):
        return _dist_slr_leaves(leaf_in, yfix.double(), spans, t_local, comm,
                                trim=leaf_type == "robust_linear")
    if leaf_type == "loglinear":
        ln, w = log_targets(yfix.double())
        return _dist_slr_leaves(leaf_in, ln, spans, t_local, comm, weights=w)
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


def _dist_fit_top(top_type, top_in, ys, ep, is_pad, n: int, B: int, comm):
    """The top's parameters and each shard key's leaf id (int64, before
    the pads are routed), ``top_in`` the top's model input on the shard
    and ``ys`` its scaled targets."""
    mtop = get_model(top_type)
    dev = top_in.device
    whole = seg.whole_array_spans(n, dev)
    zeros = torch.zeros(top_in.shape[0], dtype=torch.int32, device=dev)
    if top_type in ("linear", "robust_linear"):
        top_w = _dist_slr_leaves(top_in, ys, whole, zeros, comm,
                                 trim=top_type == "robust_linear")
    elif top_type == "loglinear":
        ln, w = log_targets(ys)
        top_w = _dist_slr_leaves(top_in, ln, whole, zeros, comm, weights=w)
    elif top_type == "normal":
        top_w = _dist_fit_ncdf_leaves(top_in, ys, whole, zeros, n, comm)
    elif top_type == "lognormal":
        top_w = _dist_fit_ncdf_leaves(_ln_or_zero(top_in), ys, whole, zeros, n, comm)
    elif top_type == "linear_spline":
        x = global_value_at(top_in, torch.tensor([0, n - 1], device=dev), comm)
        x0, x1 = x[:1], x[1:]
        a, b = spline_from_endpoints(x0, torch.full_like(x0, ep[0]), x1,
                                     torch.full_like(x1, ep[1]),
                                     torch.full_like(x0, float(n)))
        top_w = torch.stack([a, b], dim=-1)
    elif top_type == "cubic":
        top_w = _dist_cubic(top_in, ys, whole, zeros, n, comm, ep_y=ep)
    elif top_type in ("radix", "bradix"):
        largest = global_value_at(ys, torch.tensor([n - 1], device=dev), comm)[0]
        max_output = largest.to(torch.int64)
        prefix = _global_bitword_reduce(top_in, n, comm)
        if top_type == "radix":
            top_w = {"w_int": torch.stack([prefix, num_bits(max_output)])}
        else:
            slots = torch.arange(B + 1, device=dev)

            def bucket_starts(bucket):
                # pads to bucket B: past every slot, out of every count
                return global_searchsorted(torch.where(is_pad, B, bucket), slots, comm)

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
    return top_w, predict_top_assignment(mtop, top_w, top_in, B - 1)


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
    is_pad = torch.arange(_offset(m, comm), _offset(m, comm) + m, device=dev) >= n

    ends = global_value_at(keys_local, torch.tensor([0, n - 1], device=dev), comm)
    kminf, s = two_layer.norm_from_ends(ends, key_type)
    top_in = model_float_input(mtop, keys_local, kminf, s, key_type)
    yfix = dist_fixdups(keys_local, comm)

    # top fit and leaf ids; pad lanes go to the last leaf, which keeps the
    # ids sorted while ends[B - 1] = n keeps them out of every span
    sf = float(B) / float(n)
    ys = two_layer._scale(yfix.double(), sf)
    ep = (two_layer._scale(0.0, sf), two_layer._scale(float(n - 1), sf))
    top_w, t = _dist_fit_top(top_type, top_in, ys, ep, is_pad, n, B, comm)
    del ys
    t_local = torch.where(is_pad, B - 1, t).to(torch.int32)
    del t

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
    run_start, run_end = dist_run_bounds(keys_local, yfix, n, comm)
    counted = torch.where((run_end < n - 1) & ~is_pad, run_end - run_start + 1, 0)
    longest = torch.zeros(B, dtype=torch.int64, device=dev).scatter_reduce_(
        0, t_local.long(), counted.long(), "amax")
    del run_end, counted
    maxima = comm.all_reduce(torch.stack([max_err.long(), longest]), MAX).clamp(min=0)
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
