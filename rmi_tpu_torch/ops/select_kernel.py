"""K2: per-leaf centered moments of the linear-family, loglinear and
normal leaf fits (csrc/moments.cu).

Counterpart of rmi_tpu/ops/select_kernel.py:window_moments plus the
per-leaf range sums that follow it (rmi_tpu/utils/segments.py:683-720).
The kernel fuses the per-key products into the per-leaf sums.  Five C
entry points, behind four wrappers: ``aug_fit_moments`` launches
``rmi_aug_fit_moments``, the build's linear and normal leaf fits whole
(each leaf's means from its sums, then its centered moments, from x and
the int32 FixDups targets: no prefix sum and no f64 copy of the
targets); ``aug_fit_log_moments`` launches ``rmi_aug_fit_log_moments``,
the loglinear leaf fit whole (ln y and its 0/1 weight taken per key from
the same int32 targets, then the weighted count, means and moments);
``aug_centered_moments`` launches ``rmi_aug_moments`` or, given 0/1
weights, ``rmi_aug_moments_weighted`` (``has_w``, loglinear leaves) on
means made outside, y an f64 tensor or the int32 FixDups targets
themselves (with ``log``, the weighted regression of ln y, its weights
taken per key); ``aug_centered_xx`` launches ``rmi_aug_moments_xx``
(``xx_only``: the variance of x alone); ``aug_fit_sums`` launches
``rmi_aug_fit_sums``, the fit entries' first pass alone.  The
data-parallel build (parallel/dp_trainer.py), whose sums cross ranks,
takes the last three: each leaf's sums over the rank's clip, added across
ranks, then its centered moments about the global means over the clip.
"""

from __future__ import annotations

import torch

from rmi_tpu_torch.ops import _build
from rmi_tpu_torch.utils import segments as seg


def _check(name, tensors, per_leaf):
    """``tensors``: (name, tensor) pairs, every one 1-D int64 (the range
    bounds) or f64 (the rest); the first is x, each per-key one as long
    as x, each of ``per_leaf`` as long as the first of them."""
    for what, a in tensors:
        dt = torch.int64 if what.startswith("aug_") else torch.float64
        if a.dtype != dt or a.dim() != 1:
            raise ValueError(f"{name}: {what} must be 1-D {dt}")
    per_key = [a for what, a in tensors if what not in per_leaf]
    if any(a.shape != per_key[0].shape for a in per_key):
        raise ValueError(f"{name}: the per-key arrays differ in length")
    B = {a.shape[0] for what, a in tensors if what in per_leaf}
    if len(B) != 1:
        raise ValueError(f"{name}: the per-leaf arrays differ in length")


_PER_LEAF = ("mean_x", "mean_y", "aug_starts", "aug_ends")


def span_elements(starts, ends):
    """(leaf, elem): every element index of every range
    [starts[j], ends[j]) and the leaf j it belongs to, leaf by leaf."""
    B = starts.shape[0]
    lengths = ends - starts
    leaf = torch.repeat_interleave(torch.arange(B, device=starts.device), lengths)
    first = torch.cumsum(lengths, 0) - lengths
    elem = (torch.arange(leaf.shape[0], device=starts.device) - first[leaf]
            + starts[leaf])
    return leaf, elem


def aug_centered_moments_plain(x, y, mean_x, mean_y, aug_starts, aug_ends, *,
                               weights=None, log=False):
    """The plain PyTorch version of K2 and K2 weighted: the same terms,
    expanded per element of each augmented range and summed per leaf
    with index_add_; a weighted term is the product times its weight.
    int32 targets ``y`` take target_terms(y, log) first."""
    if y.dtype == torch.int32:
        y, weights = target_terms(y, log)
    leaf, elem = span_elements(aug_starts, aug_ends)
    dx = x[elem] - mean_x[leaf]
    xx, xy = dx * dx, dx * (y[elem] - mean_y[leaf])
    if weights is not None:
        wt = weights[elem]
        xx, xy = xx * wt, xy * wt
    m2 = torch.zeros_like(mean_x).index_add_(0, leaf, xx)
    return m2, torch.zeros_like(mean_x).index_add_(0, leaf, xy)


def target_terms(y, log: bool = False):
    """(y as f64, weights or None) of int32 FixDups targets ``y``: the
    targets themselves, or with ``log`` models/linear.log_targets of them
    (ln y, 0 where not finite, and its 0/1 weights)."""
    if log:
        return _log_targets(y)
    return y.double(), None


def aug_centered_moments(x, y, mean_x, mean_y, aug_starts, aug_ends, *,
                         weights=None, log=False):
    """(m2, c) [B] f64: per leaf j, sum (x - mean_x[j])^2 and
    sum (x - mean_x[j]) (y - mean_y[j]) over [aug_starts[j], aug_ends[j]),
    each term times weights[i] when 0/1 ``weights`` are given
    (``rmi_aug_moments_weighted``, else ``rmi_aug_moments``).  ``y`` is
    f64, or the int32 FixDups targets, which the kernel reads in place of
    an f64 copy: as doubles, or with ``log`` (no ``weights``: they are
    taken per key) as target_terms(y, log=True) gives them, weighted.
    Sums differ from the plain version's by summation order only."""
    targets = y is not None and y.dtype == torch.int32
    if targets:
        if weights is not None or y.shape != x.shape:
            raise ValueError("aug_centered_moments: int32 targets take no weights and "
                             "are shaped like x")
        named = [("x", x), ("mean_x", mean_x), ("mean_y", mean_y),
                 ("aug_starts", aug_starts), ("aug_ends", aug_ends)]
    else:
        if log:
            raise ValueError("aug_centered_moments: log takes the int32 targets")
        named = [("x", x), ("y", y), ("mean_x", mean_x), ("mean_y", mean_y),
                 ("aug_starts", aug_starts), ("aug_ends", aug_ends)]
        if weights is not None:
            named.append(("weights", weights))
    _check("aug_centered_moments", named, _PER_LEAF)
    if x.is_cpu:
        return aug_centered_moments_plain(x, y, mean_x, mean_y, aug_starts, aug_ends,
                                          weights=weights, log=log)
    B = mean_x.shape[0]
    f64, i32 = (torch.empty(0, dtype=t, device=x.device) for t in (torch.float64, torch.int32))
    if targets:
        if log:
            return _build.launch("rmi_aug_moments_weighted", x, f64, f64, y, mean_x, mean_y,
                                 aug_starts, aug_ends, B, B, B)
        return _build.launch("rmi_aug_moments", x, f64, y, mean_x, mean_y, aug_starts,
                             aug_ends, B, B, B)
    if weights is None:
        return _build.launch("rmi_aug_moments", x, y, i32, mean_x, mean_y, aug_starts,
                             aug_ends, B, B, B)
    return _build.launch("rmi_aug_moments_weighted", x, y, weights, i32, mean_x, mean_y,
                         aug_starts, aug_ends, B, B, B)


def aug_centered_xx_plain(x, mean_x, aug_starts, aug_ends):
    """The plain PyTorch version of K2 xx."""
    leaf, elem = span_elements(aug_starts, aug_ends)
    dx = x[elem] - mean_x[leaf]
    return torch.zeros_like(mean_x).index_add_(0, leaf, dx * dx)


def aug_centered_xx(x, mean_x, aug_starts, aug_ends):
    """m2 [B] f64: per leaf j, sum (x - mean_x[j])^2 over its augmented
    range, reading x alone (``rmi_aug_moments_xx``)."""
    named = [("x", x), ("mean_x", mean_x), ("aug_starts", aug_starts),
             ("aug_ends", aug_ends)]
    _check("aug_centered_xx", named, _PER_LEAF)
    if x.is_cpu:
        return aug_centered_xx_plain(x, mean_x, aug_starts, aug_ends)
    B = mean_x.shape[0]
    return _build.launch("rmi_aug_moments_xx", x, mean_x, aug_starts, aug_ends, B, B)


# keys a chunk of a long leaf in rmi_aug_fit_moments (csrc/moments.cu kChunk)
FIT_CHUNK = 4096
_U = 2.0 ** -53         # the unit roundoff of f64


def fit_capacity(n: int, B: int) -> int:
    """Slots of rmi_aug_fit_moments' schedule of long-leaf chunks: enough
    for spans whose lengths add up to at most n + 2B (augmented spans,
    robust_linear's trimmed ones), where a leaf longer than FIT_CHUNK has
    fewer than 2 len / FIT_CHUNK chunks.  With fewer slots a long leaf
    runs on its own warp, to the same bits."""
    return 2 * (n + 2 * B) // FIT_CHUNK + 1


def aug_fit_moments_plain(x, y, aug_starts, aug_ends):
    """The plain PyTorch version, the leaf fits' eager composition: the
    range sums as prefix-sum differences (segments.range_sum), the means
    s / max(cnt, 1), then K2's plain version with y as f64; with y None
    the normal fit's, the mean (0 where cnt == 0) and K2 xx's plain
    version."""
    cnt = (aug_ends - aug_starts).double()
    safe = cnt.clamp(min=1.0)
    mean_x = seg.range_sum(x, aug_starts, aug_ends) / safe
    if y is None:
        mean_x = torch.where(cnt == 0, 0.0, mean_x)
        return mean_x, aug_centered_xx_plain(x, mean_x, aug_starts, aug_ends)
    yf = y.double()
    mean_y = seg.range_sum(yf, aug_starts, aug_ends) / safe
    return (mean_x, mean_y,
            *aug_centered_moments_plain(x, yf, mean_x, mean_y, aug_starts, aug_ends))


def aug_fit_moments(x, y, aug_starts, aug_ends):
    """(mean_x, mean_y, m2, c) [B] f64 of each leaf j over its augmented
    range [aug_starts[j], aug_ends[j]) of cnt keys: the means
    sum / max(cnt, 1), m2 = sum (x - mean_x)^2 and
    c = sum (x - mean_x) (y - mean_y), from f64 ``x`` and int32 ``y``;
    with ``y`` None, (mean_x, m2).  On the card one launch of
    rmi_aug_fit_moments, its sum of y exact, the same bits in every run,
    within fit_tolerance of the plain version; on the CPU the plain
    version."""
    named = [("x", x), ("aug_starts", aug_starts), ("aug_ends", aug_ends)]
    _check("aug_fit_moments", named, ("aug_starts", "aug_ends"))
    if y is not None and (y.dtype != torch.int32 or y.shape != x.shape):
        raise ValueError("aug_fit_moments: y must be int32 shaped like x")
    if x.is_cpu:
        return aug_fit_moments_plain(x, y, aug_starts, aug_ends)
    B = aug_starts.shape[0]
    rows = 2 if y is None else 4
    if B == 0:
        return tuple(x.new_empty(0) for _ in range(rows))
    if y is None:
        y = torch.empty(0, dtype=torch.int32, device=x.device)
    capacity = fit_capacity(x.shape[0], B)
    out, _ = _build.launch("rmi_aug_fit_moments", x, y, aug_starts, aug_ends, x.shape[0],
                           int(rows == 2), (rows, B), B, 1 + 6 * capacity, capacity)
    return out.unbind(0)


def _log_targets(y):
    """models/linear.log_targets of the int32 FixDups targets as f64: (ln y,
    0 where not finite; the 0/1 weights)."""
    from rmi_tpu_torch.models.linear import log_targets   # the models import this module
    return log_targets(y.double())


def aug_fit_log_moments_plain(x, y, aug_starts, aug_ends):
    """The plain PyTorch version, the loglinear leaf fit's eager
    composition (models/linear._slr_ranges with weights, B > 1): ln y and
    its 0/1 weight (log_targets), the weighted count and sums as
    prefix-sum differences (segments.aug_masked_stats), the means
    s / max(cnt, 1), then K2 weighted's plain version."""
    ln, w = _log_targets(y)
    spans = seg.Spans(t=None, starts=aug_starts, ends=aug_ends, aug_starts=aug_starts,
                      aug_ends=aug_ends, nonempty=aug_starts < aug_ends, n=x.shape[0],
                      B=aug_starts.shape[0])
    cnt, sx, sy = seg.aug_masked_stats(spans, w, x, ln)
    safe = cnt.clamp(min=1.0)
    mean_x, mean_y = sx / safe, sy / safe
    return (cnt, mean_x, mean_y,
            *aug_centered_moments_plain(x, ln, mean_x, mean_y, aug_starts, aug_ends,
                                        weights=w))


def aug_fit_log_moments(x, y, aug_starts, aug_ends):
    """(cnt, mean_x, mean_y, m2, c) [B] f64 of each leaf j over its
    augmented range [aug_starts[j], aug_ends[j]): the loglinear fit's
    regression of ln y on x over the keys whose ln y is finite (y > 0:
    the FixDups targets of the first run, y = 0, are dropped), cnt their
    count, the means sum / max(cnt, 1), m2 = sum (x - mean_x)^2 and
    c = sum (x - mean_x) (ln y - mean_y), from f64 ``x`` and int32
    ``y``.  On the card one launch of rmi_aug_fit_log_moments, its count
    exact, the same bits in every run, within fit_tolerance(...,
    log_form=True) of the plain version; on the CPU the plain version."""
    named = [("x", x), ("aug_starts", aug_starts), ("aug_ends", aug_ends)]
    _check("aug_fit_log_moments", named, ("aug_starts", "aug_ends"))
    if y is None or y.dtype != torch.int32 or y.shape != x.shape:
        raise ValueError("aug_fit_log_moments: y must be int32 shaped like x")
    if x.is_cpu:
        return aug_fit_log_moments_plain(x, y, aug_starts, aug_ends)
    B = aug_starts.shape[0]
    if B == 0:
        return tuple(x.new_empty(0) for _ in range(5))
    capacity = fit_capacity(x.shape[0], B)
    out, _ = _build.launch("rmi_aug_fit_log_moments", x, y, aug_starts, aug_ends, x.shape[0],
                           (5, B), B, 1 + 7 * capacity, capacity)
    return out.unbind(0)


# rmi_aug_fit_sums' forms (csrc/moments.cu)
SUMS_FORMS = {"xy": 0, "xx": 1, "log": 2}


def aug_fit_sums_plain(x, y, aug_starts, aug_ends, *, log=False):
    """The plain PyTorch version, the data-parallel build's eager chain:
    each summed value's f64 prefix sum over the whole shard (x; y as f64;
    for ``log`` the weights, x and ln y times them), taken as differences
    at the ranges' bounds; cnt the ranges' lengths, or the weights' sum."""
    def sums(v):
        c = seg.prefix_sum_exclusive(v)
        return c[aug_ends] - c[aug_starts]
    if log:
        ln, w = _log_targets(y)
        return sums(w), sums(x * w), sums(ln * w)
    cnt = (aug_ends - aug_starts).double()
    return cnt, sums(x), (torch.zeros_like(cnt) if y is None else sums(y.double()))


def aug_fit_sums(x, y, aug_starts, aug_ends, *, log=False):
    """(cnt, sum x, sum y) [B] f64 over each range [aug_starts[j],
    aug_ends[j]) of x and the int32 FixDups targets ``y``: cnt the range's
    length, sum y 0 where ``y`` is None; with ``log`` the sums of x and ln y
    over the keys whose ln y is finite and their count.  The first pass of
    aug_fit_moments and aug_fit_log_moments alone, for sums that cross
    ranks.  On the card one launch of rmi_aug_fit_sums, its sum of y and
    its counts exact, the same bits in every run, within fit_sums_tolerance
    of the plain version; on the CPU the plain version."""
    named = [("x", x), ("aug_starts", aug_starts), ("aug_ends", aug_ends)]
    _check("aug_fit_sums", named, ("aug_starts", "aug_ends"))
    if log and y is None:
        raise ValueError("aug_fit_sums: the log form takes the int32 targets")
    if y is not None and (y.dtype != torch.int32 or y.shape != x.shape):
        raise ValueError("aug_fit_sums: y must be int32 shaped like x")
    if x.is_cpu:
        return aug_fit_sums_plain(x, y, aug_starts, aug_ends, log=log)
    B = aug_starts.shape[0]
    if B == 0:
        return tuple(x.new_empty(0) for _ in range(3))
    form = SUMS_FORMS["log" if log else ("xx" if y is None else "xy")]
    if y is None:
        y = torch.empty(0, dtype=torch.int32, device=x.device)
    capacity = fit_capacity(x.shape[0], B)
    out, _ = _build.launch("rmi_aug_fit_sums", x, y, aug_starts, aug_ends, form, (3, B), B,
                           1 + 7 * capacity, capacity)
    return out.unbind(0)


def scan_levels(n: int) -> int:
    """Levels of segments._row_scan over n values (rows of 1024)."""
    levels = 1
    while n > 1024:
        n, levels = -(-n // 1024), levels + 1
    return levels


def _sum_tol(v, w, lo, hi, kernel_ulps):
    """How far a kernel's sum of v (times w, where given) over each range
    [lo, hi) may lie from the plain version's prefix-sum difference: 2^11
    L u P on the plain side (fit_tolerance says why), kernel_ulps u of the
    range's sum of |v| on the kernel's."""
    a = (v.double() if w is None else v * w).abs()
    total = float(a.sum())
    s_abs = seg.range_sum(a, lo, hi).abs()
    return 2048 * scan_levels(v.shape[0]) * _U * total + kernel_ulps * _U * s_abs


def fit_sums_tolerance(x, y, aug_starts, aug_ends, want, log=False):
    """Per-range tolerances of aug_fit_sums on the card against its plain
    version's outputs ``want`` (cnt, sum x, sum y), as fit_tolerance
    derives them for the sums before its means: the counts exact on both
    sides, the sum of y exact in the kernel (the log form's sum of ln y
    within (cnt + 2) u, an ulp of each ln y allowed), the plain sums within
    2^11 L u P of the exact ones, the kernel's within cnt u S."""
    lo, hi = aug_starts, aug_ends
    cnt = want[0]
    zero = torch.zeros_like(cnt)
    if y is None:
        return [zero, _sum_tol(x, None, lo, hi, cnt), zero]
    yv, w = target_terms(y, log)
    return [zero, _sum_tol(x, w, lo, hi, cnt), _sum_tol(yv, w, lo, hi, cnt + 2 if log else 0.0)]


def centered_tolerance(x, y, mean_x, mean_y, aug_starts, aug_ends, want, log=False):
    """Per-leaf tolerances of aug_centered_moments on int32 targets (K2's
    dp calls, given the means) against its plain version's ``want`` (m2,
    c): the two sides take the same means, so they differ by summation
    alone, each within cnt u of the sum of |term| (m2, and at most
    sqrt(m2 syy) for c, syy the y variance sum), and in the log form by an
    ulp of each ln y where CUDA's log and the plain version's differ, 2 u
    sum w |x - mean_x| |ln y| in c."""
    lo, hi = aug_starts, aug_ends
    yv, w = target_terms(y, log)
    cnt = (hi - lo).double()
    m2, c = want
    syy = aug_centered_moments_plain(yv, yv, mean_y, mean_y, lo, hi, weights=w)[0]
    tm2 = (2 * cnt + 4) * _U * m2.abs()
    tc = (2 * cnt + 4) * _U * torch.sqrt(m2.clamp(min=0) * syy.clamp(min=0))
    if log:
        leaf, elem = span_elements(lo, hi)
        dx_ln = ((x[elem] - mean_x[leaf]) * yv[elem] * w[elem]).abs()
        tc = tc + 2 * _U * torch.zeros_like(tc).index_add_(0, leaf, dx_ln)
    return [tm2, tc]


def fit_tolerance(x, y, aug_starts, aug_ends, want, log_form=False):
    """Per-leaf tolerances of aug_fit_moments (or, with ``log_form``,
    aug_fit_log_moments) on the card against its plain version's outputs
    ``want`` (in their order), from how the two round.  The plain sums
    are differences of two prefix sums: each prefix value takes at most
    1024 adds a level of the row scan, L levels, every add rounding by at
    most u P (u = 2^-53, P the sum of |v| over the whole array), so a sum
    lies within 2^11 L u P of the exact one; the kernel's adds cnt values,
    within cnt u S (S the leaf's sum of |v|; its sum of y is exact).  A
    mean moves by that over max(cnt, 1) and a rounding on each side; the
    centered sums, taken about the two means, differ by cnt (dmx)^2 and
    cnt dmx dmy (their first-order terms vanish about the exact means)
    and by each side's summation, within cnt u of sum |term|, which is m2
    and at most sqrt(m2 syy) for c (syy the y variance sum).  The log form
    sums x w and ln(y) w, cnt = sum w (exact on both sides: its tolerance
    is 0), and its sum of ln y is no longer exact; each ln y may differ by
    an ulp, 2 u |ln y|, where the kernel's log and the plain version's do
    (CUDA's against glibc's on the CPU), which moves the sum of ln y by
    2 u S and c by 2 u sum w |x - mean_x| |ln y|."""
    n, lo, hi = x.shape[0], aug_starts, aug_ends
    if log_form:
        ln, w = _log_targets(y)
        cnt = want[0]
        want = want[1:]
    else:
        ln, w = (None if y is None else y.double()), None
        cnt = (hi - lo).double()
    safe = cnt.clamp(min=1.0)

    def mean_tol(v, mean, kernel_ulps):
        return _sum_tol(v, w, lo, hi, kernel_ulps) / safe + 4 * _U * mean.abs()

    tx = mean_tol(x, want[0], cnt)
    m2 = want[-2] if y is not None else want[1]
    tm2 = (2 * cnt + 4) * _U * m2.abs() + cnt * (2 * tx) ** 2
    if y is None:
        return [tx, tm2]
    ty = mean_tol(ln, want[1], cnt + 2 if log_form else 0.0)
    syy = (aug_centered_xx_plain(ln, want[1], lo, hi) if w is None else
           aug_centered_moments_plain(ln, ln, want[1], want[1], lo, hi, weights=w)[0])
    tc = ((2 * cnt + 4) * _U * torch.sqrt(m2.clamp(min=0) * syy.clamp(min=0))
          + 4 * cnt * tx * ty)
    if not log_form:
        return [tx, ty, tm2, tc]
    leaf, elem = span_elements(lo, hi)
    dx_ln = ((x[elem] - want[0][leaf]) * ln[elem] * w[elem]).abs()
    tc = tc + 2 * _U * torch.zeros_like(tc).index_add_(0, leaf, dx_ln)
    return [torch.zeros_like(cnt), tx, ty, tm2, tc]
