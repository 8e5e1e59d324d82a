"""Plain versions of the port's kernels (K1-K4) against rmi_tpu.

On the CPU each rmi_tpu_torch wrapper runs its plain PyTorch version,
the definition its CUDA kernel is held to on the card
(tests/test_torch_cuda_kernels.py).  Here those plain versions meet the
JAX functions on the same numpy inputs:

  * K1 (scan) bit-equal to rmi_tpu.ops.scan_kernel.scan_i32 run in
    Pallas interpret mode: max and min never round.
  * K2 (moments) within rtol 1e-9 of segments.aug_centered_moments
    (prefix-sum differences vs per-leaf sums: summation order) and of
    aug_centered_moments_pallas (float-float products), plus an atol of
    1e-15 per summed term for leaves whose moments are near 0.
  * K3 (sweep) and K4 (leaf eval) bit-equal to JAX's jitted f64 path,
    which XLA computes as fma(beta, x, alpha); against the Pallas
    float-float kernels in interpret mode, integer outputs may differ by
    1 on at most 0.1% of elements.
  * K3 and K4 for loglinear, normal and lognormal rows (the port's own
    leaf fits of the same keys) bit-equal to rmi_tpu's jitted predict:
    exp1 of the FMA, and phi with the two FMAs XLA forms; lognormal
    through the lognormal input transform, applied before the kernel.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rmi_tpu.models import get_model as j_get_model
from rmi_tpu.models.base import predict_clamped as j_predict_clamped
from rmi_tpu.models.linear import _linear_predict as j_linear_predict
from rmi_tpu.ops import eval_kernel as j_eval
from rmi_tpu.ops import scan_kernel as j_scan
from rmi_tpu.ops import sweep_kernel as j_sweep
from rmi_tpu.utils import segments as j_seg
from rmi_tpu_torch.models import get_model
from rmi_tpu_torch.models.base import kernel_input
from rmi_tpu_torch.ops import eval_kernel, scan_kernel, select_kernel, sweep_kernel
from rmi_tpu_torch.utils import segments as t_seg

N = (1 << 15) + 517          # not a multiple of any kernel block
B = 1024


def _inputs(seed=0):
    """Normalized keys with duplicate runs, FixDups targets, monotone
    leaf ids and per-leaf least-squares rows, all numpy."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(size=N) * (rng.random(N) > 0.05)   # ~5% duplicates
    x = np.cumsum(gaps)
    x = (x - x[0]) / (x[-1] - x[0])
    first = np.concatenate([[True], x[1:] != x[:-1]])
    y = np.maximum.accumulate(np.where(first, np.arange(N), 0)).astype(np.int32)
    t = np.clip(np.floor(x * B), 0, B - 1).astype(np.int32)
    cnt = np.bincount(t, minlength=B).astype(np.float64)
    mx = np.bincount(t, x, B) / np.maximum(cnt, 1)
    my = np.bincount(t, y, B) / np.maximum(cnt, 1)
    dx = x - mx[t]
    m2 = np.bincount(t, dx * dx, B)
    c = np.bincount(t, dx * (y - my[t]), B)
    beta = np.where(m2 > 0, c / np.where(m2 > 0, m2, 1.0), 0.0)
    w = np.stack([my - beta * mx, beta], axis=1)
    return x, y, t, w


@pytest.mark.parametrize("is_max,reverse", [(True, False), (True, True),
                                            (False, False), (False, True)])
def test_k1_scan_matches_pallas(is_max, reverse):
    rng = np.random.default_rng(1)
    n = 32768 + 4321                     # one full TPU block and a ragged one
    v = rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32)
    fill = t_seg.INT32_MIN if is_max else t_seg.INT32_MAX
    got = scan_kernel.scan_i32(torch.from_numpy(v), is_max=is_max, fill=fill,
                               reverse=reverse)
    want = j_scan.scan_i32(jnp.asarray(v), is_max=is_max, fill=fill,
                           reverse=reverse)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_k2_moments_match_jax(ref):
    x, y, t, _ = _inputs()
    yf = y.astype(np.float64)
    spans = t_seg.make_spans(torch.from_numpy(t), B)
    cnt = t_seg.aug_count(spans)
    sx = t_seg.range_sum(torch.from_numpy(x), spans.aug_starts, spans.aug_ends)
    sy = t_seg.range_sum(torch.from_numpy(yf), spans.aug_starts, spans.aug_ends)
    mean_x, mean_y = sx / cnt.clamp(min=1), sy / cnt.clamp(min=1)
    m2, c = select_kernel.aug_centered_moments(
        torch.from_numpy(x), torch.from_numpy(yf), mean_x, mean_y,
        spans.aug_starts, spans.aug_ends)

    jspans = j_seg.make_spans(jnp.asarray(t), B)
    np.testing.assert_array_equal(np.asarray(jspans.aug_starts),
                                  spans.aug_starts.numpy())
    np.testing.assert_array_equal(np.asarray(jspans.aug_ends),
                                  spans.aug_ends.numpy())
    args = (jspans, jnp.asarray(x), jnp.asarray(yf), jnp.asarray(mean_x.numpy()),
            jnp.asarray(mean_y.numpy()))
    if ref == "xla":
        jm2, jc = j_seg.aug_centered_moments(*args)
    else:
        jm2, jc, ovf = j_seg.aug_centered_moments_pallas(*args, span=B)
        assert int(ovf) == 0
    atol = 1e-15 * cnt.numpy()
    for got, want in ((m2.numpy(), np.asarray(jm2)), (c.numpy(), np.asarray(jc))):
        bad = np.abs(got - want) > atol + 1e-9 * np.abs(want)
        assert not bad.any(), (np.flatnonzero(bad)[:5], got[bad][:5], want[bad][:5])
    assert (cnt.numpy() > 0).sum() > B // 2


def _jax_sweep(xn, y, t, w, n):
    """two_layer.py:269-280 of rmi_tpu, jitted on the CPU."""
    p = jnp.floor(j_linear_predict(w, t, xn))
    p = jnp.where(jnp.isnan(p), 0.0, jnp.clip(p, 0.0, jnp.float64(n)))
    pred = p.astype(jnp.int32)
    return jnp.abs(jnp.minimum(pred, n) - jnp.minimum(jnp.minimum(y, n), n))


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_k3_sweep_matches_jax(ref):
    x, y, t, w = _inputs(2)
    got = sweep_kernel.sweep_errors(torch.from_numpy(x), torch.from_numpy(y),
                                    torch.from_numpy(t), torch.from_numpy(w), N,
                                    leaf_type="linear")
    got = got.numpy()
    if ref == "xla":
        want = jax.jit(_jax_sweep, static_argnums=4)(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(t), jnp.asarray(w), N)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert np.count_nonzero(got) > N // 2
        return
    jt = jnp.asarray(t)
    blk_lo, _ = j_sweep.block_leaf_bounds(jt)
    want, ovf = j_sweep.sweep_errors(
        jnp.asarray(x), jnp.asarray(y), jt, j_sweep.pad_param_table(jnp.asarray(w)),
        blk_lo, leaf_type="linear", n=N, B=B, ppm=2, span=B)
    assert int(ovf) == 0
    diff = np.abs(got.astype(np.int64) - np.asarray(want).astype(np.int64))
    assert diff.max() <= 1 and np.count_nonzero(diff) <= N // 1000


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_k4_leaf_eval_matches_jax(ref):
    x, _, t, w = _inputs(3)
    rng = np.random.default_rng(4)
    sel = rng.integers(0, N, 20_000)
    # queries between keys too: exercises floor boundaries off the key set
    xq = np.concatenate([x[sel], np.clip(x[sel] + rng.normal(0, 1e-5, sel.size), 0, 1)])
    leaf = np.concatenate([t[sel], t[sel]]).astype(np.int64)
    bound = N - 1
    got = eval_kernel.leaf_eval_clamped(torch.from_numpy(xq), torch.from_numpy(w),
                                        torch.from_numpy(leaf), bound,
                                        leaf_type="linear").numpy()
    if ref == "xla":
        want = jax.jit(lambda w_, i_, x_: j_predict_clamped(
            j_linear_predict(w_, i_, x_), bound))(
            jnp.asarray(w), jnp.asarray(leaf), jnp.asarray(xq))
        np.testing.assert_array_equal(got, np.asarray(want))
        return
    rows = j_sweep.pad_param_table(jnp.asarray(w))[jnp.asarray(leaf)]
    want = j_eval.leaf_eval_clamped(jnp.asarray(xq), rows, leaf_type="linear",
                                    ppm=2, n=bound)
    diff = np.abs(got.astype(np.int64) - np.asarray(want).astype(np.int64))
    assert diff.max() <= 1 and np.count_nonzero(diff) <= xq.size // 1000


def _zoo_inputs(leaf, seed):
    """(model input x, y, t, rows) of _inputs with rows from the port's
    own fit of leaf model ``leaf``; lognormal's x are raw key values."""
    x, y, t, _ = _inputs(seed)
    if get_model(leaf).input_domain == "raw":
        x = x * 2.0 ** 50 + 1.0
    tt = torch.from_numpy(t)
    w = get_model(leaf).fit_leaves(torch.from_numpy(x), torch.from_numpy(y),
                                   t_seg.make_spans(tt, B))
    return x, y, t, w.numpy()


@pytest.mark.parametrize("leaf", ["loglinear", "normal", "lognormal"])
def test_k3_sweep_zoo_matches_jax(leaf):
    x, y, t, w = _zoo_inputs(leaf, 5)
    xin = kernel_input(get_model(leaf), torch.from_numpy(x))
    got = sweep_kernel.sweep_errors(xin, torch.from_numpy(y), torch.from_numpy(t),
                                    torch.from_numpy(w), N, leaf_type=leaf).numpy()

    def jax_sweep(x_, y_, t_, w_):
        p = jnp.floor(j_get_model(leaf).predict({"w": w_}, t_, x_))
        p = jnp.where(jnp.isnan(p), 0.0, jnp.clip(p, 0.0, jnp.float64(N)))
        return jnp.abs(p.astype(jnp.int32) - jnp.minimum(y_, N))
    want = jax.jit(jax_sweep)(*map(jnp.asarray, (x, y, t, w)))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert np.count_nonzero(got) > N // 10


@pytest.mark.parametrize("leaf", ["loglinear", "normal", "lognormal"])
def test_k4_leaf_eval_zoo_matches_jax(leaf):
    x, _, t, w = _zoo_inputs(leaf, 6)
    rng = np.random.default_rng(7)
    sel = rng.integers(0, N, 20_000)
    span = x[-1] - x[0]
    xq = np.concatenate([x[sel], x[sel] + rng.normal(0, 1e-5 * span, sel.size),
                         [np.nan, np.inf, -np.inf, -1.0, 0.0]])
    leaf_ids = np.concatenate([t[sel], t[sel], t[:5]]).astype(np.int64)
    bound = N - 1
    got = eval_kernel.leaf_eval_clamped(
        kernel_input(get_model(leaf), torch.from_numpy(xq)), torch.from_numpy(w),
        torch.from_numpy(leaf_ids), bound, leaf_type=leaf).numpy()
    want = jax.jit(lambda w_, i_, x_: j_predict_clamped(
        j_get_model(leaf).predict({"w": w_}, i_, x_), bound))(
        *map(jnp.asarray, (w, leaf_ids, xq)))
    np.testing.assert_array_equal(got, np.asarray(want))
