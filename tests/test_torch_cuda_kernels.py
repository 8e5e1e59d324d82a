"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped without a CUDA device: a CUDA kernel has no
CPU mode (on the CPU each wrapper runs its plain version, which
tests/test_torch_kernels_ref.py holds to rmi_tpu).  Needs no JAX, so it
runs on a machine without it:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: K1, K3 and K4 bit-equal (max/min never round; K3 and K4 are
compared with the plain version on CPU copies, where torch.addcmul is an
exact FMA); K2 within rtol 1e-9 (summation order) plus 1e-12 of the
Cauchy-Schwarz bound sqrt(m2 * sum (y-my)^2) for c.
"""

import numpy as np
import pytest
import torch

import rmi_tpu_torch as rt
from rmi_tpu_torch import data as rdata
from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.ops import _build, eval_kernel, scan_kernel, select_kernel, sweep_kernel
from rmi_tpu_torch.utils import segments as seg

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _leaf_inputs(n, B, seed):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.exponential(size=n) * (rng.random(n) > 0.05))
    x = (x - x[0]) / (x[-1] - x[0])
    first = np.concatenate([[True], x[1:] != x[:-1]])
    y = np.maximum.accumulate(np.where(first, np.arange(n), 0)).astype(np.int32)
    t = np.clip(np.floor(x * B), 0, B - 1).astype(np.int32)
    beta = rng.normal(n, n / 100, B)
    alpha = np.bincount(t, y - beta[t] * x, B) / np.maximum(np.bincount(t, None, B), 1)
    w = np.stack([alpha, beta], axis=1)
    return (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t),
            torch.from_numpy(w))


@pytest.mark.parametrize("is_max,reverse", [(True, False), (True, True),
                                            (False, False), (False, True)])
@pytest.mark.parametrize("n", [1, 4095, 4097, 1_000_003])
def test_k1_scan(dev, is_max, reverse, n):
    v = torch.randint(-(1 << 30), 1 << 30, (n,), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(n))
    fill = seg.INT32_MIN if is_max else seg.INT32_MAX
    before = _build.launches["rmi_scan_i32"]
    got = scan_kernel.scan_i32(v.to(dev), is_max=is_max, fill=fill, reverse=reverse)
    torch.cuda.synchronize()
    assert _build.launches["rmi_scan_i32"] == before + 1
    want = scan_kernel.scan_i32_plain(v, is_max=is_max, reverse=reverse)
    assert torch.equal(got.cpu(), want)


def test_k2_moments(dev):
    x, y, t, _ = _leaf_inputs(300_001, 4096, 1)
    spans = seg.make_spans(t, 4096)
    cnt = seg.aug_count(spans).clamp(min=1)
    yf = y.double()
    mx = seg.range_sum(x, spans.aug_starts, spans.aug_ends) / cnt
    my = seg.range_sum(yf, spans.aug_starts, spans.aug_ends) / cnt
    args = (x, yf, mx, my, spans.aug_starts, spans.aug_ends)
    m2, c = select_kernel.aug_centered_moments(*[a.to(dev) for a in args])
    torch.cuda.synchronize()
    wm2, wc = select_kernel.aug_centered_moments_plain(*args)
    syy = select_kernel.aug_centered_moments_plain(yf, yf, my, my, *args[4:])[0]
    assert ((m2.cpu() - wm2).abs() <= 1e-9 * wm2.abs()).all()
    assert ((c.cpu() - wc).abs()
            <= 1e-9 * wc.abs() + 1e-12 * torch.sqrt(wm2 * syy)).all()


def test_k3_sweep(dev):
    x, y, t, w = _leaf_inputs(500_009, 2048, 2)
    n = x.shape[0]
    got = sweep_kernel.sweep_errors(x.to(dev), y.to(dev), t.to(dev), w.to(dev), n)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), sweep_kernel.sweep_errors_plain(x, y, t, w, n))


@pytest.mark.parametrize("bound", [0, 1000, 499_999])
def test_k4_leaf_eval(dev, bound):
    x, _, t, w = _leaf_inputs(500_009, 2048, 3)
    x = torch.cat([x, torch.tensor([float("nan"), float("inf"), -float("inf"), -1.0])])
    leaf = torch.cat([t, t[:4]]).long()
    got = eval_kernel.leaf_eval_clamped(x.to(dev), w.to(dev), leaf.to(dev), bound)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), eval_kernel.leaf_eval_clamped_plain(x, w, leaf, bound))


def test_wrappers_refuse_bad_inputs(dev):
    v = torch.zeros(10, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        scan_kernel.scan_i32(v, is_max=True, fill=0)
    x = torch.zeros(10, dtype=torch.float64, device=dev)
    w = torch.zeros(4, 2, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        eval_kernel.leaf_eval_clamped(x, w, torch.zeros(10, dtype=torch.int64), 5)


def test_card_build_matches_cpu_build(dev):
    keys = rdata.books_like_on_device(1 << 18, 5, dev)
    card = rt.train(rdata.RMIDataset(keys, KeyType.U64), "cubic,linear", 1024)
    cpu = rt.train(rdata.RMIDataset(keys.cpu(), KeyType.U64), "cubic,linear", 1024)
    assert card.model_max_error == cpu.model_max_error
    diff = (card.leaf_errors.cpu() - cpu.leaf_errors).abs()
    assert int(diff.max()) <= 1 and int((diff > 0).sum()) <= 4
    lb = torch.searchsorted(keys, keys, side="left")
    g, e = rt.lookup(card, keys)
    assert int(((g - lb).abs() > e).sum()) == 0
    assert torch.equal(rt.search(card, keys), lb)
