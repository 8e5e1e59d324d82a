"""PARITY.json's 26 rows at n = 1M: the port's build against rmi_tpu's on
the CPU, from the same keys (``slow``; not in tier-1).

    JAX_PLATFORMS=cpu python -m pytest -q -p no:cacheprovider -m slow \\
        tests/test_torch_parity_large.py

The keys come from copies of tools/parity_report.py's generators
(books_like, dup_heavy, books_like_u32, f64_like).  Each of the 25 model
rows is held to the PARITY rule (ROADMAP.md, North star;
tests/test_torch_f64.assert_parity): FixDups and max_err with its leaf
equal, at most 3 leaf errors differing, each by 1, avg_log2 within 1e-7
relative beyond what they explain; the bound on every key and exact
search of the keys.  Cubic leaves get rmi_tpu's own rounding allowance
(tests/test_torch_cubic_leaves.py): their fit rounds otherwise in
rmi_tpu's monolithic build than jitted alone.  The cachefix row
(``linear_spline,linear 4096 --bounded 8``) has the same knots in both
packages, its RMI over them held to the same rule, and |pos - lb| <= 8
for every key.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import rmi_tpu
from rmi_tpu.data import RMIDataset as JDataset

import rmi_tpu_torch as rt
from rmi_tpu_torch import keys as tkeys
from rmi_tpu_torch import lookup_fast as lf
from rmi_tpu_torch.models import get_model
from rmi_tpu_torch.train import two_layer
from rmi_tpu_torch.utils import segments as seg
from test_torch_artifacts import carry
from test_torch_f64 import assert_parity

pytestmark = pytest.mark.slow

N = 1_000_000


def books_like(n: int, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    csum = np.cumsum(rng.exponential(size=n))
    return np.maximum((csum * (2.0 ** 56 / csum[-1])).astype(np.uint64), np.uint64(1))


def dup_heavy(n: int, seed: int = 9) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = np.sort(rng.integers(0, n // 64 + 2, size=n, dtype=np.uint64))
    return base * 7 + 3


def books_like_u32(n: int, seed: int = 11) -> np.ndarray:
    rng = np.random.default_rng(seed)
    csum = np.cumsum(rng.exponential(size=n))
    return np.maximum((csum * (2.0 ** 31 / csum[-1])).astype(np.uint32), np.uint32(1))


def f64_like(n: int, seed: int = 13) -> np.ndarray:
    rng = np.random.default_rng(seed)
    csum = np.cumsum(rng.exponential(size=n))
    return np.sort((csum * (1e12 / csum[-1])).astype(np.float64))


GEN = {"books": books_like, "dups": dup_heavy, "u32": books_like_u32, "f64": f64_like}

# tools/parity_report.py's CONFIGS, the rows of PARITY.json
CONFIGS = [
    ("linear", "linear", 1024, "books"), ("robust_linear", "linear", 1024, "books"),
    ("linear_spline", "linear", 1024, "books"), ("cubic", "linear", 1024, "books"),
    ("loglinear", "linear", 1024, "books"), ("normal", "linear", 1024, "books"),
    ("lognormal", "linear", 1024, "books"), ("radix", "linear", 1024, "books"),
    ("bradix", "linear", 1024, "books"), ("radix18", "linear", 1024, "books"),
    ("histogram", "linear", 1024, "books"), ("cubic", "cubic", 1024, "books"),
    ("cubic", "linear_spline", 1024, "books"), ("cubic", "radix8", 1024, "books"),
    ("linear", "loglinear", 256, "books"), ("linear", "normal", 256, "books"),
    ("linear", "lognormal", 256, "books"), ("linear", "robust_linear", 1024, "books"),
    ("cubic", "linear", 1024, "dups"), ("linear", "linear", 1024, "dups"),
    ("bradix", "linear", 1024, "dups"), ("linear", "linear", 100, "u32"),
    ("cubic", "linear", 1024, "u32"), ("cubic", "linear", 1024, "f64"),
    ("linear_spline", "linear", 1024, "f64"),
]


@functools.lru_cache(maxsize=None)
def _keys(kind):
    return GEN[kind](N)


def _cubic_self_difference(rj, rc):
    """Leaf errors on which rmi_tpu's build differs from a cubic leaf fit
    on its own leaf assignment as rmi_tpu's fit rounds compiled alone (the
    port's fit, tests/test_torch_cubic_leaves.py), swept by the port's
    stage C (bit-equal to rmi_tpu's on given rows): the leaves its
    monolithic build rounds otherwise."""
    B = rc.branching_factor
    x = two_layer.model_float_input(get_model("cubic"), rc.keys, rc.norm_offset,
                                    rc.norm_scale, rc.key_type)
    t = two_layer.top_assignment(get_model(rc.top_type), rc.device_top_params, rc.keys,
                                 rc.norm_offset, rc.norm_scale, B - 1,
                                 rc.key_type).to(torch.int32)
    spans = seg.make_spans(t, B)
    next_idx, next_key, prev_key = two_layer.lower_bound_fills(spans, rc.keys, rc.key_type)
    jw = get_model("cubic").fit_leaves(x, two_layer.fixdups_i32(rc.keys), spans)
    patch = ~spans.nonempty & (torch.arange(B) < B - 1)
    jw = torch.where(patch[:, None], get_model("cubic").constant_params(next_idx.double()),
                     jw)
    errs, _ = two_layer.sweep_body(rc.keys, x, two_layer.fixdups_i32(rc.keys), spans, jw,
                                   next_idx, next_key, prev_key, rc.norm_offset,
                                   rc.norm_scale, rc.key_type, leaf_type="cubic")
    return int((errs != rc.leaf_errors).sum())


@pytest.mark.parametrize("top,leaf,B,kind", CONFIGS,
                         ids=[f"{t}-{lf_}-{b}-{k}" for t, lf_, b, k in CONFIGS])
def test_parity_row(top, leaf, B, kind):
    keys = _keys(kind)
    spec = f"{top},{leaf}"
    rj = rmi_tpu.train(JDataset.from_numpy(keys), spec, B)
    rj.raw_inputs = rj.raw_thunk.__defaults__
    rp = rt.train(rt.RMIDataset.from_numpy(keys, device="cpu"), spec, B)
    rc = carry(rj, keys)
    allowed = 3 + (_cubic_self_difference(rj, rc) if leaf == "cubic" else 0)
    assert_parity(keys, rj, rp, rc, allowed=allowed)
    g, e = rt.lookup(rp, rp.keys)
    lb = np.searchsorted(keys, keys, side="left")
    assert int(np.sum(np.abs(g.numpy() - lb) > e.numpy())) == 0
    np.testing.assert_array_equal(rt.search(rp, rp.keys).numpy(), lb)
    assert lf.get_plan(rp).kind == rmi_tpu.lookup_fast.get_plan(rj).kind


def test_parity_cachefix_row():
    keys = _keys("books")
    rj = rmi_tpu.train_bounded(JDataset.from_numpy(keys), "linear_spline,linear", 4096, 8)
    rp = rt.train_bounded(rt.RMIDataset.from_numpy(keys, device="cpu"),
                          "linear_spline,linear", 4096, 8)
    np.testing.assert_array_equal(rp.cache_fix[1], np.asarray(rj.cache_fix[1]))
    np.testing.assert_array_equal(rp.cache_fix[2], np.asarray(rj.cache_fix[2]))
    knots = rp.cache_fix[1]
    rjk = rmi_tpu.train(JDataset.from_numpy(knots), "linear_spline,linear", 4096)
    assert (rp.model_max_error, rp.model_max_error_idx) == \
        (rjk.model_max_error, rjk.model_max_error_idx)
    diff = np.abs(rp.leaf_errors.numpy() - np.asarray(rjk.leaf_errors).astype(np.int64))
    assert np.count_nonzero(diff) <= 3 and diff.max() <= 1
    img = tkeys.to_image(keys)
    pos, err = rt.lookup(rp, img)
    lb = np.searchsorted(keys, keys, side="left")
    assert (np.abs(pos.numpy() - lb) <= 8).all() and (err.numpy() == 8).all()
    np.testing.assert_array_equal(rt.search(rp, img, keys=img).numpy(), lb)
    gj, _ = rmi_tpu.lookup(rj, jnp.asarray(keys))
    assert np.count_nonzero(pos.numpy() != np.asarray(gj)) <= 8
