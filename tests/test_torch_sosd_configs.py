"""The reference's five other SOSD CI configurations (tests/test_sosd.py:
43-50, with their flags) built by rmi_tpu and by the port on the CPU, on
2^16 synthetic keys of their kind from seed 7 (SOSD_SYNTH.json's keys at a
small n), each at its own branching factor:

  simple_model_wiki  cubic,linear 262144
  simple_model_osm   robust_linear,linear 262144
  radix_model_wiki   radix,linear 1024
  cache_fix_wiki     linear_spline,linear 4194304 --bounded 8
  cache_fix_osm      cubic,linear 786432 --bounded 8

Each is built twice: at its own branching factor, as the reference's CI
builds it (at 2^16 keys almost every leaf is empty, and the max error is
the key or knot count at the empty final leaf: the reference's unpatched
trailing empty leaf, which both packages keep); and at its own keys a leaf,
B * 2^16 / 200M leaves (at least 64, as chip_smoke's cross_check scales B),
where the leaves hold keys and the fits decide the errors.

The two packages' keys are equal; a cachefix configuration goes through
train_bounded in both, its knots equal and its RMI over them compared.
Held equal: RMI_SIZE, max_err and its leaf.  Tolerances (chip_smoke.
cross_check's rules for two builds of one configuration): leaf errors
differ by at most 1 on at most max(2, 1/1000 of the non-empty leaves)
leaves (the order of the fit's sums: rmi_tpu takes a leaf's moments as
differences of prefix sums from key 0; ROADMAP Queue 3, closed), as may
the keys the two tops route to a leaf, and avg_log2 is within 1e-7
relative of rmi_tpu's beyond what those leaves can move it.  The port's
index holds its bound on every key (cachefix: |pos - lb| <= 8 and err =
8) and its search is exact (cachefix: with the original keys).
"""

import functools

import jax
import numpy as np
import pytest

import rmi_tpu
from rmi_tpu.data import RMIDataset as JDataset
from rmi_tpu.data import synthetic_dataset as j_synthetic
from rmi_tpu.keys import KeyType as JKeyType
from rmi_tpu.keys import as_float as j_as_float
from rmi_tpu.models import get_model as j_get_model
from rmi_tpu.train import two_layer as j_two_layer

import rmi_tpu_torch as rt
from rmi_tpu_torch import keys as tkeys
from rmi_tpu_torch.data import synthetic_dataset
from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.models import get_model
from rmi_tpu_torch.train import two_layer

N = 1 << 16
SOSD_N = 200_000_000          # the keys of SOSD_SYNTH.json's builds
SEED = 7
# config -> (key kind, models, branching factor, --bounded line or None)
CONFIGS = {"simple_model_wiki": ("wiki", "cubic,linear", 262144, None),
           "simple_model_osm": ("osm", "robust_linear,linear", 262144, None),
           "radix_model_wiki": ("wiki", "radix,linear", 1024, None),
           "cache_fix_wiki": ("wiki", "linear_spline,linear", 4194304, 8),
           "cache_fix_osm": ("osm", "cubic,linear", 786432, 8)}
AVG_LOG2_RTOL = 1e-7


@functools.lru_cache(maxsize=None)
def _keys(kind):
    keys = synthetic_dataset(kind, N, KeyType.U64, seed=SEED)
    np.testing.assert_array_equal(keys, j_synthetic(kind, N, JKeyType.U64, seed=SEED))
    return keys


def _j_counts(rj, keys, B):
    """Keys (knots) rmi_tpu's top routes to each leaf."""
    k = JDataset.from_numpy(keys).keys
    xraw = j_as_float(k)
    t = jax.jit(lambda k, xraw: j_two_layer.predict_top_assignment(
        j_get_model(rj.top_type), rj.device_top_params, k,
        (xraw - rj.norm_offset) * rj.norm_scale, xraw, B - 1))(k, xraw)
    return np.bincount(np.asarray(t), minlength=B)


@pytest.mark.parametrize("scale", ["own_B", "own_keys_a_leaf"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_config_is_rmi_tpus(config, scale):
    kind, spec, B, line = CONFIGS[config]
    if scale == "own_keys_a_leaf":
        B = max(64, B * N // SOSD_N)
    keys = _keys(kind)
    if line:
        rj = rmi_tpu.train_bounded(JDataset.from_numpy(keys), spec, B, line)
        rp = rt.train_bounded(rt.RMIDataset.from_numpy(keys, device="cpu"), spec, B, line)
        for a, b in zip(rp.cache_fix, rj.cache_fix):
            np.testing.assert_array_equal(a, b)
        served = rj.cache_fix[1]            # the RMI's keys: the knots
    else:
        rj = rmi_tpu.train(JDataset.from_numpy(keys), spec, B)
        rp = rt.train(rt.RMIDataset.from_numpy(keys, device="cpu"), spec, B)
        served = keys
    assert rt.rmi_size(rp) == rmi_tpu.rmi_size(rj)
    assert (rp.model_max_error, rp.model_max_error_idx) == (rj.model_max_error,
                                                           rj.model_max_error_idx)
    if scale == "own_B":
        assert rp.model_max_error_idx == B - 1 and rp.model_max_error == served.size

    # leaf errors and routing: summation order only
    t = two_layer.top_assignment(get_model(rp.top_type), rp.device_top_params, rp.keys,
                                 rp.norm_offset, rp.norm_scale, B - 1, rp.key_type)
    cnt_p, cnt_j = np.bincount(t.numpy(), minlength=B), _j_counts(rj, served, B)
    e_p, e_j = rp.leaf_errors.numpy(), np.asarray(rj.leaf_errors).astype(np.int64)
    few = max(2, np.count_nonzero(cnt_j) // 1000)
    assert np.abs(e_p - e_j).max() <= 1 and np.count_nonzero(e_p != e_j) <= few
    assert np.count_nonzero(cnt_p != cnt_j) <= few
    moved = (cnt_p != cnt_j) | (e_p != e_j)
    movable = np.sum(np.abs(cnt_p * np.log2(2.0 * e_p + 2.0)
                            - cnt_j * np.log2(2.0 * e_j + 2.0))[moved]) / served.size
    gap = rp.model_avg_log2_error - rj.model_avg_log2_error
    assert abs(gap) <= movable + AVG_LOG2_RTOL * abs(rj.model_avg_log2_error)

    # the bound on every key, and exact search
    img = tkeys.to_image(keys)
    guess, err = (a.numpy() for a in rt.lookup(rp, img))
    lb = np.searchsorted(keys, keys, side="left")
    if line:
        assert np.all(np.abs(guess - lb) <= line) and np.all(err == line)
    else:
        assert np.all(np.abs(guess - lb) <= err)
    rng = np.random.default_rng(SEED)
    q = np.concatenate([keys, rng.integers(int(keys[0]) - 5, int(keys[-1]) + 5, 4096,
                                           dtype=np.uint64),
                        np.asarray([0, 2 ** 64 - 1], np.uint64)])
    got = rt.search(rp, tkeys.to_image(q), keys=img if line else None)
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(keys, q, side="left"))
