"""Integer-output tops in K4's fused lookup (ops/eval_kernel.lookup_clamped,
csrc/eval.cu rmi_lookup_* with csrc/int_top.cuh) on the CPU, where the
wrapper runs its plain version, lookup_steps: the models' own torch.

  (a) the port's lookup route and top, fitted by the port's stage A, are
      bit-equal to rmi_tpu's _rmi_eval (guess, err and leaf) with the
      same parameters over the integer tops x u64, u32 and f64 keys, a
      single distinct key and keys with a 53-bit common prefix
      (test_torch_lookup_kernel.int_top_case: keys 0, 2^63 - 1, 2^63,
      2^64 - 1, queries below the first pivot, every image's extremes,
      runs of equal keys and pivots; for f64 keys -0.0, +-inf, NaN,
      negative values and values from 2^64); the histogram's upper bound
      also over runs of equal pivots;
  (b) with one rmi_tpu build per top type carried across
      (trained_from_numpy: radix, bradix and histogram on u64 keys,
      radix18 on f64 keys), the port's lookup is bit-equal to rmi_tpu's
      _rmi_eval for each leaf kernel, the build's linear leaves and leaf
      rows of the other kernels run through both packages;
  (c) the route: every integer top over an affine leaf is fused; a
      lognormal top or leaf and a hint-table leaf keep the two steps.

test_torch_cuda_kernels.py holds the kernel to the plain version on the
same inputs.  Tolerances: none.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import rmi_tpu
from rmi_tpu import keys as jkeys
from rmi_tpu.data import RMIDataset as JDataset
from rmi_tpu.lookup import _rmi_eval

import rmi_tpu_torch as rt
from rmi_tpu_torch import keys as tkeys
from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.models import REGISTRY, get_model
from rmi_tpu_torch.models.histogram import build_radix_index
from rmi_tpu_torch.ops import eval_kernel
from rmi_tpu_torch.train import two_layer
from test_torch_lookup_kernel import (INT_TOPS, KEY_SETS, LEAVES, int_keys, int_queries,
                                      int_top_case, leaf_table)

M = 3000


@functools.lru_cache(maxsize=None)
def _case(top, leaf, kind):
    return int_top_case(top, leaf, kind, M, 11)


def _jax_top(top_p):
    """The port's integer-top parameters in rmi_tpu's form (the inverse of
    trained_from_numpy's): pivots as u64 keys, int32 tables as u32, every
    other value's bits as u64."""
    out = {}
    for name, v in top_p.items():
        if name == "pivots":
            out[name] = jnp.asarray(tkeys.from_image(v, KeyType.U64))
        elif v.dtype == torch.int32:
            out[name] = jnp.asarray(v.numpy().view(np.uint32))
        else:
            out[name] = jnp.asarray(v.numpy().view(np.uint64))
    return out


def _jax_eval(q, top, top_p, leaf_w, errors, n, kminf, s, key_type):
    """rmi_tpu's (guess, err, leaf) of images ``q`` under linear leaves."""
    B = leaf_w.shape[0]
    out = _rmi_eval(jnp.asarray(tkeys.from_image(q, key_type)), _jax_top(top_p),
                    {"w": jnp.asarray(leaf_w.numpy())}, jnp.asarray(errors.numpy()),
                    jnp.float64(kminf), jnp.float64(s), top_type=top, leaf_type="linear",
                    B=B, n=n, key_type=jkeys.KeyType(key_type.value))
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("top", INT_TOPS)
@pytest.mark.parametrize("kind", KEY_SETS)
def test_integer_top_edges_equal_rmi_tpu(kind, top):
    """The CPU route (lookup_clamped, whose plain version is lookup_steps)
    and the top's leaves against rmi_tpu at every edge; a histogram's
    queries below the first pivot underflow to -1, which the unsigned
    clamp sends to the last leaf."""
    case, key_type = _case(top, "linear", kind)
    q, top_p, leaf_w, errors, n, kminf, s = case
    B = leaf_w.shape[0]
    kw = {"top_type": top, "leaf_type": "linear", "key_type": key_type}
    guess, err = eval_kernel.lookup_clamped(*case, **kw)
    assert guess.dtype == err.dtype == torch.int64
    leaf = two_layer.top_assignment(get_model(top), top_p, q, kminf, s, B - 1, key_type)
    jg, je, jleaf = _jax_eval(q, top, top_p, leaf_w, errors, n, kminf, s, key_type)
    np.testing.assert_array_equal(guess.numpy(), jg)
    np.testing.assert_array_equal(err.numpy(), je)
    np.testing.assert_array_equal(leaf.numpy(), jleaf.astype(np.int64))
    assert int(leaf.min()) >= 0 and int(leaf.max()) <= B - 1
    if top == "histogram":
        below = tkeys.int_image(q, key_type) < top_p["pivots"][0]
        assert bool((leaf[below] == B - 1).all())
        assert bool(below.any()) == (kind in ("single", "narrow"))


def test_histogram_upper_bound_on_equal_pivots():
    """The histogram top over runs of equal pivots and below the first:
    searchsorted(pivots, q, right=True) - 1, -1 going to B - 1, as
    rmi_tpu's upper bound gives it."""
    pivots = tkeys.to_image(np.array([5, 5, 5, 9, 9, 12, 40, 40, 40, 40, 41], np.uint64))
    q = tkeys.to_image(np.arange(0, 45, dtype=np.uint64))
    top_p = {"count": torch.tensor(pivots.shape[0]), "pivots": pivots,
             "radix_index": build_radix_index(pivots)}
    B = 64
    got = two_layer.top_assignment(get_model("histogram"), top_p, q, 0.0, 1.0, B - 1)
    want = torch.searchsorted(pivots, q, right=True) - 1
    assert torch.equal(got, torch.where(want < 0, B - 1, want))
    leaf_w = leaf_table("linear", B, 45, 5)
    _, _, jleaf = _jax_eval(q, "histogram", top_p, leaf_w, torch.zeros(B, dtype=torch.int64),
                            45, 0.0, 1.0, KeyType.U64)
    np.testing.assert_array_equal(got.numpy(), jleaf.astype(np.int64))


def test_top_operands():
    """The top kind and operands rmi_lookup_* takes for each top model."""
    for name, m in REGISTRY.items():
        if m.restriction.value == "bottom" or m.input_domain == "raw":
            continue
        kind = eval_kernel.TOP_KINDS[eval_kernel.top_kind(name)]
        if not m.output_int:
            assert kind == m.leaf_kernel
        elif name.startswith("radix") and name != "radix":
            assert kind == "table"
        else:
            assert kind == name
    (_, top_p, *_), _ = _case("bradix", "linear", "u64")
    _, p, table, pivots, length = eval_kernel.top_operands("bradix", top_p, "cpu")
    assert torch.equal(p, torch.cat([top_p["w_int"], top_p["high"].reshape(1)]))
    assert table.numel() == pivots.numel() == length == 0
    (_, top_p, *_), _ = _case("radix18", "linear", "u64")
    _, p, table, _, length = eval_kernel.top_operands("radix18", top_p, "cpu")
    assert p is top_p["w_int"] and table is top_p["table"] and length == 1 << 18


@pytest.mark.parametrize("top", sorted(n for n, m in REGISTRY.items()
                                       if m.restriction.value != "bottom"))
@pytest.mark.parametrize("leaf", sorted(n for n, m in REGISTRY.items() if m.leaf_capable))
def test_fused_route(top, leaf):
    mtop, mleaf = get_model(top), get_model(leaf)
    two_steps = ("raw" in (mtop.input_domain, mleaf.input_domain)
                 or mleaf.leaf_kernel is None)
    assert eval_kernel.fused_lookup(top, leaf) == (not two_steps)


# (b) against rmi_tpu's _rmi_eval, one build per top type
JAX_BUILDS = [("radix", "u64"), ("bradix", "u64"), ("radix18", "f64"),
              ("histogram", "u64")]
JB = 256


@functools.lru_cache(maxsize=None)
def _jax_build(top, kind):
    keys, key_type = int_keys(kind, 23)
    rj = rmi_tpu.train(JDataset.from_numpy(keys, jkeys.KeyType(key_type.value)),
                       f"{top},linear", JB)
    return keys, key_type, rj


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("top,kind", JAX_BUILDS)
def test_lookup_equals_rmi_tpu(top, kind, leaf):
    keys, key_type, rj = _jax_build(top, kind)
    n = keys.shape[0]
    if leaf == "linear":
        w = np.asarray(rj.device_leaf_params["w"])
    else:
        w = leaf_table(get_model(leaf).leaf_kernel, JB, n, 29).numpy()
    top_p = {k: np.asarray(v) for k, v in rj.device_top_params.items()}
    rc = rt.trained_from_numpy(f"{top},{leaf}", JB, key_type, keys, top_p, w,
                               np.asarray(rj.leaf_errors), rj.norm_offset, rj.norm_scale,
                               device="cpu")
    qn = tkeys.from_image(int_queries(keys, key_type, M, 31), key_type)   # (a)'s classes
    guess, err = rt.lookup(rc, tkeys.to_image(qn))
    jg, je, _ = _rmi_eval(jnp.asarray(qn), rj.device_top_params, {"w": jnp.asarray(w)},
                          rj.leaf_errors, jnp.float64(rj.norm_offset),
                          jnp.float64(rj.norm_scale), top_type=top, leaf_type=leaf, B=JB,
                          n=n, key_type=rj.key_type)
    np.testing.assert_array_equal(guess.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(err.numpy(), np.asarray(je))
