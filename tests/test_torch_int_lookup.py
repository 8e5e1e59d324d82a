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
from rmi_tpu_torch.models.base import clamp_int
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
    _, p, table, pivots, length, route = eval_kernel.top_operands("bradix", top_p, "cpu", 256,
                                                                  "linear")
    assert torch.equal(p, torch.cat([top_p["w_int"], top_p["high"].reshape(1)]))
    assert table.numel() == pivots.numel() == length == route == 0
    (_, top_p, *_), _ = _case("radix18", "linear", "u64")
    _, p, table, _, length, route = eval_kernel.top_operands("radix18", top_p, "cpu", 256,
                                                             "linear")
    assert p is top_p["w_int"] and length == 1 << 18 and route == eval_kernel.FOLDED
    assert table.dtype == torch.int32 and table.shape == (1 << 17,)
    assert torch.equal(eval_kernel.unpack_table(table, 256),
                       clamp_int(top_p["table"].long(), 255))
    (_, top_p, *_), _ = _case("histogram", "linear", "u64")
    _, p, table, pivots, length, route = eval_kernel.top_operands("histogram", top_p, "cpu",
                                                                  256, "cubic")
    assert pivots is top_p["pivots"] and length == pivots.shape[0] == 255
    assert route == eval_kernel.BLOCK


def _table_with_edges(bits, seed):
    """A hint table as the fit makes them: 0 at slot 0, the fill 2^bits
    past the last bucket, leaf ids up to 2^20 + 3 between."""
    rng = np.random.default_rng(seed)
    size = 1 << bits
    t = np.sort(rng.integers(0, (1 << 20) + 4, size))
    t[0], t[-size // 8:] = 0, size
    t[1:9] = [1, 255, 256, 65535, 65536, 65537, (1 << 20) + 3, size]
    return torch.from_numpy(t.astype(np.int32))


@pytest.mark.parametrize("B", [1, 2, 255, 1 << 16, (1 << 16) + 1, 1 << 21])
@pytest.mark.parametrize("bits", [8, 18])
def test_narrowed_table(bits, B):
    """The hint table rmi_lookup_* reads: narrow_table's entries, unpacked,
    equal clamp_int(table, B - 1) at every entry (slot 0's 0, the fill
    2^bits, ids past B - 1), in 16 bits an entry where B <= 2^16 (two to
    an int32 word, the high half past 2^15 too) and 32 above; the fitted
    tables of both fits (a 53-bit prefix: most slots the fill) likewise."""
    table = _table_with_edges(bits, bits + B)
    words = eval_kernel.narrow_table(table, B)
    width = 16 if B <= 1 << 16 else 32
    assert eval_kernel.table_width(B) == width
    assert words.dtype == torch.int32 and words.shape == ((1 << bits) * width // 32,)
    want = clamp_int(table.long(), B - 1)
    got = eval_kernel.unpack_table(words, B)
    assert torch.equal(got, want)
    assert int(got[0]) == 0 and int(got[-1]) == min(1 << bits, B - 1)
    for kind in ("narrow", "u64"):
        (_, top_p, *_), _ = _case(f"radix{bits}", "linear", kind)
        _, _, words, _, length, _ = eval_kernel.top_operands(f"radix{bits}", top_p, "cpu", B,
                                                             "linear")
        assert length == 1 << bits
        assert torch.equal(eval_kernel.unpack_table(words, B),
                           clamp_int(top_p["table"].long(), B - 1))


def test_top_route_edges():
    """top_route at each edge: the largest tree one block stages and one
    byte more, the largest table folded into the rows and one byte more,
    histogram len 0 and 1, radix and bradix with no operand; and the
    routes of chip_smoke's rows (radix18 folded at B = 2^16 and 2^16 + 1,
    a 4095-pivot histogram in a block, radix22 in place)."""
    route, nbytes = eval_kernel.top_route, eval_kernel.operand_bytes
    IN_PLACE, BLOCK, FOLDED = eval_kernel.IN_PLACE, eval_kernel.BLOCK, eval_kernel.FOLDED
    block, fold = eval_kernel.BLOCK_BYTES, eval_kernel.FOLD_BYTES
    assert route("histogram", 16) == route("histogram", block) == BLOCK
    assert route("histogram", block + 1) == IN_PLACE
    assert route("table", 1) == route("table", fold) == FOLDED
    assert route("table", fold + 1) == IN_PLACE
    assert nbytes("histogram", 0, 32) == 0 and route("histogram", 0) == IN_PLACE
    assert nbytes("histogram", 1, 32) == 16 and route("histogram", 16) == BLOCK
    assert nbytes("histogram", 16383, 32) == 1 << 17 == nbytes("histogram", 8192, 32)
    assert nbytes("histogram", 16384, 32) == 1 << 18 > block
    for kind in ("radix", "bradix"):
        assert nbytes(kind, 0, 32) == 0 and route(kind, 0) == IN_PLACE
        assert route(kind, block) == route(kind, fold) == IN_PLACE
    assert route("table", nbytes("table", 1 << 18, 32)) == FOLDED        # radix18, linear
    assert route("table", nbytes("table", 1 << 18, 64)) == FOLDED        # radix18, cubic
    assert route("table", nbytes("table", 1 << 22, 64)) == IN_PLACE      # radix22, cubic
    assert route("histogram", nbytes("histogram", 4095, 32)) == BLOCK
    for top in ("radix", "bradix", "radix8", "radix18", "radix22", "histogram"):
        for B in (1, 1 << 16, (1 << 16) + 1):
            (_, top_p, *_), _ = _case(top, "linear", "u64")
            got = eval_kernel.top_operands(top, top_p, "cpu", B, "cubic")[5]
            kind = eval_kernel.TOP_KINDS[eval_kernel.top_kind(top)]
            length = top_p["table"].shape[0] if kind == "table" else top_p.get(
                "pivots", torch.empty(0)).shape[0]
            assert got == route(kind, nbytes(kind, length, 64))
    names = {t: eval_kernel.route_name(t, r) for t, r in
             (("radix", 0), ("bradix", 0), ("radix22", 0), ("radix18", FOLDED),
              ("histogram", BLOCK), ("histogram", IN_PLACE), ("cubic", 0))}
    assert names == {"radix": "none", "bradix": "none", "radix22": "l2",
                     "radix18": "folded", "histogram": "l2", "cubic": "affine"}


def test_lookup_refuses_a_route_of_its_own():
    """lookup_clamped takes the route top_route gives, no other."""
    (q, top_p, leaf_w, errors, n, kminf, s), _ = _case("histogram", "linear", "u64")
    ops = eval_kernel.top_operands("histogram", top_p, "cpu", 256, "linear")
    eval_kernel._check_top_operands("histogram", "linear", ops, 256)
    for route in (eval_kernel.IN_PLACE, eval_kernel.FOLDED):
        with pytest.raises(ValueError, match="route"):
            eval_kernel._check_top_operands("histogram", "linear", (*ops[:5], route), 256)


def test_folded_rows():
    """A folded hint table's rows (lookup_rows): row b is the lookup row
    of leaf clamp_int(table[b], B - 1), its row and error bit for bit."""
    (q, top_p, leaf_w, errors, n, kminf, s), _ = _case("radix18", "cubic", "narrow")
    B = leaf_w.shape[0]
    ops = eval_kernel.top_operands("radix18", top_p, "cpu", B, "cubic")
    rows = eval_kernel.lookup_rows(leaf_w, errors, ops, B)
    leaf = clamp_int(top_p["table"].long(), B - 1)
    assert rows.shape == (1 << 18, eval_kernel.lookup_width(4))
    assert torch.equal(rows.view(torch.int64), eval_kernel.lookup_table(
        leaf_w, errors).view(torch.int64)[leaf])
    assert torch.equal(rows[:, 4].view(torch.int64), errors[leaf])


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
