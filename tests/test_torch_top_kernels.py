"""Stage A of the build (ops/top_kernel.py) against rmi_tpu, on the CPU.

The plain versions of the three kernels of csrc/top.cu, and the port's
stage A whole, over keys made from a seed with numpy (u64, u32 and f64,
with runs of equal keys; f64 keys with -0.0, +-inf and NaN), at n <= 2^16:

  (a) the normalized keys (models.base.normalize, key_normalize's plain
      version) bit-equal to rmi_tpu's (as_float(keys) - kminf) * s
      (rmi_tpu/train/two_layer.py:186-188): where the port's image
      makes -0.0 a +0.0 and every NaN one NaN (keys.f64_image), the value
      compares as a value, a NaN as a NaN;
  (b) the cubic top's two L1 sums (top_l1_cubic_plain) bit-equal to
      rmi_tpu's _abs_err_sum over _top_spans(n) under jit
      (rmi_tpu/models/cubic.py:298, :331), for both candidates, with and
      without the targets' scaling;
  (c) the leaf assignment (top_assign_plain) bit-equal to rmi_tpu's
      predict_top_assignment under jit (rmi_tpu/train/two_layer.py:69),
      the JAX top's parameters carried across, for every affine top and
      every integer top at B in {1, 16, 4096}, and for tops whose
      predictions go below 0, above B and to NaN;
  (d) stage A whole (FixDups, the top's parameters, the leaf ids)
      bit-equal to rmi_tpu's jitted _assign_body for cubic, linear,
      normal and radix18 tops on each key type; but for the linear and
      normal tops' rows, which are bit-equal to rmi_tpu's fit_top jitted
      on the same stage inputs and lie within STAGE_ULPS ulps of the row's
      largest entry of the rows of its fused stage A, whose whole-array
      sums XLA fuses with the normalization and adds in another order on
      u64 and u32 keys (the port's fits of these tops are not this
      module's; tools/compare_torch_top_rows.py prints both rows and their
      distance, for this checkout or another's port);
  (e) the wrappers run their plain versions on CPU tensors and refuse
      inputs of the wrong type or shape.

The kernels themselves run on the card (tests/test_torch_cuda_kernels.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmi_tpu import keys as jkeys
from rmi_tpu.models import get_model as j_get_model
from rmi_tpu.models.cubic import _abs_err_sum, _top_spans, cubic_predict as j_cubic_predict
from rmi_tpu.models.linear import _linear_predict as j_linear_predict
from rmi_tpu.train import two_layer as j_two_layer

from rmi_tpu_torch import keys as tkeys
from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.models import clamp_int, get_model
from rmi_tpu_torch.models.base import REGISTRY, normalize
from rmi_tpu_torch.ops import eval_kernel, top_kernel
from rmi_tpu_torch.train import api, two_layer

N = 20011                  # not a multiple of XLA's windows of 32
AFFINE_TOPS = sorted(name for name, m in REGISTRY.items() if not m.output_int)
INT_TOPS = ("radix", "bradix", "radix8", "radix18", "radix22", "histogram")
ASSIGN_BS = (1, 16, 4096)
FIT_B = 4096               # the B the carried tops are fitted at
J_KEY_TYPES = {KeyType.U64: jkeys.KeyType.U64, KeyType.U32: jkeys.KeyType.U32,
               KeyType.F64: jkeys.KeyType.F64}


@functools.lru_cache(maxsize=None)
def _keys(kind):
    """(sorted numpy keys, key type): books-like u64 keys with runs of
    equal keys, u32 keys with runs, f64 keys across 0 with runs and both
    zeros."""
    rng = np.random.default_rng(22)
    keys, key_type = _draw(kind, rng)
    assert keys.size == N
    return keys, key_type


def _draw(kind, rng):
    if kind == "u32":
        base = rng.integers(0, 2 ** 32, N // 2, dtype=np.uint64)
        keys = np.repeat(base, rng.integers(1, 6, base.size))[:N]
        return np.sort(keys).astype(np.uint32), KeyType.U32
    if kind == "f64":
        base = np.concatenate([[0.0, -0.0, 0.0, -0.0], rng.normal(0.0, 1e6, N // 2)])
        keys = np.repeat(base, rng.integers(1, 6, base.size))[:N]
        return np.sort(keys), KeyType.F64
    c = np.cumsum(rng.exponential(size=N // 2))
    base = (c * (2.0 ** 60 / c[-1])).astype(np.uint64)
    return np.sort(np.repeat(base, rng.integers(1, 6, base.size))[:N]), KeyType.U64


def _same_bits(got: torch.Tensor, want) -> None:
    """f64 values equal bit for bit, NaN as NaN."""
    got, want = got.numpy(), np.asarray(want)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int64), want[~nan].view(np.int64))


# (a) the normalized keys --------------------------------------------------

SPECIALS = np.array([-0.0, 0.0, np.inf, -np.inf, np.nan, 5e-324, -1.5, 1e300])


@pytest.mark.parametrize("kind", ["u64", "u32", "f64", "f64_specials"])
def test_normalize_is_rmi_tpus(kind):
    keys, key_type = _keys(kind.split("_")[0])
    kminf, s = two_layer.norm_constants(tkeys.to_image(keys), key_type)
    if kind == "f64_specials":        # unsorted: normalize is elementwise
        keys = np.concatenate([keys, SPECIALS])
    img = tkeys.to_image(keys)
    want = jax.jit(lambda k, o, sc: (jkeys.as_float(k) - o) * sc)(
        jnp.asarray(keys), jnp.float64(kminf), jnp.float64(s))
    got = normalize(img, kminf, s, key_type)
    _same_bits(got, want)
    assert torch.equal(top_kernel.key_normalize(img, kminf, s, key_type).view(torch.int64),
                       got.view(torch.int64))


# (b) the cubic top's L1 sums ----------------------------------------------

@functools.lru_cache(maxsize=None)
def _j_top_sums(n):
    spans = _top_spans(n)
    return jax.jit(lambda cw, lw, x, y: (
        _abs_err_sum({"w": cw}, j_cubic_predict, x, y, spans),
        _abs_err_sum({"w": lw}, j_linear_predict, x, y, spans)))


def _l1_case(kind, B, seed):
    """Normalized keys, FixDups, sf and candidate rows near the data."""
    keys, key_type = _keys(kind)
    img = tkeys.to_image(keys)
    kminf, s = two_layer.norm_constants(img, key_type)
    x = normalize(img, kminf, s, key_type)
    yfix = two_layer.fixdups_i32(img)
    rng = np.random.default_rng(seed)
    sf = B / N
    cw = torch.from_numpy(np.array([[rng.normal(0, B / 10), rng.normal(0, B / 10),
                                     B * rng.uniform(0.5, 1.5), rng.normal(0, 3.0)]]))
    lw = torch.from_numpy(np.array([[rng.normal(0, 3.0), B * rng.uniform(0.5, 1.5)]]))
    return x, yfix, sf, cw, lw


@pytest.mark.parametrize("kind", ["u64", "u32", "f64"])
@pytest.mark.parametrize("B", [1000, N])        # scaled targets, and sf == 1
def test_top_l1_sums_are_rmi_tpus(kind, B):
    x, yfix, sf, cw, lw = _l1_case(kind, B, B)
    ys = top_kernel.scaled_targets(yfix, sf)
    assert top_kernel.scales(sf) == (B != N)
    want = _j_top_sums(N)(jnp.asarray(cw.numpy()), jnp.asarray(lw.numpy()),
                          jnp.asarray(x.numpy()), jnp.asarray(ys.numpy()))
    cand = torch.cat([cw[0], lw[0], torch.zeros(top_kernel.CAND - 6, dtype=torch.float64)])
    got = top_kernel.top_l1_cubic_plain(x, yfix, sf, cand)
    for g, w in zip(got[0], want):
        _same_bits(g.reshape(1), w)
    for g, w in zip(top_kernel.top_l1_cubic(x, yfix, sf, cand), got):
        assert torch.equal(g, w)


def test_scaled_targets_are_rmi_tpus():
    """trunc(y * sf) rounded twice, as rmi_tpu's _scale_targets under jit,
    and y itself where sf is within f64::EPSILON of 1."""
    y = torch.arange(0, 1 << 16, 3, dtype=torch.int32)
    for sf in (1000 / 65536, 3 / 7, 1.0, 1.0 + 2 ** -53, 65536 / 1000):
        want = jax.jit(lambda v: j_two_layer._scale_targets(v, sf))(
            jnp.asarray(y.numpy().astype(np.float64)))
        _same_bits(top_kernel.scaled_targets(y, sf), want)
        _same_bits(two_layer._scale(y.double(), sf), want)


# (c) the leaf assignment ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def _j_stage(top, kind, B):
    """rmi_tpu's jitted stage A on _keys(kind): (yfix, params, t)."""
    keys, key_type = _keys(kind)
    img = tkeys.to_image(keys)
    kminf, s = two_layer.norm_constants(img, key_type)
    yfix, params, t = j_two_layer._stage_assign(
        jnp.asarray(keys), jnp.float64(kminf), jnp.float64(s), top_type=top, B=B,
        key_type=J_KEY_TYPES[key_type])
    return (np.asarray(yfix), {k: np.asarray(v) for k, v in
                               j_two_layer._predict_params(params).items()}, np.asarray(t))


def _carried(top, params):
    """rmi_tpu's top parameters in the port's form (trained_from_numpy's)."""
    if get_model(top).output_int:
        return api._int_params_from_numpy(params, "cpu")
    return torch.from_numpy(params["w"].copy())


@functools.lru_cache(maxsize=None)
def _j_assign(top):
    mtop = j_get_model(top)
    return jax.jit(lambda p, k, xn, xr, bound: j_two_layer.predict_top_assignment(
        mtop, p, k, xn, xr, bound))


def _assign_inputs(top, kind):
    """(JAX keys, xn, xraw; the port's top input) of _keys(kind)."""
    keys, key_type = _keys(kind)
    img = tkeys.to_image(keys)
    kminf, s = two_layer.norm_constants(img, key_type)
    xraw = jkeys.as_float(jnp.asarray(keys))
    xn = (xraw - kminf) * s
    top_in = two_layer.model_float_input(get_model(top), img, kminf, s, key_type)
    return jnp.asarray(keys), xn, xraw, top_in


@pytest.mark.parametrize("B", ASSIGN_BS)
@pytest.mark.parametrize("top", AFFINE_TOPS + list(INT_TOPS))
def test_assignment_is_rmi_tpus(top, B):
    """The top fitted by rmi_tpu at FIT_B leaves, its ids at B."""
    _, params, _ = _j_stage(top, "u64", FIT_B)
    keys, xn, xraw, top_in = _assign_inputs(top, "u64")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want = np.asarray(_j_assign(top)(jp, keys, xn, xraw, jnp.int64(B - 1)))
    got = top_kernel.top_assign_plain(top, _carried(top, params), top_in, B)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and int(got.max()) <= B - 1
    assert torch.equal(top_kernel.top_assign(top, _carried(top, params), top_in, B), got)


# rows whose predictions on X_WILD go below 0, past B and to NaN
WILD_ROWS = [("linear", [-7.5, 3.0 * 4096]), ("linear", [1e300, 1e300]),
             ("linear", [np.nan, 1.0]), ("cubic", [-4096.0, 8192.0, 4096.0, -20.0]),
             ("loglinear", [-3.0, 12.0]), ("normal", [0.5, 0.0, 5000.0]),
             ("normal", [0.5, 0.1, -5000.0]), ("normal", [0.0, np.nan, -np.inf])]
X_WILD = np.concatenate([np.linspace(-0.5, 1.5, 997), SPECIALS, [0.5, 1.0, 4096.0]])


@pytest.mark.parametrize("B", ASSIGN_BS)
@pytest.mark.parametrize("i", range(len(WILD_ROWS)))
def test_assignment_clamps_as_rmi_tpus(i, B):
    top, row = WILD_ROWS[i]
    w = np.array([row], dtype=np.float64)
    x = jnp.asarray(X_WILD)
    want = np.asarray(_j_assign(top)({"w": jnp.asarray(w)}, x, x, x, jnp.int64(B - 1)))
    got = top_kernel.top_assign_plain(top, torch.from_numpy(w), torch.from_numpy(X_WILD), B)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() <= B - 1


# (d) stage A whole ---------------------------------------------------------

# rmi_tpu's fused stage A against its fit_top alone, linear and normal tops
STAGE_ULPS = 4


@pytest.mark.parametrize("kind", ["u64", "u32", "f64"])
@pytest.mark.parametrize("top", ["cubic", "linear", "normal", "radix18"])
def test_stage_a_is_rmi_tpus(top, kind):
    B = 1000
    jy, params, jt = _j_stage(top, kind, B)
    keys, key_type = _keys(kind)
    img = tkeys.to_image(keys)
    kminf, s = two_layer.norm_constants(img, key_type)
    top_in = two_layer.model_float_input(get_model(top), img, kminf, s, key_type)
    yfix = two_layer.fixdups_i32(img)
    top_w, t, _ = two_layer._assign_body(top_in, yfix, top_type=top, B=B, keys=img,
                                         key_type=key_type)
    np.testing.assert_array_equal(yfix.numpy(), jy)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), jt)
    want = _carried(top, params)
    if isinstance(want, dict):
        assert set(top_w) == set(want)
        for k in want:
            assert torch.equal(top_w[k], want[k]), k
    elif top in ("linear", "normal"):
        sf = B / N
        ys = top_kernel.scaled_targets(yfix, sf)
        ep = np.trunc(np.arange(N, dtype=np.float64) * sf)
        alone = jax.jit(lambda a, b, c: j_get_model(top).fit_top(keys_f=a, ys_f=b, ep_ys_f=c,
                                                                 n=N))(
            *map(jnp.asarray, (top_in.numpy(), ys.numpy(), ep)))
        _same_bits(top_w, np.asarray(alone))
        w = want.numpy()
        # ulps of the row's largest entry: the intercept is a difference of
        # terms that size (mean_y - beta mean_x)
        assert (np.abs(top_w.numpy() - w) <= STAGE_ULPS * np.spacing(np.abs(w).max())).all()
    else:
        _same_bits(top_w, want.numpy())


# (e) the wrappers on the CPU -----------------------------------------------

def test_wrappers_refuse_bad_inputs():
    x = torch.linspace(0, 1, 64, dtype=torch.float64)
    y = torch.arange(64, dtype=torch.int32)
    lw = torch.zeros(1, 2, dtype=torch.float64)
    cand = torch.zeros(top_kernel.CAND, dtype=torch.float64)
    with pytest.raises(ValueError):
        top_kernel.key_normalize(x, 0.0, 1.0)                 # not images
    with pytest.raises(ValueError):
        top_kernel.top_l1_cubic(x, y.long(), 1.0, cand)       # yfix not int32
    with pytest.raises(ValueError):
        top_kernel.top_l1_cubic(x, y, 1.0, cand[:12])         # not a candidates buffer
    with pytest.raises(ValueError):
        top_kernel.top_l1_cubic(x[:0], y[:0], 1.0, cand)      # no keys
    with pytest.raises(ValueError):
        top_kernel.top_assign("linear", lw, x.float(), 16)    # not f64
    with pytest.raises(ValueError):
        top_kernel.top_assign("radix", {"w_int": torch.zeros(2, dtype=torch.int64)}, x, 16)
    with pytest.raises(ValueError):
        top_kernel.top_assign("linear", lw, x, 0)             # no leaf


# 16- and 32-bit narrowed tables (a histogram takes no more leaves than keys)
@pytest.mark.parametrize("B", (16, 4096, 1 << 17))
@pytest.mark.parametrize("top", INT_TOPS)
def test_int_top_operands_give_the_fitted_ids(top, B):
    """An integer top's operands as rmi_top_assign takes them, lookup's
    (eval_kernel.top_operands): the packed parameters, a hint table
    narrowed to B whose every entry is clamp_int(fitted entry, B - 1), the
    clamp the kernel takes again, so the ids are the fitted table's; the
    pivots as fitted; empty where the kind reads none."""
    keys, _ = _keys("u64")
    if top == "histogram" and B > keys.shape[0]:
        B = keys.shape[0]
    img = tkeys.to_image(keys)
    yfix = two_layer.fixdups_i32(img)
    p, _, _ = two_layer._assign_body(img, yfix, top_type=top, B=B)
    _, top_int, table, pivots, top_len, _ = eval_kernel.top_operands(top, p, "cpu", B,
                                                                     "linear")
    assert top_int.shape == ({"bradix": (4,), "histogram": (0,)}.get(top, (2,)))
    if top.startswith("radix") and top != "radix":
        assert top_len == p["table"].shape[0] == 1 << int(top[5:])
        assert torch.equal(eval_kernel.unpack_table(table, B),
                           clamp_int(p["table"].long(), B - 1))
    elif top == "histogram":
        assert pivots is p["pivots"] and top_len == pivots.shape[0]
    else:
        assert table.numel() == pivots.numel() == top_len == 0
