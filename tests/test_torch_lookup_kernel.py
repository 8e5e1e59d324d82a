"""lookup in one pass: K4's fused entry (ops/eval_kernel.lookup_clamped,
csrc/eval.cu rmi_lookup_*) on the CPU, where the wrapper runs its plain
version, and what lets one kernel body serve every affine top.  No JAX:
test_torch_slice.py, test_torch_zoo.py and test_torch_cubic_leaves.py
hold lookup (now this route) to rmi_tpu's; test_torch_cuda_kernels.py
holds the kernels to the plain versions here, with the same inputs
(lookup_case).

Tolerances: none.  Predictions, leaf ids, guesses and errors are
bit-equal (NaN equal to NaN).
"""

import numpy as np
import pytest
import torch

from rmi_tpu_torch import keys as tkeys
from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.models import REGISTRY, get_model, predict_clamped
from rmi_tpu_torch.models.base import kernel_input
from rmi_tpu_torch.ops import eval_kernel, probe_kernels
from rmi_tpu_torch.train import two_layer

AFFINE_TOPS = sorted(name for name, m in REGISTRY.items() if m.input_domain == "affine")
LEAVES = eval_kernel.LEAF_KERNELS          # one leaf model per kernel
IMAGE_MAX = KeyType.U64.max_image


def _same(a, b):
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def _fitted_top(top, seed, B=1024, n=4096):
    """The top row ``top`` fits over books-like keys, as stage A fits it."""
    rng = np.random.default_rng(seed)
    keys = np.sort(np.cumsum(rng.exponential(1e9, n)).astype(np.uint64))
    img = tkeys.to_image(keys)
    kminf, s = two_layer.norm_constants(img)
    mtop = get_model(top)
    x = two_layer.model_float_input(mtop, img, kminf, s)
    ys = torch.trunc(two_layer.fixdups_i32(img).double() * (B / n))
    return mtop.fit_top(x, ys, 0.0, float(np.trunc((n - 1) * B / n)))


def top_rows(top, seed):
    """[1, ppm] top rows: a fitted one, random ones, and the degenerate
    rows a fit can give (a flat top; normal's stdev 0 and NaN)."""
    rng = np.random.default_rng(seed)
    ppm = get_model(top).ppm
    rows = [_fitted_top(top, seed)]
    for _ in range(3):
        rows.append(torch.from_numpy(rng.normal(0.0, 1.0, (1, ppm)) * [1e3, 1e3, 1e3, 1e3][:ppm]))
    if ppm == 3:                           # (mean, stdev, scale)
        rows += [torch.tensor([[0.5, 0.0, 1000.0]]),
                 torch.tensor([[0.0, float("nan"), float("-inf")]])]
    else:
        rows.append(torch.zeros(1, ppm, dtype=torch.float64))
    return [r.double() for r in rows]


def model_inputs(m, seed):
    """[m] f64 top inputs: normalized keys in and around [0, 1], and
    extremes (signed zeros, subnormals, huge values, infinities, NaN)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.25, 1.25, m)
    ext = [0.0, -0.0, 1.0, 5e-324, -5e-324, 1e-300, 1e300, -1e300, np.inf, -np.inf,
           np.nan, np.nextafter(1.0, 2.0), np.nextafter(0.0, -1.0), 0.5]
    x[:len(ext)] = ext
    return torch.from_numpy(x)


def leaf_table(leaf, B, n, seed):
    """[B, ppm] leaf rows of the sizes fits give over n keys, with rows
    that predict below 0 and above n, and (normal) the NaN rows of empty
    leaves and rows with stdev 0."""
    rng = np.random.default_rng(seed)
    ids = np.arange(B)
    if leaf == "cubic":
        w = np.stack([rng.normal(0.0, n / 10, B), rng.normal(0.0, n / 10, B),
                      rng.normal(n, n / 100, B), ids * (n / B) + rng.normal(0.0, 5.0, B)], 1)
    elif leaf == "normal":
        w = np.stack([(ids + 0.5) / B, rng.uniform(0.1, 2.0, B) / B,
                      (ids + 1.0) * (n / B)], 1)
        w[::17] = [0.0, np.nan, -np.inf]          # empty leaves keep the NaN row
        w[5::17, 1] = 0.0                         # one distinct key: stdev 0
    elif leaf == "loglinear":
        w = np.stack([np.log1p(ids * (n / B)), rng.normal(1.0, 0.5, B)], 1)
    else:
        w = np.stack([rng.normal(0.0, n / B, B), rng.normal(n, n / 100, B)], 1)
    w[3] *= -1.0                                  # predicts below 0
    w[7] *= 4.0                                   # and above n
    return torch.from_numpy(w)


def lookup_case(top, leaf, m, seed, *, B=512, n=1 << 20):
    """A lookup's inputs: (queries, top_w, leaf_w, leaf_errors, n, kminf,
    s).  The index spans keys [2^60, 2^61] (images), the queries every
    int64 image: below, inside and above it, and IMAGE_MIN, IMAGE_MAX."""
    rng = np.random.default_rng(seed)
    lo, hi = tkeys.IMAGE_MIN + (1 << 60), tkeys.IMAGE_MIN + (1 << 61)
    kminf, kmaxf = tkeys.as_float(torch.tensor([lo, hi])).tolist()
    s = 1.0 / (kmaxf - kminf)
    q = np.concatenate([rng.integers(lo - (1 << 58), hi + (1 << 58), m, dtype=np.int64),
                        rng.integers(tkeys.IMAGE_MIN, IMAGE_MAX, m, dtype=np.int64,
                                     endpoint=True)])
    q = q[rng.permutation(2 * m)[:m]]
    q[:min(m, 6)] = [tkeys.IMAGE_MIN, IMAGE_MAX, lo, hi, lo - 1, hi + 1][:min(m, 6)]
    top_w = top_rows(top, seed)[0]
    leaf_w = leaf_table(get_model(leaf).leaf_kernel, B, n, seed + 1)
    errors = torch.from_numpy(rng.integers(0, 1000, B, dtype=np.int64))
    return torch.from_numpy(q), top_w, leaf_w, errors, n, kminf, s


def lookup_by_steps(queries, top_w, leaf_w, leaf_errors, n, kminf, s, top, leaf):
    """lookup written out: as_float, the normalization, the top's
    prediction, its clamp to a leaf, the leaf's prediction on its kernel
    input, its clamp to n - 1, the leaf's error."""
    mtop, mleaf = get_model(top), get_model(leaf)
    f = tkeys.as_float(queries)
    x_top = f if mtop.input_domain == "raw" else (f - kminf) * s
    leaf_ids = predict_clamped(mtop.predict(top_w, None, x_top), leaf_w.shape[0] - 1)
    x_leaf = f if mleaf.input_domain == "raw" else (f - kminf) * s
    x_kernel = kernel_input(mleaf, x_leaf)
    pred = get_model(mleaf.leaf_kernel).predict(leaf_w, leaf_ids, x_kernel)
    return predict_clamped(pred, n - 1), leaf_errors[leaf_ids]


@pytest.mark.parametrize("top", AFFINE_TOPS)
def test_top_prediction_is_its_leaf_kernels(top):
    """mtop.predict on the top row equals the leaf kernel's predict with
    every element on row 0, bit for bit: rmi_lookup_* evaluates the top
    with the leaf kernel's rmi_leaf."""
    mtop = get_model(top)
    kernel = get_model(mtop.leaf_kernel)
    x = model_inputs(1 << 16, 3)
    zeros = torch.zeros(x.shape[0], dtype=torch.int64)
    for w in top_rows(top, 4):
        got = mtop.predict(w, None, x)
        want = kernel.predict(w, zeros, x)
        assert _same(got, want), (top, w)
        assert torch.equal(predict_clamped(got, 1023), predict_clamped(want, 1023))


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("top", AFFINE_TOPS)
def test_lookup_plain_is_lookup_by_steps(top, leaf):
    case = lookup_case(top, leaf, 1 << 14, 5)
    guess, err = eval_kernel.lookup_clamped_plain(*case, top_type=top, leaf_type=leaf)
    want_g, want_e = lookup_by_steps(*case, top, leaf)
    assert guess.dtype == err.dtype == torch.int64
    assert torch.equal(guess, want_g) and torch.equal(err, want_e)
    # some of the top's predictions fall outside [0, B - 1] before their clamp
    q, top_w, leaf_w, *_ = case
    _, _, _, _, n, kminf, s = case
    raw = get_model(top).predict(top_w, None, (tkeys.as_float(q) - kminf) * s)
    assert bool((raw < 0).any() or (raw > leaf_w.shape[0] - 1).any() or raw.isnan().any())
    assert 0 <= int(guess.min()) and int(guess.max()) <= n - 1
    # on the CPU the wrapper is its plain version
    g2, e2 = eval_kernel.lookup_clamped(*case, top_type=top, leaf_type=leaf)
    assert torch.equal(g2, guess) and torch.equal(e2, err)


@pytest.mark.parametrize("spec", ["cubic,lognormal", "lognormal,linear",
                                  "lognormal,lognormal"])
def test_lognormal_keeps_the_two_step_route(spec):
    top, leaf = spec.split(",")
    assert not eval_kernel.fused_lookup(top, leaf)
    case = lookup_case(top, leaf, 4096, 6)
    guess, err = eval_kernel.lookup_clamped(*case, top_type=top, leaf_type=leaf)
    want_g, want_e = lookup_by_steps(*case, top, leaf)
    assert torch.equal(guess, want_g) and torch.equal(err, want_e)


@pytest.mark.parametrize("leaf", LEAVES)
def test_lookup_table_holds_rows_and_errors_bit_for_bit(leaf):
    """Row j of lookup_table: leaf_w[j], the bits of leaf_errors[j], zeros,
    whole 32-byte sectors wide (one, two for cubic leaves); NaN rows and
    the largest errors cross unchanged."""
    _, _, leaf_w, errors, *_ = lookup_case("linear", leaf, 8, 9)
    errors[0], errors[1] = (1 << 63) - 1, -1
    table = eval_kernel.lookup_table(leaf_w, errors)
    ppm = leaf_w.shape[1]
    assert table.dtype == torch.float64 and table.shape == (leaf_w.shape[0],
                                                           eval_kernel.lookup_width(ppm))
    assert table.shape[1] * 8 == (64 if ppm == 4 else 32)
    bits = table.view(torch.int64)
    assert torch.equal(bits[:, :ppm], leaf_w.view(torch.int64))
    assert torch.equal(bits[:, ppm], errors)
    assert not bits[:, ppm + 1:].any()


def test_fused_route_covers_every_affine_pair():
    assert all(eval_kernel.fused_lookup(t, l) for t in AFFINE_TOPS for l in AFFINE_TOPS)


def test_kernel_key_conversion_is_normalize():
    """csrc/eval.cu's normalized(): u = image ^ 2^63, (hi * 2^32 + lo -
    offset) * scale in IEEE f64, here in numpy, equals
    two_layer.normalize on every image class."""
    q, *_, kminf, s = lookup_case("linear", "linear", 1 << 16, 7)
    u = q.numpy().view(np.uint64) ^ np.uint64(1 << 63)
    f = (u >> np.uint64(32)).astype(np.float64) * 4294967296.0 + \
        (u & np.uint64(0xFFFFFFFF)).astype(np.float64)
    want = two_layer.normalize(q, kminf, s).numpy()
    np.testing.assert_array_equal((f - kminf) * s, want)
    np.testing.assert_array_equal(f, u.astype(np.float64))   # the exact u64 cast


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_outputs_share_the_inputs_phase(dtype):
    """The kernels read and write in 16-byte pairs from the first 16-byte
    boundary: an output made by _empty_in_phase has its pairs where its
    input has them, whether the input starts on a boundary or 8 bytes
    after one."""
    base = torch.zeros(64, dtype=torch.int64)
    for like in (base, base[1:], base[2:], base[3:]):
        out = eval_kernel._empty_in_phase(37, dtype, like)
        head = eval_kernel._head(like)
        assert out.shape == (37,) and out.dtype == dtype and out.is_contiguous()
        assert (like.data_ptr() + 8 * head) % 16 == 0
        assert (out.data_ptr() + out.element_size() * head) % (2 * out.element_size()) == 0


def test_row_copy_beyond_one_block():
    """E above the ~57K rows one block's shared memory held before it
    spread over the card: its plain version at nq = 70000, repeated
    indices and all."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(4096, 128)).astype(np.float32)
    idx = rng.integers(0, 4096, 70_000, dtype=np.int32)
    got = probe_kernels.row_copy(torch.from_numpy(idx), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), x[idx])
