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
from rmi_tpu_torch.ops import cachefix_kernel, eval_kernel, probe_kernels
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
    if B > 7:
        w[3] *= -1.0                              # predicts below 0
        w[7] *= 4.0                               # and above n
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


# ---------------------------------------------------------------------------
# integer-output tops in the fused entry, and the hierarchical resolve: the
# inputs test_torch_int_lookup.py, test_torch_hier.py and the card tests share
# ---------------------------------------------------------------------------

# the integer tops the CPU tests build (radix26 and radix28, whose tables
# take 256 MB and 1 GB, run the table kind's code with other bits, and are
# built on the card only)
INT_TOPS = ("radix", "bradix", "radix8", "radix18", "radix22", "histogram")
KEY_SETS = ("u64", "u32", "f64", "single", "narrow")
U64_EDGES = [0, 1, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 2, 2 ** 64 - 1]


def int_keys(kind, seed, n=1 << 12):
    """(sorted keys, key type): u64 keys with the edges 0, 2^63 - 1, 2^63
    and 2^64 - 1 among runs of equal keys; u32 keys with runs; f64 keys
    from below 0 to past 2^64 (as_int clips them) with runs; one distinct
    u64 key n times (a common prefix of 64 bits); u64 keys within 2^11 of
    each other (a prefix of 53 bits, past 64 with a table's bits)."""
    rng = np.random.default_rng(seed)
    if kind == "single":
        return np.full(n, 0x0123456789ABCDEF, dtype=np.uint64), KeyType.U64
    if kind == "narrow":
        return np.sort(rng.integers(0, 2 ** 11, n, dtype=np.uint64)
                       + np.uint64(0xFEDCBA9876543000)), KeyType.U64
    if kind == "u32":
        base = rng.integers(0, 2 ** 32, n // 4, dtype=np.uint64)
        keys = np.repeat(base, rng.integers(1, 8, base.size))[:n - 2]
        return np.sort(np.concatenate([keys, [0, 2 ** 32 - 1]])).astype(np.uint32), \
            KeyType.U32
    if kind == "f64":
        base = np.concatenate([rng.uniform(-1e3, 1e3, n // 16), rng.uniform(0, 2e19, n // 8),
                               [0.0, 2.0 ** 63, 2.0 ** 64, 3e19, 1e30]])
        keys = np.repeat(base, rng.integers(1, 6, base.size))
        return np.sort(keys[rng.permutation(keys.size)[:n]]), KeyType.F64
    base = np.concatenate([rng.integers(0, 2 ** 64 - 1, n // 4, dtype=np.uint64,
                                        endpoint=True),
                           np.array(U64_EDGES, dtype=np.uint64)])
    keys = np.repeat(base, rng.integers(1, 6, base.size))
    return np.sort(np.concatenate([keys[rng.permutation(keys.size)[:n - len(U64_EDGES)]],
                                   np.array(U64_EDGES, dtype=np.uint64)])), KeyType.U64


def int_queries(keys, key_type, m, seed):
    """[m] images: keys of the index, random values over and past its
    range, every image's extremes, the key below the first (below the
    first pivot), and for f64 keys -0.0, +-inf, NaN, negative values and
    values from 2^64."""
    rng = np.random.default_rng(seed)
    img = tkeys.to_image(keys).numpy()
    lo, hi = int(img[0]), int(img[-1])
    top = key_type.max_image if key_type is KeyType.U32 else IMAGE_MAX
    q = np.concatenate([img[rng.integers(0, img.size, m // 4)],
                        rng.integers(max(lo - (1 << 40), tkeys.IMAGE_MIN),
                                     min(hi + (1 << 40), top), m // 4, dtype=np.int64),
                        rng.integers(tkeys.IMAGE_MIN, top, m, dtype=np.int64,
                                     endpoint=True)])
    edges = [tkeys.IMAGE_MIN, top, lo, hi, max(lo - 1, tkeys.IMAGE_MIN), min(hi + 1, top)]
    if key_type is KeyType.F64:
        edges += tkeys.to_image(np.array([-0.0, 0.0, np.inf, -np.inf, np.nan, -1.5, 2.0 ** 64,
                                          2.0 ** 63, 1e300, 5e-324, 0.999])).tolist()
    q = np.concatenate([edges, q[rng.permutation(q.size)]])[:m]
    return torch.from_numpy(q.astype(np.int64))


def int_top_case(top, leaf, kind, m, seed, *, B=256, device="cpu", n=1 << 12):
    """A lookup's inputs under integer top ``top`` fitted as stage A fits
    it (on ``device``) over n keys of ``kind``: (queries, top params,
    leaf_w, leaf_errors, n, kminf, s) on the CPU, and the key type."""
    keys, key_type = int_keys(kind, seed, n)
    img = tkeys.to_image(keys).to(device)
    n = img.shape[0]
    top_in = two_layer.model_float_input(get_model(top), img, 0.0, 1.0, key_type)
    top_p, _, _ = two_layer._assign_body(top_in, two_layer.fixdups_i32(img),
                                         top_type=top, B=B)
    top_p = {k: v.cpu() for k, v in top_p.items()}
    kminf, s = two_layer.norm_constants(img.cpu(), key_type)
    rng = np.random.default_rng(seed + 1)
    leaf_w = leaf_table(get_model(leaf).leaf_kernel, B, n, seed + 2)
    errors = torch.from_numpy(rng.integers(0, 1000, B, dtype=np.int64))
    q = int_queries(keys, key_type, m, seed + 3)
    return (q, top_p, leaf_w, errors, n, kminf, s), key_type


def resolve_case(K, seed, *, n=(1 << 13) + 37, m=3000):
    """(keys, queries, guess, err) for the hierarchical resolve from level
    K: n keys (not a multiple of 64) in runs of equal keys, some across a
    row's edge (64 i - 3 .. 64 i + 3); queries among them, below the first
    and above the last; guesses within err of the lower bound, and moved
    past it so that guess - err < 0 and guess + err > n."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 2 ** 40, n, dtype=np.int64))
    for edge in range(64, n - 4, 64 * 7):
        keys[edge - 3:edge + 4] = keys[edge - 3]
    keys = np.sort(keys)
    q = np.concatenate([[keys[0] - 1, keys[-1] + 1, keys[0] - 1, keys[-1] + 1,
                         -(1 << 62), 1 << 62],
                        keys[rng.integers(0, n, m // 3)],
                        rng.integers(-5, 2 ** 40 + 5, m - m // 3 - 6)])
    lb = np.searchsorted(keys, q, side="left")
    reach = 64 ** K * 31 // 2 if K else 31     # within the level-K count's reach
    err = rng.integers(0, reach + 1, q.size)
    guess = np.clip(lb + rng.integers(-1, 2, q.size) * rng.integers(0, err + 1), 0, n)
    # below the first key and above the last: guess - err < 0, guess + err > n
    guess[:6] = [0, n, 0, n, 0, n]
    err[:6] = [n + 5, n + 5, 3, 3, 2 ** 40, 2 ** 40]
    t = [torch.from_numpy(a.astype(np.int64)) for a in (keys, q, guess, err)]
    return tuple(t)


# the hierarchical resolve's edges: (kind, K) of resolve_edge_case
RESOLVE_EDGES = ([(kind, K) for kind in ("edges", "broken", "extremes", "dups")
                  for K in range(4)]
                 + [("short", K) for K in range(3)] + [("deep", K) for K in range(4, 11)])


def _edge_keys(kind, K, rng):
    """Sorted int64 keys for resolve_edge_case: for "dups", runs of equal
    keys across a sector's edge (4 i - 2 .. 4 i + 1) and runs of 300
    across a row's edge, so that level 1 holds runs too; for "short",
    n = 8258, 66 and 130 (K = 0, 1, 2), levels whose last row holds
    fewer entries than a sector; for "deep", n < 128 (K = 4) or a few
    thousand keys, so that the levels above 1 hold one entry each."""
    if kind == "short":
        n = (64 * 64 * 2 + 66, 66, 130)[K]
    elif kind == "deep":
        n = 100 if K == 4 else 1000 + 37 * K
    else:
        n = 64 ** min(K, 2) * 150 + 37
    keys = np.sort(rng.integers(0, 2 ** 40, n, dtype=np.int64))
    if kind == "dups":
        for i in range(4, n - 4, 4 * 5):
            keys[i - 2:i + 2] = keys[i - 2]
        for i in range(64 * 3, n - 300, 64 * 41):
            keys[i - 150:i + 150] = keys[i - 150]
        keys = np.sort(keys)
    return keys


def resolve_edge_case(kind, K, seed):
    """(keys, queries, guess, err) for the hierarchical resolve from level
    K at its edges (RESOLVE_EDGES):
      edges     queries at, just below and just above the entries that
                open, close and follow each window of every level, with
                guesses that hold the bound and guesses far enough off
                that each level's count lands on its window's edges;
      broken    guesses off the lower bound by err + 1 and by whole rows
                of level K and of level 0, either way;
      extremes  queries below the first key and above the last, and the
                int64 extremes, with every kind of guess;
      dups      duplicate runs across sectors' and rows' edges;
      short     levels whose last row is shorter than a sector;
      deep      K = 4..10 over few keys (n < 128 for K = 4).
    Guesses lie in [0, n], as lookup's do; errors are >= 0."""
    rng = np.random.default_rng(seed)
    keys = _edge_keys(kind, K, rng)
    n = keys.size
    levels = [keys[::64 ** k] for k in range(K + 1)]
    if kind in ("edges", "dups", "short"):
        qs = []
        for lv in levels:
            rows = np.unique(np.concatenate([np.arange(min(lv.size, 64 * 6)),
                                             lv.size - 1 - np.arange(min(lv.size, 200)),
                                             rng.integers(0, lv.size, 200)]))
            at = np.unique(np.clip(np.concatenate(
                [(rows // 64) * 64 + d for d in (-1, 0, 1, 3, 4, 63, 64, 65, 127, 128)]),
                0, lv.size - 1))
            qs += [lv[at] - 1, lv[at], lv[at] + 1]
        q = np.concatenate(qs)
    else:
        q = np.concatenate([keys[rng.integers(0, n, 400)],
                            rng.integers(-5, 2 ** 40 + 5, 400)])
    q = np.concatenate([q, [keys[0] - 1, keys[-1] + 1, keys[0], keys[-1],
                            -(1 << 63), (1 << 63) - 1, 0]])
    lb = np.searchsorted(keys, q, side="left")
    sK = 64 ** K
    reach = min(sK * 31 // 2, 1 << 62) if K else 31   # within the level-K count's reach
    m = q.size
    err = rng.integers(0, reach + 1, m)
    if kind == "broken":
        off = rng.choice([-1, 1], m) * (err + rng.choice([1, 64 * sK, 128 * sK, 64, 128], m))
    elif kind == "extremes" or kind == "deep":
        err = rng.choice([0, 1, reach, n + 5, 1 << 40, 1 << 62], m)
        off = rng.integers(-n - 3, n + 4, m)
    else:      # within err, or whole rows of level K (and beyond) either way
        off = np.where(rng.random(m) < 0.5, rng.integers(-1, 2, m) * err,
                       rng.choice([-1, 1], m) * rng.choice([64 * sK, 128 * sK, 4096 * sK], m))
    guess = np.clip(lb + off, 0, n)
    t = [torch.from_numpy(a.astype(np.int64)) for a in (keys, q, guess, err)]
    return tuple(t)


def level_counts(levels, q, guess, err, *, K: int, n: int):
    """Per level k = K..0 (numpy), the counts c of resolve_plain's windows
    and their widths w: (c, w) arrays of each level, in that order."""
    q, guess, err = (np.asarray(a) for a in (q, guess, err))
    sK = 64 ** K
    LB = (np.clip(guess - err, 0, n) + sK - 1) // sK
    out = []
    for k in range(K, -1, -1):
        lv = np.asarray(levels[k])
        if k < K:
            LB = np.maximum(lb * 64 - 63, 0)
        nrows = max(1, -(-lv.size // 64))
        start = np.clip(LB >> 6, 0, nrows - 1) * 64
        w = np.minimum(lv.size - start, 128)
        c = np.minimum(np.searchsorted(lv, q, side="left"), start + w) - start
        c = np.maximum(c, 0)
        out.append((c, w))
        lb = np.minimum(start + c, lv.size)
    return out


# the cachefix serving path's edges: kinds of cachefix_edge_case and
# bounded_edge_case (ops/cachefix_kernel.py, csrc/cachefix.cu)
CACHEFIX_EDGES = ("err0", "clamped", "past_end", "equal_knots", "near_line", "one", "wide")
BOUNDED_EDGES = ("err0", "clamped", "past_end", "dups", "one", "exact_trips", "short_trips",
                 "n_below_keys")


def _windows(rng, lb, n, m, err_max):
    """Guesses within err of each lower bound lb, and moved past it by
    err + 1 on a few, in [0, n]; errors in [0, err_max]."""
    err = rng.integers(0, err_max + 1, m)
    off = rng.integers(-1, 2, m) * rng.integers(0, err + 1)
    off[::7] = rng.choice([-1, 1], off[::7].size) * (err[::7] + 1)
    return np.clip(lb + off, 0, n), err


def cachefix_edge_case(kind, seed=0):
    """(knots, vals, queries as u64; start, err as int64; line) for
    cachefix_interp at its edges (CACHEFIX_EDGES):
      err0         err 0, the start on the knot's lower bound or one off;
      clamped      windows past both ends: start - err < 0 and start +
                   err + 1 > the knot count;
      past_end     queries above the last knot, windows that reach it;
      equal_knots  runs of equal knot keys (k2 - k1 = 0, clamped to 1);
      near_line    lerps on and within an ulp of cache-line boundaries;
      one          a single knot (the pair is knot 0 twice);
      wide         knots over the whole u64 range, the extremes queried.
    The start is a position among the knots, as the RMI over them answers."""
    rng = np.random.default_rng(seed)
    line = 8
    count = {"one": 1, "near_line": 2}.get(kind, 300)
    if kind == "wide":
        knots = np.unique(rng.integers(0, 2 ** 64 - 1, count, dtype=np.uint64))
        knots[0], knots[-1] = 0, 2 ** 64 - 1
    elif kind == "near_line":
        knots = np.asarray([1 << 20, (1 << 20) + 3 * (1 << 40)], np.uint64)
    else:
        knots = np.sort(rng.integers(1, 2 ** 40, count, dtype=np.uint64))
        if kind == "equal_knots":
            knots[10:40] = knots[10]
            knots[-5:] = knots[-5]
        knots = np.sort(knots)
    vals = np.cumsum(rng.integers(0, 50, knots.size)).astype(np.uint64)
    if kind == "near_line":
        vals = np.asarray([0, 3 * line * 1000], np.uint64)
        # t = j / 3000 lands v on a line boundary where j is a multiple of 3
        j = np.arange(0, 3001, dtype=np.uint64)
        q = np.concatenate([knots[0] + j * (1 << 30) + d for d in (0, 1)]
                           + [knots[0] + j * (1 << 30) - np.uint64(1)])
    else:
        q = np.concatenate([knots, knots - np.uint64(1), knots + np.uint64(1),
                            rng.integers(int(knots[0]), int(knots[-1]), 600, dtype=np.uint64,
                                         endpoint=True),
                            np.asarray([0, 1, 2 ** 64 - 1, 2 ** 64 - 2], np.uint64)])
    if kind == "past_end":
        q = np.concatenate([q, knots[-1] + np.arange(1, 200, dtype=np.uint64)])
    n = knots.size
    lb = np.searchsorted(knots, q, side="left")
    m = q.size
    if kind == "err0":
        start, err = np.clip(lb + rng.integers(-1, 2, m), 0, n), np.zeros(m, np.int64)
    elif kind == "clamped":
        start = rng.choice([0, 1, n - 1, n], m)
        err = rng.choice([2, n // 2, n + 3, 2 * n], m)
    else:
        start, err = _windows(rng, lb, n, m, 5 if n > 1 else 1)
    return knots, vals, q, start.astype(np.int64), err.astype(np.int64), line


def bounded_edge_case(kind, seed=0):
    """(keys, queries as u64; guess, err as int64; n, iters) for the
    bounded lower bound at its edges (BOUNDED_EDGES):
      err0          err 0;
      clamped       windows past both ends of [0, n];
      past_end      queries above the last key;
      dups          runs of equal keys, queried at and around them;
      one           n = 1;
      exact_trips   iters = ceil(log2(2 max_err + 2)), just covering the
                    widest window;
      short_trips   fewer trips than the widest window needs (an answer
                    inside the window, not the lower bound);
      n_below_keys  n below the keys' count, guesses up to n."""
    rng = np.random.default_rng(seed)
    size = 1 if kind == "one" else 5000
    keys = np.sort(rng.integers(1, 2 ** 40, size, dtype=np.uint64))
    if kind == "dups":
        for i in range(0, size - 300, 457):
            keys[i:i + rng.integers(2, 300)] = keys[i]
        keys = np.sort(keys)
    n = size - 123 if kind == "n_below_keys" else size
    q = np.concatenate([keys, keys - np.uint64(1), keys + np.uint64(1),
                        rng.integers(0, 2 ** 40, 2000, dtype=np.uint64),
                        np.asarray([0, 2 ** 64 - 1], np.uint64)])
    if kind == "past_end":
        q = np.concatenate([q, keys[-1] + np.arange(1, 300, dtype=np.uint64)])
    lb = np.minimum(np.searchsorted(keys, q, side="left"), n)
    m = q.size
    if kind == "err0":
        guess, err = np.clip(lb + rng.integers(-1, 2, m), 0, n), np.zeros(m, np.int64)
    elif kind == "clamped":
        guess = rng.choice([0, 1, n - 1, n], m)
        err = rng.choice([3, n // 2, n + 3, 2 * n], m)
    else:
        guess, err = _windows(rng, lb, n, m, 1 if n == 1 else 700)
    max_err = int(err.max())
    iters = max(1, int(np.ceil(np.log2(2 * max_err + 2))))
    if kind == "short_trips":
        iters = max(1, iters - 4)
    elif kind != "exact_trips":
        iters += 1                    # rmi_tpu's count: lookup.err_iters
    return keys, q, guess.astype(np.int64), err.astype(np.int64), n, iters


# windows of 2^16 keys and their edges, where the kernels' interpolated
# sector reads and the knots' sample (cachefix_kernel.KNOT_STRIDE) act: kinds
# of wide_window_case
WIDE_WINDOWS = ("uniform", "clustered", "dups", "u32", "narrow", "inverted", "n_below")


def wide_window_case(kind, seed=0, n=1 << 18, err_max=1 << 15):
    """(keys, queries as u64; guess, err as int64; n, iters) with windows
    of up to 2 err_max + 1 keys over n keys (WIDE_WINDOWS):
      uniform    keys uniform over [1, 2^62);
      clustered  osm-like cell ids: tight clusters far apart;
      dups       runs of 2-300 equal keys, which straddle sectors and the
                 knots' sample brackets;
      u32        keys below 2^32, whose images lie near -2^63;
      narrow     windows of 1-3 keys, narrower than a sector;
      inverted   some errors below 0 (a window whose end lies before its
                 start answers its start);
      n_below    n = the keys' count - 1000, guesses up to n.
    Guesses lie within err of each query's lower bound, and err + 1 off it
    on a seventh of them (a window that misses); iters covers every window
    (rmi_tpu's count, lookup.err_iters).  As knots (cachefix_interp) the
    keys are sorted knot images, start and err the RMI's window."""
    rng = np.random.default_rng(seed)
    if kind == "clustered":
        centers = np.sort(rng.uniform(0, 2 ** 62, n // 4096))
        keys = np.sort((centers[rng.integers(0, centers.size, n)]
                        + rng.exponential(2 ** 34, n)).astype(np.uint64))
    elif kind == "u32":
        keys = np.sort(rng.integers(0, 2 ** 32, n, dtype=np.uint64))
    else:
        keys = np.sort(rng.integers(1, 2 ** 62, n, dtype=np.uint64))
    if kind == "dups":
        for i in range(0, n - 300, 1009):
            keys[i:i + rng.integers(2, 300)] = keys[i]
        keys = np.sort(keys)
    count = n - 1000 if kind == "n_below" else n
    q = np.concatenate([keys[rng.integers(0, n, 3000)],
                        keys[rng.integers(0, n, 3000)] + np.uint64(1),
                        rng.integers(int(keys[0]), int(keys[-1]), 6000, dtype=np.uint64),
                        np.asarray([0, 2 ** 64 - 1, keys[0], keys[-1]], np.uint64)])
    lb = np.minimum(np.searchsorted(keys, q, side="left"), count)
    guess, err = _windows(rng, lb, count, q.size, 1 if kind == "narrow" else err_max)
    if kind == "inverted":
        err[::5] = -rng.integers(1, 4, err[::5].size)
    iters = max(1, int(np.ceil(np.log2(2 * max(int(err.max()), 0) + 2)))) + 1
    return keys, q, guess.astype(np.int64), err.astype(np.int64), count, iters


# the packed plan's search (csrc/packed.cu) at its edges: kinds of
# packed_edge_case, each served through a linear top at the B's of
# PACKED_EDGE_BS (2: packed_wide, F = 2, rows of ~108 samples; 4: packed,
# rows of ~96, both read by their chunks' last samples first; 64: packed,
# rows of 7-10 samples, odd counts padded; "ragged" packed at every B)
PACKED_EDGES = ("u32", "f64", "runs", "stripe_firsts", "jumps", "ragged", "outside")
PACKED_EDGE_BS = (2, 4, 64)


def packed_edge_case(kind, seed=0, n=(1 << 14) + 37):
    """(sorted keys, key type, [m] int64 query images) over n keys, n a
    multiple of neither 8 nor 64 (PACKED_EDGES):
      u32            books-like u32 keys, whose images lie near -2^63, with
                     runs; the u32 extremes among the queries;
      f64            f64 keys from -1e6 to 1e12 with runs, -0.0 and 0.0
                     among them; -0.0, 0.0, +-inf and NaN queries;
      runs           runs of 65-300 equal keys that cross stripes; queries
                     the runs' keys and one either side;
      stripe_firsts  queries equal to each stripe's first key, one either
                     side, and each stripe's last key;
      jumps          each stripe's keys bunched at its start, then one jump
                     of 2^40 at a random place inside it, so that the
                     interpolation between its ends misses both blocks;
      ragged         1005 keys: a last stripe of 45 keys, a last 8-key
                     group of 5; queries around the last keys;
      outside        queries far below the first key and above the last,
                     0 and 2^64 - 1 among them.
    Every kind adds keys of the index and uniform queries over its range."""
    rng = np.random.default_rng(seed)
    key_type = KeyType.U64
    if kind == "ragged":
        n = 1005
    gaps = np.round(rng.exponential(2.0 ** 30, n)) * (rng.random(n) > 0.05)
    keys = (np.cumsum(gaps) + 2 ** 50).astype(np.uint64)
    if kind == "u32":
        keys, key_type = (keys >> np.uint64(24)).astype(np.uint32), KeyType.U32
    elif kind == "f64":
        keys = np.sort(np.concatenate([rng.uniform(-1e6, 1e12, n - 40),
                                       np.repeat(rng.uniform(-1e6, 1e12, 4), 9), [-0.0, 0.0],
                                       [0.0, 0.0]]))
        key_type = KeyType.F64
    elif kind == "runs":
        at = 0
        while at < n - 300:
            length = int(rng.integers(65, 301))
            keys[at:at + length] = keys[at]
            at += length + int(rng.integers(0, 200))
        keys = np.sort(keys)
    elif kind == "jumps":
        stripe = np.arange(n) // 64
        jump = rng.integers(1, 64, stripe[-1] + 1)
        keys = (stripe.astype(np.uint64) * np.uint64(2 ** 42) + np.uint64(2 ** 50)
                + np.arange(n, dtype=np.uint64) % np.uint64(64) * np.uint64(1000)
                + np.where(np.arange(n) % 64 >= jump[stripe], np.uint64(2 ** 40), np.uint64(0)))
    img = tkeys.to_image(keys).numpy()
    lo, hi = int(img[0]), int(img[-1])
    top = key_type.max_image if key_type is KeyType.U32 else IMAGE_MAX
    parts = [img[rng.integers(0, n, 2000)], rng.integers(lo, hi, 4000, dtype=np.int64,
                                                         endpoint=True)]
    if kind == "u32":
        parts.append(tkeys.to_image(np.array([0, 2 ** 32 - 1], np.uint32)).numpy())
    elif kind == "f64":
        parts.append(tkeys.to_image(np.array([-0.0, 0.0, np.inf, -np.inf, np.nan,
                                              -1e7, 2e12])).numpy())
    elif kind == "runs":
        runs = img[np.flatnonzero(img[1:] == img[:-1])]
        parts += [runs, runs - 1, runs + 1]
    elif kind == "stripe_firsts":
        first = img[::64]
        parts += [first, first - 1, first + 1, img[63::64]]
    elif kind == "ragged":
        parts += [img[-70:], img[-70:] + 1, img[-70:] - 1, [hi + 1, top]]
    elif kind == "outside":
        parts += [rng.integers(tkeys.IMAGE_MIN, lo, 500, dtype=np.int64),
                  rng.integers(hi, top, 500, dtype=np.int64, endpoint=True),
                  [tkeys.IMAGE_MIN, top, lo - 1, hi + 1]]
    q = np.concatenate([np.asarray(x, np.int64) for x in parts])
    return keys, key_type, torch.from_numpy(q[rng.permutation(q.size)])


def test_cachefix_wrappers_refuse_bad_inputs():
    """Wrong dtype, shape or device, or an n beyond the keys: ValueError,
    on the CPU as on the card."""
    keys, q, start, err = (torch.arange(10, dtype=torch.int64) for _ in range(4))
    with pytest.raises(ValueError):
        cachefix_kernel.bounded_lower_bound(keys, q.int(), start, err, 10, 5)
    with pytest.raises(ValueError):
        cachefix_kernel.bounded_lower_bound(keys, q, start[:5], err, 10, 5)
    with pytest.raises(ValueError):
        cachefix_kernel.bounded_lower_bound(keys, q, start, err, 11, 5)
    with pytest.raises(ValueError):
        cachefix_kernel.bounded_lower_bound(keys, q.to("meta"), start, err, 10, 5)
    with pytest.raises(ValueError):
        cachefix_kernel.cachefix_interp(keys, keys[:9], q, start, err, 8, 100)
    with pytest.raises(ValueError):
        cachefix_kernel.cachefix_interp(keys, keys.double(), q, start, err, 8, 100)
    with pytest.raises(ValueError):
        cachefix_kernel.cachefix_interp(keys, keys, q, start, err, 0, 100)
