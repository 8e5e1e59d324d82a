"""The port's data-parallel build, sharded serving and process set-up
(rmi_tpu_torch/parallel/{dp_trainer,serve,multihost}.py) against
rmi_tpu's, on the CPU.

One world of four gloo ranks on the CPU (``multihost.run_ranks``, its
rendezvous a file under the test's temporary directory, so xdist workers
share no port) runs every case once per module and sends each rank's
results back; the tests compare them with rmi_tpu's
``dp_train_two_layer`` on a four-device sub-mesh of conftest's eight
virtual devices (the same shard count), on the same keys made with
numpy from a seed.  JAX is imported inside the tests that compare, never
at the top: the ranks import this module and load torch and
rmi_tpu_torch alone.

- The primitives (global_range_sum, global_value_at,
  global_searchsorted, dist_fixdups, dist_run_bounds) against rmi_tpu's
  under its shard_map: integers bit-equal, f64 range sums within
  RANGE_SUM_RTOL (the ranks' partials added in another order).
- test_parallel.py's dp cases (the five configurations on uniform and
  duplicate-heavy keys, n in {37, 1001, 4093, 4099}, the masked tops, the
  u64-max tail, the ten-row zoo), each rank's outputs bit-equal to the
  others': leaf errors within 1 on at most max(1, B / 20) leaves, leaf
  rows within rtol 1e-6, atol 1e-8 and avg_log2 within 1e-6 relative
  (plus what the leaves whose errors differ explain: rmi_tpu's dp build
  errs by 1 otherwise than its own single-device build in the final leaf
  of one case, where the port's dp build agrees with both single-device
  builds) of rmi_tpu's dp build and of the port's own ``train``; top
  rows within the same tolerance, integer top parameters bit-equal to
  rmi_tpu's.
- Serving: from rmi_tpu's dp outputs carried across, for the ten tops,
  guess and err bit-equal to rmi_tpu's _rmi_eval and 0 bound violations
  on every key; from the port's own dp outputs, 0 violations; replicate_rmi
  with shard_queries and unshard, and replicate_rmi_per_device with
  search_sharded over [cpu, cpu], equal to np.searchsorted.
- multihost: initialize() is False without an environment; inside the
  world global_mesh is (4,) named ("data",) and hybrid_mesh (1, 4) named
  ("config", "data"); NCCL is refused for two ranks on one card, and on
  a host without a card, before anything starts.
- Boundaries: 2^16 keys with duplicate runs across every shard boundary
  and one run across three, for linear and cubic leaves (K6 over clipped
  spans); test_parallel.py's 2^22-key stress case as a ``slow`` test.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import rmi_tpu_torch as rt
from rmi_tpu_torch import keys as tkeys
from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.models import get_model
from rmi_tpu_torch.parallel import dp_trainer, multihost, serve
from rmi_tpu_torch.train import two_layer
from rmi_tpu_torch.utils import segments as seg

WORLD = 4
SUBGROUP = [2, 3]
RANGE_SUM_RTOL = 1e-12
U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)

CONFIGS = [("linear", "linear", 64), ("cubic", "linear", 64),
           ("linear_spline", "linear_spline", 32), ("robust_linear", "linear", 32),
           ("cubic", "cubic", 32)]
ANY_N = [1001, 4093, 4099, 37]
MASKED_TOPS = ["radix", "bradix", "histogram"]
ZOO = [("loglinear", "linear", 32), ("normal", "linear", 32), ("lognormal", "linear", 32),
       ("radix", "linear", 64), ("bradix", "linear", 64), ("histogram", "linear", 32),
       ("linear", "loglinear", 16), ("linear", "normal", 16), ("linear", "lognormal", 16),
       ("linear", "robust_linear", 32)]
SERVE_TOPS = list(dp_trainer.DP_TOP_MODELS)
BOUNDARY = [("linear", "linear", 256), ("cubic", "cubic", 256)]


def _uniform(n, seed, lo=0):
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(lo, 2 ** 40, size=n, dtype=np.uint64))


def _dups(n, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, n // 3, size=n, dtype=np.uint64)) * 11 + 5


def _max_tail():
    keys = _uniform(4001, 99)
    keys[-7:] = U64_MAX
    return keys


def _high_keys(seed):
    """Keys near the top of the u64 range, where bradix's and histogram's
    parameters leave f64's 53-bit window (test_parallel.py:241-244)."""
    rng = np.random.default_rng(seed)
    return np.sort((rng.integers(1, 2 ** 40, size=4096, dtype=np.uint64) << np.uint64(22))
                   | np.uint64(0x3FFFFF))


def _boundary_keys(per_shard, seed):
    """Sorted keys with a duplicate run straddling every shard boundary
    (varied lengths either side) and one run across three boundaries
    (test_parallel.py:305-327, for four shards)."""
    n = WORLD * per_shard
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 2 ** 48, size=n, dtype=np.uint64))
    scale = max(1, per_shard // 1000)
    for s in range(1, WORLD):
        b = s * per_shard
        keys[b - scale * (5 + 10 * (s % 3)):b + scale * (10 + 7 * (s % 5))] = keys[b]
    keys[per_shard - 11:3 * per_shard + 13] = keys[2 * per_shard]
    return np.sort(keys)


def _dp_cases():
    """case id -> (keys, top, leaf, B): every dp build the world runs."""
    cases = {}
    for top, leaf, B in CONFIGS:
        for kind, make in (("uniform", _uniform), ("dups", _dups)):
            cases[f"match-{top},{leaf}-{kind}"] = (make(4096, 11), top, leaf, B)
    for n in ANY_N:
        cases[f"anyn-{n}"] = (_uniform(n, 12), "cubic", "linear", 16 if n < 100 else 64)
    for top in MASKED_TOPS:
        cases[f"masked-{top}"] = (_uniform(4099, 13, lo=1), top, "linear", 64)
    cases["tail"] = (_max_tail(), "linear", "linear", 32)
    for top, leaf, B in ZOO:
        cases[f"zoo-{top},{leaf}"] = (_uniform(4096, 14, lo=1), top, leaf, B)
    for top in SERVE_TOPS:
        cases[f"serve-{top}"] = (_high_keys(15), top, "linear", 64)
    for top, leaf, B in BOUNDARY:
        cases[f"boundary-{top},{leaf}"] = (_boundary_keys(16411, 16), top, leaf, B)
    return cases


CASES = _dp_cases()


def _primitive_inputs():
    rng = np.random.default_rng(17)
    n = 1001                                        # not a multiple of the world
    keys = np.sort(rng.integers(0, 300, size=WORLD * 251, dtype=np.uint64))
    v = rng.standard_normal(WORLD * 251)
    a = rng.integers(0, n, size=64)
    b = np.minimum(a + rng.integers(0, 400, size=64), n)
    g = rng.integers(0, WORLD * 251, size=64)
    queries = np.sort(rng.integers(0, 300, size=64)).astype(np.uint64)
    return {"n": n, "keys": keys, "v": v, "a": a, "b": b, "g": g, "queries": queries}


PRIMITIVES = _primitive_inputs()
SERVE_KEYS = _uniform(8192, 18)
SERVE_QUERIES = np.random.default_rng(19).integers(0, 2 ** 41, size=1000, dtype=np.uint64)


# ---------------------------------------------------------------------------
# the world: every case on each of four gloo ranks on the CPU
# ---------------------------------------------------------------------------

def _rank_primitives(comm):
    p = PRIMITIVES
    m = p["v"].shape[0] // WORLD
    sl = slice(comm.rank * m, (comm.rank + 1) * m)
    v = torch.from_numpy(p["v"][sl].copy())
    keys = tkeys.to_image(p["keys"][sl])
    a, b, g = (torch.from_numpy(p[k]) for k in ("a", "b", "g"))
    yfix = dp_trainer.dist_fixdups(keys, comm)
    run_start, run_end = dp_trainer.dist_run_bounds(keys, yfix, p["n"], comm)
    return {"range_sum": dp_trainer.global_range_sum(v, a, b, comm),
            "value_at": dp_trainer.global_value_at(v, g, comm),
            "searchsorted": dp_trainer.global_searchsorted(
                keys, tkeys.to_image(p["queries"]), comm),
            "fixdups": yfix, "run_start": run_start, "run_end": run_end}


def _rank_serving(rank):
    data = rt.RMIDataset.from_numpy(SERVE_KEYS, device="cpu")
    rmi = rt.train(data, "cubic,linear", 64) if rank == 0 else None
    replica = serve.replicate_rmi(rmi, device="cpu")
    part, m = serve.shard_queries(tkeys.to_image(SERVE_QUERIES))
    answers = serve.unshard(rt.search(replica, part), m)
    out = {"answers": answers, "leaf_w": replica.device_leaf_params,
           "leaf_errors": replica.leaf_errors, "part": part.shape[0]}
    # a group of the last two ranks: its rank 0 (global rank 2) is the source
    sub = dist.new_group(SUBGROUP)
    if rank in SUBGROUP:
        own = rt.train(data, "cubic,linear", 32) if rank == SUBGROUP[0] else None
        replica = serve.replicate_rmi(own, group=sub, device="cpu")
        part, m = serve.shard_queries(tkeys.to_image(SERVE_QUERIES), group=sub)
        out["subgroup"] = {"answers": serve.unshard(rt.search(replica, part), m, group=sub),
                           "leaf_w": replica.device_leaf_params, "part": part.shape[0]}
    return out


def _world(rank):
    """Everything the tests read from the ranks, rank ``rank``'s part."""
    comm = dp_trainer.DPGroup()
    out = {"primitives": _rank_primitives(comm), "serving": _rank_serving(rank)}
    mesh, hybrid = multihost.global_mesh(), multihost.hybrid_mesh()
    out["meshes"] = (tuple(mesh.mesh.shape), mesh.mesh_dim_names,
                     tuple(hybrid.mesh.shape), hybrid.mesh_dim_names)
    shard_keys = tkeys.to_image(_uniform(4099, 20))
    out["shard"] = dp_trainer.local_shard(shard_keys, KeyType.U64)
    for cid, (keys, top, leaf, B) in CASES.items():
        data = rt.RMIDataset.from_numpy(keys, device="cpu")
        keys_local, n = dp_trainer.local_shard(data.keys, KeyType.U64)
        res = dp_trainer.dp_train_two_layer(keys_local, n, KeyType.U64, top, leaf, B, comm)
        rmi = dp_trainer.trained_rmi(data.keys, KeyType.U64, top, leaf, B, res)
        guess, err = rt.lookup(rmi, data.keys)
        lb = torch.searchsorted(data.keys, data.keys)
        t = two_layer.top_assignment(get_model(top), rmi.device_top_params, data.keys,
                                     rmi.norm_offset, rmi.norm_scale, B - 1)
        spans = seg.make_spans(t.to(torch.int32), B)
        out[cid] = {"res": res, "violations": int(((guess - lb).abs() > err).sum()),
                    "counts": spans.ends - spans.starts}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    init = tmp_path_factory.mktemp("world") / "rendezvous"
    return multihost.run_ranks(_world, WORLD, f"file://{init}", backend="gloo",
                               device="cpu", timeout=600)


@pytest.fixture(scope="module")
def mesh4():
    import jax
    from jax.sharding import Mesh
    devs = np.array(jax.devices())
    assert devs.size >= WORLD, "conftest must provide 8 virtual devices"
    return Mesh(devs[:WORLD], ("data",))


def _same(a, b):
    """Two ranks' outputs (nested dicts, tuples, numpy arrays) bit-equal."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    return a == b


def _case(world, cid):
    """Rank 0's result of case ``cid``, after checking that every rank
    returned the same bits."""
    for other in world[1:]:
        assert _same(world[0][cid], other[cid]), f"{cid}: ranks disagree"
    return world[0][cid]


def _j_dp(mesh4, keys, top, leaf, B):
    import jax.numpy as jnp
    from rmi_tpu.keys import KeyType as JKeyType
    from rmi_tpu.parallel.dp_trainer import dp_train_two_layer
    return dp_train_two_layer(jnp.asarray(keys), JKeyType.U64, top, leaf, B, mesh4)


def _rows(p):
    return np.asarray(p["w"] if isinstance(p, dict) else p)


def _within_dp_tolerance(errs, want_errs, rows, want_rows, log2, want_log2, B, counts):
    """rmi_tpu's dp tolerance (test_parallel.py:52-63): leaf errors within
    1 on at most max(1, B / 20) leaves, leaf rows within rtol 1e-6, atol
    1e-8, avg_log2 within 1e-6 relative, beyond which it may move only by
    what the leaves whose errors differ explain (their key ``counts``
    times the change of log2(2 err + 2), over n)."""
    e1, e2 = np.asarray(want_errs).astype(np.int64), np.asarray(errs).astype(np.int64)
    assert np.abs(e1 - e2).max() <= 1
    assert (e1 != e2).sum() <= max(1, B // 20)
    np.testing.assert_allclose(rows, want_rows, rtol=1e-6, atol=1e-8)
    explained = (counts * np.abs(np.log2(2.0 * e1 + 2.0) - np.log2(2.0 * e2 + 2.0))).sum()
    assert abs(log2 - float(want_log2)) <= 1e-6 * abs(float(want_log2)) + \
        explained / counts.sum()


def _int_top_equal(got, want):
    """The port's integer top parameters (int64 bits, pivots as images)
    bit-equal to rmi_tpu's u64 ones."""
    for k, w in want.items():
        w = np.asarray(w)
        if k == "pivots":
            np.testing.assert_array_equal(tkeys.from_image(torch.from_numpy(got[k])), w)
        else:
            np.testing.assert_array_equal(got[k].view(np.uint64), w.astype(np.uint64))


def _check_case(world, mesh4, cid):
    keys, top, leaf, B = CASES[cid]
    res = _case(world, cid)
    top_w, leaf_w, errs, metrics = res["res"]
    assert res["violations"] == 0
    assert res["counts"].sum() == keys.shape[0]
    j_top, j_leaf, j_errs, j_metrics = _j_dp(mesh4, keys, top, leaf, B)
    _within_dp_tolerance(errs, j_errs, leaf_w, _rows(j_leaf),
                         metrics["model_avg_log2_error"],
                         j_metrics["model_avg_log2_error"], B, res["counts"])
    if isinstance(j_top, dict):
        _int_top_equal(top_w, j_top)
    else:
        np.testing.assert_allclose(top_w, np.asarray(j_top), rtol=1e-6, atol=1e-8)
    single = rt.train(rt.RMIDataset.from_numpy(keys, device="cpu"), f"{top},{leaf}", B)
    _within_dp_tolerance(errs, single.leaf_errors.numpy(), leaf_w,
                         single.device_leaf_params.numpy(), metrics["model_avg_log2_error"],
                         single.model_avg_log2_error, B, res["counts"])


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["range_sum", "value_at", "searchsorted", "fixdups",
                                  "run_bounds"])
def test_primitives_match_rmi_tpu(world, mesh4, name):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from rmi_tpu.parallel import dp_trainer as jdp
    p = PRIMITIVES
    keys, v = jnp.asarray(p["keys"]), jnp.asarray(p["v"])
    a, b, g = (jnp.asarray(p[k]) for k in ("a", "b", "g"))
    rep, shard = P(), P(jdp.AXIS)

    def run(fn, in_specs, out_specs, *args):
        return jax.jit(jdp.shard_map(fn, mesh4, in_specs, out_specs))(*args)

    ranks = [r["primitives"] for r in world]
    if name in ("range_sum", "value_at", "searchsorted"):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[name], ranks[0][name])
    if name == "range_sum":
        want = run(jdp.global_range_sum, (shard, rep, rep), rep, v, a, b)
        np.testing.assert_allclose(ranks[0][name], np.asarray(want), rtol=RANGE_SUM_RTOL,
                                   atol=RANGE_SUM_RTOL * np.abs(p["v"]).sum())
    elif name == "value_at":
        want = run(jdp.global_value_at, (shard, rep), rep, v, g)
        np.testing.assert_array_equal(ranks[0][name], np.asarray(want))
    elif name == "searchsorted":
        want = run(jdp.global_searchsorted, (shard, rep), rep, keys,
                   jnp.asarray(p["queries"]))
        np.testing.assert_array_equal(ranks[0][name], np.asarray(want))
    else:
        def fixdups_and_runs(k):
            yfix, changed = jdp.dist_fixdups(k)
            return (yfix,) + jdp.dist_run_bounds(k, changed, p["n"])

        want = run(fixdups_and_runs, (shard,), (shard, shard, shard), keys)
        got = [np.concatenate([r[k] for r in ranks])
               for k in ("fixdups", "run_start", "run_end")]
        fields = [0] if name == "fixdups" else [1, 2]
        for i in fields:
            np.testing.assert_array_equal(got[i], np.asarray(want[i]).astype(np.int64))


@pytest.mark.parametrize("kind", ["uniform", "dups"])
@pytest.mark.parametrize("top,leaf,B", CONFIGS)
def test_dp_matches_rmi_tpu(world, mesh4, top, leaf, B, kind):
    _check_case(world, mesh4, f"match-{top},{leaf}-{kind}")


@pytest.mark.parametrize("n", ANY_N)
def test_dp_any_n(world, mesh4, n):
    _check_case(world, mesh4, f"anyn-{n}")


@pytest.mark.parametrize("top", MASKED_TOPS)
def test_dp_any_n_masked_tops(world, mesh4, top):
    _check_case(world, mesh4, f"masked-{top}")


def test_dp_any_n_max_key_tail(world, mesh4):
    _check_case(world, mesh4, "tail")


@pytest.mark.parametrize("top,leaf,B", ZOO)
def test_dp_full_zoo(world, mesh4, top, leaf, B):
    _check_case(world, mesh4, f"zoo-{top},{leaf}")


@pytest.mark.parametrize("top", SERVE_TOPS)
def test_dp_params_serve_exact(world, mesh4, top):
    """rmi_tpu's dp outputs carried across serve as its _rmi_eval does, bit
    for bit, with 0 violations; the port's own serve with 0 violations
    and their integer parameters are rmi_tpu's."""
    import jax.numpy as jnp
    from rmi_tpu.keys import KeyType as JKeyType
    from rmi_tpu.lookup import _rmi_eval
    from rmi_tpu.train.two_layer import norm_constants
    keys, _, leaf, B = CASES[f"serve-{top}"]
    n = keys.shape[0]
    j_top, j_leaf, j_errs, _ = _j_dp(mesh4, keys, top, leaf, B)
    kminf, snorm = norm_constants(jnp.asarray(keys), JKeyType.U64)
    g, e, _ = _rmi_eval(jnp.asarray(keys), j_top, j_leaf, j_errs, jnp.float64(kminf),
                        jnp.float64(snorm), top_type=top, leaf_type=leaf, B=B, n=n,
                        key_type=JKeyType.U64)
    top_w = ({k: np.asarray(v) for k, v in j_top.items()} if isinstance(j_top, dict)
             else np.asarray(j_top))
    rc = rt.trained_from_numpy(f"{top},{leaf}", B, KeyType.U64, keys, top_w,
                               np.asarray(j_leaf), np.asarray(j_errs), float(kminf),
                               float(snorm), device="cpu")
    guess, err = rt.lookup(rc, tkeys.to_image(keys))
    np.testing.assert_array_equal(guess.numpy(), np.asarray(g))
    np.testing.assert_array_equal(err.numpy(), np.asarray(e))
    lb = np.searchsorted(keys, keys, side="left")
    assert (np.abs(guess.numpy() - lb) > err.numpy()).sum() == 0
    _check_case(world, mesh4, f"serve-{top}")


@pytest.mark.parametrize("top,leaf,B", BOUNDARY)
def test_dp_boundary_runs(world, mesh4, top, leaf, B):
    """Duplicate runs across every shard boundary and one across three:
    the carries of the run starts and ends, leaves that start on one
    shard and end on the next, cover a whole shard, or hold only an
    edge point on a shard (K6's clipped spans for cubic leaves)."""
    _check_case(world, mesh4, f"boundary-{top},{leaf}")


def test_replicate_rmi_and_shard_queries(world):
    want = np.searchsorted(SERVE_KEYS, SERVE_QUERIES, side="left")
    for r in world:
        s = r["serving"]
        np.testing.assert_array_equal(s["answers"], want)
        assert s["part"] == -(-SERVE_QUERIES.shape[0] // WORLD)
        assert _same(s["leaf_w"], world[0]["serving"]["leaf_w"])
        assert _same(s["leaf_errors"], world[0]["serving"]["leaf_errors"])


def test_replicate_rmi_over_a_subgroup(world):
    """replicate_rmi and shard_queries over a group of ranks 2 and 3: the
    index of the group's rank 0, the batch cut in two."""
    want = rt.train(rt.RMIDataset.from_numpy(SERVE_KEYS, device="cpu"), "cubic,linear", 32)
    for r in world[SUBGROUP[0]:]:
        s = r["serving"]["subgroup"]
        np.testing.assert_array_equal(s["answers"],
                                      np.searchsorted(SERVE_KEYS, SERVE_QUERIES, side="left"))
        assert s["part"] == -(-SERVE_QUERIES.shape[0] // len(SUBGROUP))
        np.testing.assert_array_equal(s["leaf_w"], want.device_leaf_params.numpy())
    assert sum("subgroup" in r["serving"] for r in world) == len(SUBGROUP)


def test_replicate_per_device_and_search_sharded():
    rmi = rt.train(rt.RMIDataset.from_numpy(SERVE_KEYS, device="cpu"), "cubic,linear", 64)
    rmis = serve.replicate_rmi_per_device(rmi, ["cpu", "cpu"])
    assert len(rmis) == 2 and all(r.keys.device.type == "cpu" for r in rmis)
    q = tkeys.to_image(SERVE_QUERIES[:1003])
    out = serve.search_sharded(rmis, q)
    np.testing.assert_array_equal(out.numpy(),
                                  np.searchsorted(SERVE_KEYS, SERVE_QUERIES[:1003]))


def test_local_shard_pads_with_max_keys(world):
    keys = _uniform(4099, 20)
    shards = [r["shard"] for r in world]
    assert all(n == keys.shape[0] for _, n in shards)
    got = np.concatenate([s for s, _ in shards])
    m = -(-keys.shape[0] // WORLD)
    assert got.shape[0] == WORLD * m
    np.testing.assert_array_equal(tkeys.from_image(torch.from_numpy(got[:keys.shape[0]])),
                                  keys)
    assert (got[keys.shape[0]:] == KeyType.U64.max_image).all()


def test_meshes_inside_the_world(world):
    for r in world:
        assert r["meshes"] == ((WORLD,), ("data",), (1, WORLD), ("config", "data"))


def test_initialize_without_an_environment(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize() is False


def test_nccl_refused_for_ranks_sharing_a_card(monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="one CUDA card per rank"):
        multihost.check_nccl(2, 1)
    multihost.check_nccl(1, 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError):       # two ranks, cuda:0 for both
        multihost.initialize(f"file://{tmp_path}/nccl", 2, 0, backend="nccl",
                             device="cuda:0")
    with pytest.raises(ValueError, match="NCCL"):
        multihost.initialize(f"file://{tmp_path}/nccl", 2, 0, backend="nccl",
                             device="cpu")
    assert not torch.distributed.is_initialized()


def test_no_card_no_rank(tmp_path):
    """A rank asked for without a device goes to its card, and without one
    raises: nothing carries on on the CPU unless asked."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize(f"file://{tmp_path}/gloo", 1, 0, backend="gloo")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("top,leaf", [("radix8", "linear"), ("linear", "radix8")])
def test_unsupported_models_raise(top, leaf):
    with pytest.raises(NotImplementedError):
        dp_trainer.dp_train_two_layer(torch.zeros(4, dtype=torch.int64), 4, KeyType.U64,
                                      top, leaf, 4)


def _stress_rank(rank, keys, B):
    data = rt.RMIDataset.from_numpy(keys, device="cpu")
    keys_local, n = dp_trainer.local_shard(data.keys, KeyType.U64)
    res = dp_trainer.dp_train_two_layer(keys_local, n, KeyType.U64, "linear", "linear", B)
    rmi = dp_trainer.trained_rmi(data.keys, KeyType.U64, "linear", "linear", B, res)
    guess, err = rt.lookup(rmi, data.keys)
    lb = torch.searchsorted(data.keys, data.keys)
    return res, int(((guess - lb).abs() > err).sum())


@pytest.mark.slow
def test_dp_boundary_stress_large(mesh4, tmp_path):
    """test_parallel.py's stress case at n > 2^22 over four ranks: odd
    shards, runs across every boundary and one across three; the bound
    on every key, and the errors within 1 of train's and rmi_tpu's dp
    build."""
    keys = _boundary_keys(1_048_601, 20260818)
    B = 4096
    (res, viol), *_ = multihost.run_ranks(_stress_rank, WORLD, f"file://{tmp_path}/w",
                                          backend="gloo", device="cpu", args=(keys, B),
                                          timeout=1200)
    assert viol == 0
    single = rt.train(rt.RMIDataset.from_numpy(keys, device="cpu"), "linear,linear", B)
    for want in (single.leaf_errors.numpy(), _j_dp(mesh4, keys, "linear", "linear", B)[2]):
        assert np.abs(np.asarray(want).astype(np.int64) - res[2]).max() <= 1
