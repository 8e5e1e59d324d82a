"""The port's Pareto optimizer against rmi_tpu's, on the CPU:
rmi_tpu_torch/optimizer.py, parallel/sweep.py, train_async, PendingRMI,
train_for_size and the build-phase timer.

- The rules (dominance with its ties, the Pareto front, narrow_front, the
  profiles and both phases' configurations) are rmi_tpu's bit for bit,
  on hypothesis-drawn statistics whose sizes repeat and whose average
  log2 errors lie within f64 epsilon of each other.
- The selection alone: rmi_tpu's measured statistics carried across
  give rmi_tpu's front.
- Measurement: the port's front on N = 5000 keys (a seeded draw with a
  duplicate run), the fast profile over branching factors BFS (patched
  the same way in both packages, as tests/test_optimizer.py patches
  rmi_tpu's), against rmi_tpu's per-build sweep (RMI_OPT_BUCKETED=0):
  equal (models, branching factor, size) lists and max errors (their
  log2 within an ulp: same_max_error), average log2 errors within
  AVG_RTOL relative; against rmi_tpu's
  default bucketed sweep, within BUCKETED_RTOL, the tolerance rmi_tpu
  accepts between its own two sweeps.
- train_for_size picks rmi_tpu's configuration and RMI_SIZE, or raises
  rmi_tpu's error.
- A sweep dispatches every build before its one fetch (observed through
  api.fetch_host), a pool of two CPU devices gives one device's results,
  shared inputs and RMI_PROFILE_BUILD=1 leave builds bit-equal, and the
  optimizer times its two phases.
- The max errors chip_smoke's path 9 logs, at its keys a leaf: the same
  max error at the same leaf as rmi_tpu's per-build path, for 9a's
  linear,linear on wiki keys and 9d's robust_linear,cubic.
rmi_tpu's sweeps run once per module (its CPU compiles dominate).
"""

import math
from fractions import Fraction
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import rmi_tpu.optimizer as j_opt
from rmi_tpu.data import RMIDataset as JDataset
from rmi_tpu.serialize import rmi_size as j_rmi_size
from rmi_tpu.train.api import train as j_train, train_for_size as j_train_for_size

import rmi_tpu_torch as rt
from rmi_tpu_torch import optimizer as t_opt
from rmi_tpu_torch.data import synthetic_dataset
from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.models import get_model
from rmi_tpu_torch.models.base import params_equal
from rmi_tpu_torch.parallel import sweep
from rmi_tpu_torch.train import api, two_layer
from rmi_tpu_torch.utils import profiling, segments as seg

N = 5000
BFS = [16, 64, 256, 1024]        # the fast profile's phase 1 then runs at 16 only
AVG_RTOL = 1e-7
BUCKETED_RTOL = 2e-3
FULL = 1000                      # train_for_size's restrict: the whole front


def restrict_grid(mp):
    """The fast profile over BFS, in both packages."""
    mp.setenv("RMI_OPTIMIZER_PROFILE", "fast")
    for mod in (j_opt, t_opt):
        mp.setattr(mod, "branching_factors", lambda: list(BFS))


@pytest.fixture(scope="module")
def keys():
    rng = np.random.default_rng(2024)
    k = np.sort(rng.integers(0, 2 ** 40, size=N, dtype=np.uint64))
    k[1000:1040] = k[1000]
    return k


@pytest.fixture(scope="module")
def t_data(keys):
    return rt.RMIDataset.from_numpy(keys, device="cpu")


@pytest.fixture(scope="module")
def j_runs(keys):
    """rmi_tpu's sweeps, once: per build (with every measurement, in
    order) and bucketed."""
    with pytest.MonkeyPatch.context() as mp:
        restrict_grid(mp)
        ds = JDataset.from_numpy(keys)
        measured = []
        mp.setenv("RMI_OPT_BUCKETED", "0")
        per_build = j_opt.find_pareto_efficient_configs(ds, restrict=FULL,
                                                        progress=measured.append)
        n1 = len(j_opt.first_phase_configs())
        mp.setenv("RMI_OPT_BUCKETED", "1")
        bucketed = j_opt.find_pareto_efficient_configs(ds, restrict=FULL)
    return {"per_build": per_build, "bucketed": bucketed,
            "phase1": measured[:n1], "phase2": measured[n1:]}


@pytest.fixture(scope="module")
def t_front(t_data):
    with pytest.MonkeyPatch.context() as mp:
        restrict_grid(mp)
        return t_opt.find_pareto_efficient_configs(t_data, restrict=FULL)


def same_max_error(a, b):
    """Two max log2 errors of one max error: XLA computes log2 as
    log(x) * (1 / ln 2), torch (as the reference's f64::log2) rounds
    log2 itself, so the two may differ in their last bit (log2(120))."""
    return round(2.0 ** a) == round(2.0 ** b) and abs(a - b) <= math.ulp(b)


def rows(stats):
    return [(s.models, s.branching_factor, s.size) for s in stats]


def as_tuples(stats):
    return [(s.models, s.branching_factor, s.average_log2_error, s.max_log2_error,
             s.size) for s in stats]


# ---------------------------------------------------------------------------
# (a) the rules, bit for bit
# ---------------------------------------------------------------------------

def _near(base, ulps):
    for _ in range(ulps):
        base = math.nextafter(base, math.inf)
    return base


# average log2 errors a few ulps apart: below, at and above f64 epsilon
# (an ulp of 0.3 is eps / 4, of 0.7 eps / 2, of 3.0 2 eps)
LOG2 = st.builds(_near, st.sampled_from([0.3, 0.7, 3.0, 5.5]), st.integers(0, 6))
ROW = st.tuples(st.sampled_from(["linear,linear", "cubic,linear", "radix,cubic"]),
                st.sampled_from([64, 256, 1024]), LOG2, LOG2,
                st.sampled_from([100, 1552, 1568, 6160, 24608]))


def both(rows_):
    return ([j_opt.RMIStatistics(*r) for r in rows_],
            [t_opt.RMIStatistics(*r) for r in rows_])


@settings(max_examples=300, deadline=None)
@given(drawn=st.lists(ROW, max_size=14), keep=st.integers(2, 8))
def test_rules_bit_for_bit(drawn, keep):
    js, ts = both(drawn)
    for a in range(len(drawn)):
        for b in range(len(drawn)):
            assert ts[a].dominated_by(ts[b]) == js[a].dominated_by(js[b])
    assert as_tuples(t_opt.pareto_front(ts)) == as_tuples(j_opt.pareto_front(js))
    assert as_tuples(t_opt.narrow_front(ts, keep)) == as_tuples(j_opt.narrow_front(js, keep))
    assert as_tuples(t_opt.narrow_front(t_opt.pareto_front(ts), keep)) == \
        as_tuples(j_opt.narrow_front(j_opt.pareto_front(js), keep))


def test_epsilon_ties():
    """Within epsilon and no larger: never dominated; equal size and error:
    neither dominates (optimizer.rs:173-187)."""
    eps = sys.float_info.epsilon
    for mod in (j_opt, t_opt):
        a = mod.RMIStatistics("a,a", 1, 0.7 + eps / 2, 0.0, 100)
        b = mod.RMIStatistics("b,b", 1, 0.7, 0.0, 100)
        c = mod.RMIStatistics("c,c", 1, 0.7, 0.0, 50)
        assert not a.dominated_by(b) and not b.dominated_by(a)
        assert b.dominated_by(c) and a.dominated_by(c)


@pytest.mark.parametrize("profile", [None, "fast", "memory", "disk"])
def test_profiles_equal(monkeypatch, profile):
    if profile is None:
        monkeypatch.delenv("RMI_OPTIMIZER_PROFILE", raising=False)
    else:
        monkeypatch.setenv("RMI_OPTIMIZER_PROFILE", profile)
    for name in ("top_only_layers", "anywhere_layers", "branching_factors",
                 "first_phase_configs"):
        assert getattr(t_opt, name)() == getattr(j_opt, name)(), name


def test_invalid_profile_raises(monkeypatch):
    monkeypatch.setenv("RMI_OPTIMIZER_PROFILE", "bogus")
    for mod in (j_opt, t_opt):
        for name in ("top_only_layers", "anywhere_layers", "branching_factors"):
            with pytest.raises(ValueError, match="Invalid optimizer profile bogus"):
                getattr(mod, name)()


@pytest.mark.parametrize("profile", [None, "fast", "disk"])
@settings(max_examples=40, deadline=None)
@given(data=st.data())
def test_second_phase_configs_equal(profile, data):
    with pytest.MonkeyPatch.context() as mp:
        if profile is None:
            mp.delenv("RMI_OPTIMIZER_PROFILE", raising=False)
        else:
            mp.setenv("RMI_OPTIMIZER_PROFILE", profile)
        cfgs = j_opt.first_phase_configs()
        picked = data.draw(st.lists(st.sampled_from(cfgs), max_size=10, unique=True))
        drawn = [(m, bf, data.draw(LOG2), data.draw(LOG2),
                  data.draw(st.sampled_from([100, 1552, 6160])))
                 for m, bf in picked]
        js, ts = both(drawn)
        assert t_opt.second_phase_configs(ts) == j_opt.second_phase_configs(js)


def test_display_table_and_grid_spec():
    s = (("cubic,linear", 256, 3.30502837, 4.459431, 6176),)
    js, ts = both(s)
    assert t_opt.display_table(ts) == j_opt.display_table(js)
    assert ts[0].to_grid_spec("ns_0") == js[0].to_grid_spec("ns_0")


# ---------------------------------------------------------------------------
# (b) the selection alone, (c) and (d) measurement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("restrict", [2, 3, 5, 10, FULL])
@pytest.mark.parametrize("reuse_phase1", [False, True])
def test_selection_of_carried_statistics(monkeypatch, t_data, j_runs, restrict,
                                         reuse_phase1):
    """rmi_tpu's measurements carried across: the port selects rmi_tpu's
    front from them (its own rules applied to the same lists)."""
    restrict_grid(monkeypatch)
    measured = {(s.models, s.branching_factor): s
                for s in j_runs["phase1"] + j_runs["phase2"]}

    def carried(pool, configs, progress=None):
        return [t_opt.RMIStatistics(*as_tuples([measured[c]])[0]) for c in configs]

    monkeypatch.setattr(t_opt, "measure_pool", carried)
    got = t_opt.find_pareto_efficient_configs(t_data, restrict, reuse_phase1=reuse_phase1)
    pool = list(j_runs["phase2"])
    if reuse_phase1:
        qualifying = {r.models for r in j_opt.pareto_front(j_runs["phase1"])}
        pool += [r for r in j_runs["phase1"] if r.models in qualifying]
    want = j_opt.narrow_front(j_opt.pareto_front(pool), restrict)
    want.sort(key=lambda r: r.average_log2_error)
    assert as_tuples(got) == as_tuples(want)
    if restrict == FULL and not reuse_phase1:
        assert as_tuples(got) == as_tuples(j_runs["per_build"])


def test_front_against_per_build_sweep(t_front, j_runs):
    want = j_runs["per_build"]
    assert len(want) >= 3
    assert rows(t_front) == rows(want)
    for a, b in zip(t_front, want):
        assert same_max_error(a.max_log2_error, b.max_log2_error)
        assert a.average_log2_error == pytest.approx(b.average_log2_error, rel=AVG_RTOL,
                                                     abs=0)


def test_front_against_bucketed_sweep(t_front, j_runs):
    want = j_runs["bucketed"]
    assert rows(t_front) == rows(want)
    for a, b in zip(t_front, want):
        assert a.average_log2_error == pytest.approx(b.average_log2_error,
                                                     rel=BUCKETED_RTOL, abs=0)


def test_sizes_are_the_builds(t_data, j_runs):
    """A statistic's size is rmi_size of its configuration's build."""
    for s in j_runs["phase2"][:4]:
        assert rt.rmi_size(rt.train(t_data, s.models, s.branching_factor)) == s.size


# ---------------------------------------------------------------------------
# (e) train_for_size
# ---------------------------------------------------------------------------

def rmi_tpus_sweep_once(mp, j_runs):
    """rmi_tpu's train_for_size reads the front of its default sweep: the
    module's bucketed run, not run again."""
    mp.setattr(j_opt, "find_pareto_efficient_configs",
               lambda data, restrict=10, **kw: list(j_runs["bucketed"]))


@pytest.mark.parametrize("budget", [10 ** 8, 10000, 1600])
def test_train_for_size_picks_rmi_tpus_config(monkeypatch, keys, t_data, j_runs, budget):
    restrict_grid(monkeypatch)
    rmi_tpus_sweep_once(monkeypatch, j_runs)
    want = j_train_for_size(JDataset.from_numpy(keys), budget)
    got = rt.train_for_size(t_data, budget)
    assert (got.models, got.branching_factor) == (want.models, want.branching_factor)
    assert rt.rmi_size(got) == j_rmi_size(want) < budget
    assert got.model_max_error == want.model_max_error
    assert got.build_time > 0


def test_train_for_size_nothing_fits(monkeypatch, keys, t_data, j_runs):
    restrict_grid(monkeypatch)
    rmi_tpus_sweep_once(monkeypatch, j_runs)
    msg = "Could not find any configurations smaller than 1000"
    with pytest.raises(RuntimeError, match=msg):
        j_train_for_size(JDataset.from_numpy(keys), 1000)
    with pytest.raises(RuntimeError, match=msg):
        rt.train_for_size(t_data, 1000)


# ---------------------------------------------------------------------------
# (f) one fetch after every dispatch; the device pool
# ---------------------------------------------------------------------------

CONFIGS = [("linear,linear", 32), ("cubic,linear", 64), ("linear,linear", 128),
           ("linear_spline,linear", 64), ("robust_linear,cubic", 16)]


def watch(monkeypatch):
    events = []
    real_async, real_fetch = api.train_async, api.fetch_host

    def dispatched(*a, **kw):
        events.append("dispatch")
        return real_async(*a, **kw)

    def fetched(tree):
        events.append(("fetch", len(tree)))
        return real_fetch(tree)

    monkeypatch.setattr(api, "train_async", dispatched)
    monkeypatch.setattr(api, "fetch_host", fetched)
    return events


@pytest.mark.parametrize("how", ["measure_rmis", "pool of one", "pool of two",
                                 "train grid"])
def test_sweep_fetches_once_after_every_dispatch(monkeypatch, t_data, how):
    events = watch(monkeypatch)
    cpu = t_data.keys.device
    if how == "measure_rmis":
        out = t_opt.measure_rmis(t_data, CONFIGS)
    elif how == "train grid":
        out = sweep.parallel_train_grid(t_data, CONFIGS, devices=[cpu, cpu])
    else:
        pool = sweep.device_pool(t_data, [cpu] * (2 if how == "pool of two" else 1))
        out = sweep.parallel_measure_rmis(pool, CONFIGS)
    assert len(out) == len(CONFIGS)
    assert events == ["dispatch"] * len(CONFIGS) + [("fetch", len(CONFIGS))]


def test_pool_of_two_gives_one_devices_results(t_data):
    cpu = t_data.keys.device
    one = t_opt.measure_rmis(t_data, CONFIGS)
    two = t_opt.statistics(CONFIGS, sweep.parallel_measure_rmis(
        sweep.device_pool(t_data, [cpu, cpu]), CONFIGS))
    assert as_tuples(one) == as_tuples(two)
    grid = sweep.parallel_train_grid(t_data, CONFIGS, devices=[cpu, cpu])
    for (m, bf), s, r in zip(CONFIGS, one, grid):
        assert (r.models, r.branching_factor) == (m, bf)
        assert (r.model_avg_log2_error, r.model_max_log2_error, rt.rmi_size(r)) == \
            (s.average_log2_error, s.max_log2_error, s.size)


def test_sweep_returns_each_builds_metrics(t_data):
    """parallel_measure_rmis gives each configuration's error_metrics on the
    host, in configuration order: a build's own metrics."""
    got = sweep.parallel_measure_rmis(sweep.device_pool(t_data), CONFIGS)
    for (m, bf), vals in zip(CONFIGS, got):
        assert two_layer.metrics_dict(vals) == \
            {k: getattr(rt.train(t_data, m, bf), k) for k in two_layer.METRIC_NAMES}


def test_optimizer_times_its_phases(monkeypatch, t_data):
    """find_pareto_efficient_configs times phase 1 and phase 2 with their
    builds' counts (no device spans off the card), with the build-phase
    timer off."""
    restrict_grid(monkeypatch)
    monkeypatch.delenv("RMI_PROFILE_BUILD", raising=False)
    profiling.last_phase_times.clear()
    profiling.last_phase_builds.clear()
    t_opt.find_pareto_efficient_configs(t_data)
    assert set(profiling.last_phase_times) == {"phase1", "phase2"}
    assert all(t > 0 for t in profiling.last_phase_times.values())
    n1 = len(t_opt.first_phase_configs())
    assert profiling.last_phase_builds["phase1"] == {"builds": n1, "device_ms": []}
    assert profiling.last_phase_builds["phase2"]["builds"] > 0
    assert profiling.last_phase_builds["phase2"]["device_ms"] == []


def test_progress_in_configuration_order(t_data):
    seen = []
    out = t_opt.measure_rmis(t_data, CONFIGS, progress=seen.append)
    assert seen == out
    assert [(s.models, s.branching_factor) for s in out] == CONFIGS


def test_train_fetches_once(monkeypatch, t_data):
    events = watch(monkeypatch)
    rt.train(t_data, "cubic,linear", 64)
    assert events == ["dispatch", ("fetch", 6)]


def test_pending_result_from_prefetched(t_data):
    """A PendingRMI's metrics stay a [6] tensor until result(); a prefetched
    host copy gives the same TrainedRMI as its own fetch."""
    p = api.train_async(t_data, "cubic,linear", 64)
    assert tuple(p.metrics.shape) == (6,)
    host = api.fetch_host([p.metrics])[0]
    a = p.result(prefetched=host)
    assert p.result() is a
    b = rt.train(t_data, "cubic,linear", 64)
    assert same_build(a, b)


# ---------------------------------------------------------------------------
# shared inputs and (g) the build-phase timer: the same bits
# ---------------------------------------------------------------------------

def same_build(a, b):
    return (params_equal(a.device_top_params, b.device_top_params)
            and params_equal(a.device_leaf_params, b.device_leaf_params)
            and np.array_equal(a.leaf_errors.numpy(), b.leaf_errors.numpy())
            and all(getattr(a, k) == getattr(b, k) for k in two_layer.METRIC_NAMES)
            and (a.norm_offset, a.norm_scale) == (b.norm_offset, b.norm_scale))


def typed(keys, key_type):
    if key_type is KeyType.F64:
        return keys.astype(np.float64) * 2.0 ** -20
    if key_type is KeyType.U32:
        return (keys >> np.uint64(10)).astype(np.uint32)
    return keys


@pytest.mark.parametrize("spec,B,key_type", [
    ("cubic,linear", 64, KeyType.U64), ("robust_linear,cubic", 32, KeyType.U64),
    ("radix18,linear", 64, KeyType.U64), ("linear,linear_spline", 128, KeyType.U64),
    ("cubic,loglinear", 64, KeyType.U64), ("cubic,linear", 64, KeyType.F64),
    ("linear,linear", 16, KeyType.U32)])
def test_shared_inputs_bit_equal(keys, spec, B, key_type):
    ds = rt.RMIDataset.from_numpy(typed(keys, key_type), key_type, device="cpu")
    shared = two_layer.shared_inputs(ds.keys, ds.key_type)
    assert shared["yfix"].dtype == torch.int32 and shared["yfix"].shape == ds.keys.shape
    assert same_build(api.train_async(ds, spec, B, shared=shared).result(),
                      rt.train(ds, spec, B))


def test_shared_inputs_of_other_keys_refused(t_data):
    shared = two_layer.shared_inputs(t_data.keys[:100], t_data.key_type)
    with pytest.raises(ValueError, match="FixDups of these keys"):
        api.train_async(t_data, "linear,linear", 16, shared=shared)


@pytest.mark.parametrize("spec,B", [("cubic,linear", 64), ("radix18,cubic", 32)])
def test_profile_build_times_phases(monkeypatch, t_data, spec, B):
    plain = rt.train(t_data, spec, B)
    profiling.last_phase_times.clear()
    monkeypatch.setenv("RMI_PROFILE_BUILD", "1")
    timed = rt.train(t_data, spec, B)
    assert set(profiling.last_phase_times) == {"assign", "fit", "sweep"}
    assert all(t > 0 for t in profiling.last_phase_times.values())
    assert same_build(timed, plain)


def test_phase_timer_off_by_default(monkeypatch, t_data):
    monkeypatch.delenv("RMI_PROFILE_BUILD", raising=False)
    profiling.last_phase_times.clear()
    rt.train(t_data, "linear,linear", 16)
    assert profiling.last_phase_times == {}


# ---------------------------------------------------------------------------
# the max errors chip_smoke's path 9 logs, against rmi_tpu's per-build path
# ---------------------------------------------------------------------------

def leaf_counts(r):
    t = two_layer.top_assignment(get_model(r.top_type), r.device_top_params, r.keys,
                                 r.norm_offset, r.norm_scale, r.branching_factor - 1,
                                 r.key_type)
    spans = seg.make_spans(t.to(torch.int32), r.branching_factor)
    return (spans.ends - spans.starts).numpy()


def assert_same_max_error(keys, spec, B):
    """The port's build and rmi_tpu's of the same keys: the same max error
    at the same leaf, every leaf error within 1, and the average log2
    errors apart by what the differing leaves explain (ROADMAP's PARITY
    rule without its count of differing leaves).  Returns the port's
    build and its leaves' key counts."""
    rp = rt.train(rt.RMIDataset.from_numpy(keys, device="cpu"), spec, B)
    rj = j_train(JDataset.from_numpy(keys), spec, B)
    assert (rp.model_max_error, rp.model_max_error_idx) == \
        (rj.model_max_error, rj.model_max_error_idx)
    e_p = rp.leaf_errors.numpy()
    e_j = np.asarray(rj.leaf_errors).astype(np.int64)
    assert np.abs(e_p - e_j).max() <= 1
    cnt = leaf_counts(rp)
    explained = np.sum((cnt * (np.log2(2.0 * e_p + 2.0) - np.log2(2.0 * e_j + 2.0)))
                       [e_p != e_j]) / keys.size
    d = rp.model_avg_log2_error - rj.model_avg_log2_error
    assert abs(d - explained) <= AVG_RTOL * abs(rj.model_avg_log2_error)
    return rp, cnt


@pytest.mark.parametrize("B", [5243, 1 << 20])
def test_wiki_linear_leaves_against_rmi_tpu(B):
    """9a's choice, linear,linear, on 2^20 wiki keys (seed 7, as 9a and
    SOSD_SYNTH.json) at 9a's keys a leaf and at 9a's B.  At B = n the
    final leaf holds no key and, never constant-patched, errs by n in
    both packages."""
    keys = synthetic_dataset("wiki", 1 << 20, KeyType.U64, seed=7)
    rp, cnt = assert_same_max_error(keys, "linear,linear", B)
    if B == keys.size:
        assert rp.model_max_error == keys.size and rp.model_max_error_idx == B - 1
        assert cnt[-1] == 0


@pytest.mark.parametrize("seed", [1, 2])
def test_final_empty_leaf_at_9ds_density_against_rmi_tpu(seed):
    """9d's point, robust_linear,cubic at 2^27 leaves for 200M keys, cut to
    2^16 books-like keys (exponential gaps) at the same leaves a key: the
    final leaf holds no key and, never constant-patched, errs by n - 1 in
    both packages."""
    n = 1 << 16
    rng = np.random.default_rng(seed)
    keys = np.cumsum(np.round(rng.exponential(size=n) * 2.0 ** 40).astype(np.uint64))
    B = round((1 << 27) * n / 200_000_000)
    rp, cnt = assert_same_max_error(keys, "robust_linear,cubic", B)
    assert (rp.model_max_error, rp.model_max_error_idx) == (n - 1, B - 1)
    assert cnt[-1] == 0


# ---------------------------------------------------------------------------
# cubic,linear at B = 16 on these keys: the one leaf error that differs
# ---------------------------------------------------------------------------

def _two_point_line(x0, x1, y0, y1):
    """The exact least-squares line (alpha, beta) through two points, as
    Fractions of the f64 inputs."""
    beta = Fraction(y1 - y0) / (Fraction(x1) - Fraction(x0))
    return Fraction(y1) - beta * Fraction(x1), beta


def test_b16_final_leaf_is_rmi_tpus_prefix_sum_rounding(keys, t_data):
    """cubic,linear at B = 16 (ROADMAP Queue 3, closed): every leaf error
    equals rmi_tpu's but the final leaf's, which holds one key, the last:
    1 in the port, 2 in rmi_tpu, and the average log2 errors are apart by
    what that leaf explains.  Its fit runs over keys 4998 and 4999 (the
    leaf and its overlap); the reference's streaming fit (linear.rs:37-55)
    gives the exact line through them, and so does rmi_tpu's own leaf fit
    (models/linear.py:_slr_ranges) of the two keys alone; over the whole
    array its moments are differences of prefix sums from key 0
    (utils/segments.py:range_sum), which move that leaf's slope by 4e-8.
    The exact line errs by 1 at the leaf, as the port does, and the port
    holds |guess - lb| <= err at the leaf's key and at its two probes."""
    import jax
    import jax.numpy as jnp
    from rmi_tpu.models import linear as j_linear
    from rmi_tpu.utils import segments as j_seg
    from rmi_tpu_torch import keys as tkeys
    from rmi_tpu_torch.ops import eval_kernel

    B, n = 16, keys.size
    rp = rt.train(t_data, "cubic,linear", B)
    rj = j_train(JDataset.from_numpy(keys), "cubic,linear", B)
    e_p, e_j = rp.leaf_errors.numpy(), np.asarray(rj.leaf_errors).astype(np.int64)
    assert np.flatnonzero(e_p != e_j).tolist() == [B - 1]
    assert (e_p[-1], e_j[-1]) == (1, 2)
    cnt = leaf_counts(rp)
    assert cnt[-1] == 1 and cnt.sum() == n                 # the last key alone
    explained = cnt[-1] * (math.log2(2.0 * e_p[-1] + 2.0) - math.log2(2.0 * e_j[-1] + 2.0)) / n
    d = rp.model_avg_log2_error - rj.model_avg_log2_error
    assert abs(d - explained) <= AVG_RTOL * abs(rj.model_avg_log2_error)

    # the cause: rmi_tpu's leaf fit over the whole array against the same
    # fit of the leaf's two keys alone, and the exact line through them
    x = (keys.astype(np.float64) - rp.norm_offset) * rp.norm_scale
    y = np.arange(n, dtype=np.float64)                      # the keys are distinct there
    t = two_layer.top_assignment(get_model("cubic"), rp.device_top_params, rp.keys,
                                 rp.norm_offset, rp.norm_scale, B - 1).numpy()

    def j_fit(lo):
        spans = j_seg.make_spans(jnp.asarray(t[lo:].astype(np.int32)), B)
        fit = jax.jit(lambda a, b: j_linear._slr_ranges(a, b, spans)[0])
        return np.asarray(fit(jnp.asarray(x[lo:]), jnp.asarray(y[lo:])))[B - 1]

    alpha, beta = _two_point_line(x[n - 2], x[n - 1], n - 2, n - 1)
    exact = np.array([float(alpha), float(beta)])
    whole, alone = j_fit(0), j_fit(n - 2)
    np.testing.assert_allclose(alone, exact, rtol=1e-12)
    assert abs(whole[1] / exact[1] - 1) > 1e-8
    np.testing.assert_allclose(np.asarray(rj.device_leaf_params["w"])[B - 1], whole,
                               rtol=1e-9)
    np.testing.assert_allclose(rp.device_leaf_params[B - 1].numpy(), exact, rtol=1e-12)

    # the leaf's key, its lower probe (the previous leaf's last key + 1,
    # target that key's index + 1) and its upper probe (past the last key,
    # target n): the exact line's errors by the reference's rules, and the
    # port's guesses within the port's error
    img = rp.keys
    probe_keys = torch.cat([img[n - 1:], tkeys.plus_epsilon(img[n - 2:n - 1], KeyType.U64),
                            tkeys.minus_epsilon(torch.tensor([KeyType.U64.max_image]),
                                                KeyType.U64)])
    targets = torch.tensor([n - 1, n - 1, n])
    xp = two_layer.model_float_input(get_model("linear"), probe_keys, rp.norm_offset,
                                     rp.norm_scale, KeyType.U64)
    exact_pred = [min(max(math.floor(alpha + beta * Fraction(v)), 0), n) for v in xp.tolist()]
    assert max(abs(p - min(int(g), n)) for p, g in zip(exact_pred, targets)) == 1
    pred = eval_kernel.leaf_eval_clamped(xp, rp.device_leaf_params, torch.full((3,), B - 1),
                                         n, leaf_type="linear").long()
    assert int((pred.clamp(max=n) - targets.clamp(max=n)).abs().max()) <= e_p[-1]
    guess, err = rt.lookup(rp, img[n - 1:])
    assert abs(int(guess) - (n - 1)) <= int(err) == e_p[-1]
