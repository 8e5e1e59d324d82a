"""The port's compile path against rmi_tpu's on the CPU: RMI_SIZE, the
artifact (rmi_data/ blobs and metadata JSON), the generated C++ and the
native server (rmi_tpu_torch.serialize, codegen, native).

  (a) rmi_size equals rmi_tpu's for every model name as top and as leaf
      where rmi_tpu allows it (the trained pairs below, histogram's
      data-dependent size included; every other pair and radix26/28 by
      predicted_rmi_size, whose size the shapes fix);
  (b) a JAX build carried across (trained_from_numpy with rmi_tpu's rows,
      the cubic fits' aux, the patch mask, next_idx and the metrics)
      writes byte-identical files to rmi_tpu.serialize.output_rmi, build
      time zeroed: the L0 and L1 blobs, the metadata JSON, .h, .cpp and
      _data.h, for u64 and u32 keys, with and without errors (a
      train_bounded index: tests/test_torch_cachefix.py).  radix26 and
      radix28 share the hint-table code of radix8/18/22; their 256 MB and
      1 GB tables are left to (a);
  (c) independent builds: raw leaf rows within the summation-order
      tolerance (their predictions at the keys within 1e-6 positions;
      a cubic clamped slope may differ by 2 ulps), raw tops equal, at
      most 3 leaf errors differing, each by 1;
  (d) an artifact rmi_tpu wrote loads into the port, whose lookup then
      equals rmi_tpu's on the same queries; the port's save -> load ->
      lookup round trip is bit-equal to the index it saved, and search
      over the loaded index is exact;
  (e) the generated C++ compiled with g++ and a main program shaped like
      the reference's integration harness (tests/test_codegen.py): the eight
      configurations of tests/test_codegen.py, u32 keys, the --no-errors
      signature; its lookup equals the port's and |guess - lb| <= err
      holds for every key (cachefix: tests/test_torch_cachefix.py);
  (f) the native server (the port's own build of native/rmi_native.cpp)
      over the port's artifacts equals the port's lookup, and its search
      is exact.
"""

import filecmp
import functools
import os
import shutil
import subprocess
import textwrap

import numpy as np
import jax.numpy as jnp
import pytest

import rmi_tpu
from rmi_tpu import keys as jkeys
from rmi_tpu import serialize as jser
from rmi_tpu.data import RMIDataset as JDataset
from rmi_tpu.models import get_model as j_get_model
from rmi_tpu.train import two_layer as j_two_layer

import rmi_tpu_torch as rt
from rmi_tpu_torch import keys as tkeys
from rmi_tpu_torch import native, serialize
from rmi_tpu_torch.models import get_model
from rmi_tpu_torch.models.base import REGISTRY

N = 4096
METRICS = ("model_max_error", "model_max_error_idx", "model_avg_error",
           "model_avg_l2_error", "model_avg_log2_error", "model_max_log2_error")
NAMES = sorted(REGISTRY)
TOPS = ("linear", "robust_linear", "linear_spline", "loglinear", "cubic", "normal",
        "lognormal", "radix", "bradix", "histogram", "radix8", "radix18", "radix22")
# every model name as top over linear leaves, every leaf-capable one as leaf
SPECS = ([(f"{top},linear", 16 if top == "histogram" else 32) for top in TOPS]
         + [(f"linear,{leaf}", 32) for leaf in ("robust_linear", "linear_spline",
                                                "loglinear", "cubic", "normal",
                                                "lognormal")]
         + [("cubic,radix8", 16), ("linear,radix18", 4)])
U32_SPECS = [("linear,linear", 32), ("cubic,linear", 64), ("radix,linear", 32)]
# tests/test_codegen.py's and tests/test_native.py's configurations
CPP_SPECS = [("linear,linear", 32), ("cubic,linear", 64), ("radix,linear", 32),
             ("bradix,linear", 32), ("histogram,linear", 16), ("radix8,linear", 16),
             ("loglinear,cubic", 16), ("normal,linear_spline", 16)]
NATIVE_SPECS = [("linear,linear", 32), ("cubic,linear", 64), ("radix,linear", 32),
                ("bradix,linear", 32), ("radix8,linear", 16), ("histogram,linear", 16),
                ("normal,cubic", 16), ("loglinear,lognormal", 16)]


@functools.lru_cache(maxsize=None)
def _keys(kind):
    """Sorted keys below 2^40 (where raw-domain C++ and the normalized
    card path agree, tests/test_native.py): exponential gaps with a run
    of 40 duplicates; u32 for "u32"."""
    rng = np.random.default_rng(11)
    c = np.cumsum(rng.exponential(size=N))
    keys = (c * (2.0 ** 39 / c[-1])).astype(np.uint64) + np.uint64(5)
    keys[1000:1040] = keys[1000]
    if kind == "u32":
        return (keys >> np.uint64(10)).astype(np.uint32)
    return keys


@functools.lru_cache(maxsize=None)
def _jax_build(kind, spec, B):
    rj = rmi_tpu.train(JDataset.from_numpy(_keys(kind)), spec, B)
    # what its raw conversion reads, before the first use consumes it
    rj.raw_inputs = rj.raw_thunk.__defaults__
    return rj


@functools.lru_cache(maxsize=None)
def _port_build(kind, spec, B):
    return rt.train(rt.RMIDataset.from_numpy(_keys(kind), device="cpu"), spec, B)


def carry(rj, keys):
    """rmi_tpu's build as a port index: its rows (or parameter dicts),
    the inputs of its raw conversion (the arguments of rmi_tpu's
    raw_thunk: the fits' aux, the patch mask and next_idx) and its
    metrics."""
    leaf_p, top_p, patch, next_idx = rj.raw_inputs
    top, leaf = rj.models.split(",")

    def params(p, name):
        if get_model(name).output_int:
            return {k: np.asarray(v) for k, v in j_two_layer._predict_params(p).items()}
        return np.asarray(p["w"])

    def aux(p):
        return None if "aux" not in p else {k: np.asarray(v) for k, v in p["aux"].items()}

    rc = rt.trained_from_numpy(
        rj.models, rj.branching_factor, tkeys.KeyType(rj.key_type.value), keys,
        params(top_p, top), params(leaf_p, leaf), np.asarray(rj.leaf_errors),
        rj.norm_offset, rj.norm_scale, device="cpu", top_aux=aux(top_p),
        leaf_aux=aux(leaf_p), patch=np.asarray(patch), next_idx=np.asarray(next_idx),
        metrics={m: getattr(rj, m) for m in METRICS})
    rc.build_time = rj.build_time
    rc.cache_fix, rc.num_data_rows = rj.cache_fix, rj.num_data_rows
    return rc


def assert_same_files(d1, d2):
    """Both output trees hold the same files with the same bytes."""
    def listing(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)
    assert listing(d1) == listing(d2)
    for f in listing(d1):
        assert filecmp.cmp(os.path.join(d1, f), os.path.join(d2, f), shallow=False), f


def _outputs(tmp_path, rj, rc, include_errors):
    d1, d2 = tmp_path / "rmi_tpu", tmp_path / "port"
    for d in (d1, d2):
        d.mkdir()
    rj.build_time = rc.build_time = 0
    jser.output_rmi("ns", rj, data_dir=str(d1 / "rmi_data"), cpp_dir=str(d1),
                    include_errors=include_errors)
    rt.output_rmi("ns", rc, data_dir=str(d2 / "rmi_data"), cpp_dir=str(d2),
                  include_errors=include_errors)
    return d1, d2


# --------------------------------------------------------------------------
# (a) RMI_SIZE
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec,B", SPECS)
def test_rmi_size_equals_rmi_tpu(spec, B):
    rj, rp = _jax_build("u64", spec, B), _port_build("u64", spec, B)
    assert rt.rmi_size(rp) == jser.rmi_size(rj)
    if not spec.startswith("histogram"):
        assert serialize.predicted_rmi_size(spec, B) == rt.rmi_size(rp)
        assert serialize.predicted_rmi_size(spec, B, with_errors=False) == \
            jser.predicted_rmi_size(spec, B, with_errors=False)


@pytest.mark.parametrize("top", NAMES)
def test_predicted_size_every_name(top):
    """Every name as top over each leaf-capable name: predicted_rmi_size
    and its errors as rmi_tpu's, histogram raising as there."""
    for leaf in (n for n in NAMES if j_get_model(n).leaf_capable):
        spec = f"{top},{leaf}"
        if top == "histogram":
            with pytest.raises(ValueError):
                serialize.predicted_rmi_size(spec, 64)
            continue
        for B in (1, 64, 262144):
            assert serialize.predicted_rmi_size(spec, B) == \
                jser.predicted_rmi_size(spec, B)
    assert get_model(top).bytes_per_model == j_get_model(top).bytes_per_model
    assert get_model(top).function_name == j_get_model(top).function_name
    assert get_model(top).needs_bounds_check == j_get_model(top).needs_bounds_check


# --------------------------------------------------------------------------
# (b) byte equality of a carried-across build
# --------------------------------------------------------------------------

@pytest.mark.parametrize("include_errors", [True, False])
@pytest.mark.parametrize("spec,B", SPECS)
def test_carried_build_writes_the_same_bytes(tmp_path, spec, B, include_errors):
    rj = _jax_build("u64", spec, B)
    assert_same_files(*_outputs(tmp_path, rj, carry(rj, _keys("u64")), include_errors))


@pytest.mark.parametrize("spec,B", U32_SPECS)
def test_carried_build_writes_the_same_bytes_u32(tmp_path, spec, B):
    rj = _jax_build("u32", spec, B)
    rc = carry(rj, _keys("u32"))
    assert rc.key_type is tkeys.KeyType.U32
    d1, d2 = _outputs(tmp_path, rj, rc, True)
    assert "uint32_t key" in (d2 / "ns.h").read_text()
    assert_same_files(d1, d2)


def test_cubic_raw_needs_the_aux():
    rj = _jax_build("u64", "cubic,linear", 32)
    rc = carry(rj, _keys("u64"))
    rc.raw_inputs = dict(rc.raw_inputs, top_aux=None)
    with pytest.raises(ValueError, match="top_aux"):
        rc.raw_top


# --------------------------------------------------------------------------
# (c) independent builds
# --------------------------------------------------------------------------

def _raw_predict(leaf_type, w, x):
    """Raw-domain predictions of leaf rows w at the raw key float x
    (numpy): the cubic, or the affine part alpha + beta x of the linear
    family (loglinear's exponent)."""
    if leaf_type == "cubic":
        return ((w[:, 0] * x + w[:, 1]) * x + w[:, 2]) * x + w[:, 3]
    return w[:, 0] + w[:, 1] * x


@pytest.mark.parametrize("spec,B", SPECS)
def test_independent_builds_raw_params(spec, B):
    rj, rp = _jax_build("u64", spec, B), _port_build("u64", spec, B)
    top, leaf = spec.split(",")
    assert rt.rmi_size(rp) == jser.rmi_size(rj)
    e_p, e_j = rp.host_leaf_errors.astype(np.int64), np.asarray(rj.leaf_errors, np.int64)
    d = np.abs(e_p - e_j)
    assert np.count_nonzero(d) <= 3 and d.max(initial=0) <= 1
    for want, got in ((rj.top_params, rp.raw_top),):
        assert want.keys() == got.keys()
        for k in got:
            np.testing.assert_allclose(np.asarray(got[k], np.float64).reshape(-1),
                                       np.asarray(want[k], np.float64).reshape(-1),
                                       rtol=1e-12, atol=0)
    if isinstance(rp.raw_leaf, dict):
        for k in rp.raw_leaf:
            np.testing.assert_array_equal(rp.raw_leaf[k], np.asarray(rj.leaf_params[k]))
        return
    wj, wp = np.asarray(rj.leaf_params), rp.raw_leaf
    if leaf in ("normal", "lognormal"):      # (mean, stdev, scale) rows
        np.testing.assert_allclose(wp, wj, rtol=1e-9, atol=0, equal_nan=True)
        return
    # the raw rows' predictions at keys across the range, within 1e-6
    # positions (summation order moves a row by ulps)
    x = jkeys.as_float(jnp.asarray(_keys("u64")))
    x = np.asarray(x)[np.linspace(0, N - 1, 64).astype(int)]
    for xi in x:
        pj, pp = _raw_predict(leaf, wj, xi), _raw_predict(leaf, wp, xi)
        fin = np.isfinite(pj)
        np.testing.assert_array_equal(fin, np.isfinite(pp))
        assert np.all(np.abs(pj[fin] - pp[fin]) <= 1e-6 * np.maximum(1.0, np.abs(pj[fin])))


# --------------------------------------------------------------------------
# (d) load_artifact
# --------------------------------------------------------------------------

def _queries(keys, n=3000):
    rng = np.random.default_rng(3)
    q = rng.integers(0, int(keys[-1]) + 1000, n, dtype=np.uint64)
    return np.concatenate([keys[::7], q, keys[[0, -1]], np.array([0], np.uint64)])


@pytest.mark.parametrize("spec,B", SPECS)
def test_rmi_tpu_artifact_loads_into_the_port(tmp_path, spec, B):
    rj = _jax_build("u64", spec, B)
    keys = _keys("u64")
    meta = jser.save_artifact(rj, "t", data_dir=str(tmp_path))
    loaded = rt.load_artifact(meta, keys=tkeys.to_image(keys), device="cpu")
    q = _queries(keys)
    gj, ej = rmi_tpu.lookup(jser.load_artifact(meta), jnp.asarray(q))
    gp, ep = rt.lookup(loaded, tkeys.to_image(q))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(ep.numpy(), np.asarray(ej))
    assert rt.rmi_size(loaded) == jser.rmi_size(rj)
    # loaded without its keys, it searches the keys it is given
    bare = rt.load_artifact(meta, device="cpu")
    assert bare.keys is None
    np.testing.assert_array_equal(
        rt.search(bare, tkeys.to_image(q), keys=tkeys.to_image(keys)).numpy(),
        np.searchsorted(keys, q))


def leaf_ids(rmi, q):
    from rmi_tpu_torch.train import two_layer
    return two_layer.top_assignment(get_model(rmi.top_type), rmi.device_top_params, q,
                                    rmi.norm_offset, rmi.norm_scale,
                                    rmi.branching_factor - 1).numpy()


@pytest.mark.parametrize("spec,B", SPECS)
def test_port_round_trip(tmp_path, spec, B):
    """save -> load -> lookup: bit-equal to rmi_tpu's load of the same
    files, and to the saved index wherever the loaded top sends the query
    to the same leaf.  The raw parameters convert back to the normalized
    domain within an ulp, so a query on a leaf boundary (the last key
    under a top whose prediction there is an integer) may move to the
    next leaf, in rmi_tpu's round trip as in the port's."""
    rp = _port_build("u64", spec, B)
    keys = _keys("u64")
    meta = rt.output_rmi("t", rp, data_dir=str(tmp_path / "rmi_data"),
                         cpp_dir=str(tmp_path))
    loaded = rt.load_artifact(meta, keys=rp.keys, device="cpu")
    qn = _queries(keys)
    q = tkeys.to_image(qn)
    g1, e1 = rt.lookup(rp, q)
    g2, e2 = rt.lookup(loaded, q)
    gj, ej = rmi_tpu.lookup(jser.load_artifact(meta), jnp.asarray(qn))
    np.testing.assert_array_equal(g2.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(e2.numpy(), np.asarray(ej))
    same_leaf = leaf_ids(rp, q) == leaf_ids(loaded, q)
    assert same_leaf.mean() > 0.99
    np.testing.assert_array_equal(g2.numpy()[same_leaf], g1.numpy()[same_leaf])
    np.testing.assert_array_equal(e2.numpy()[same_leaf], e1.numpy()[same_leaf])
    lb = np.searchsorted(keys, qn)
    np.testing.assert_array_equal(rt.search(loaded, q).numpy(), lb)
    g3, e3, i3 = rt.lookup_and_search(loaded, q)
    assert g3.equal(g2) and e3.equal(e2)
    np.testing.assert_array_equal(i3.numpy(), lb)
    # the loaded index writes what was loaded
    d2 = tmp_path / "again"
    rt.output_rmi("t", loaded, data_dir=str(d2 / "rmi_data"), cpp_dir=str(d2))
    for f in os.listdir(tmp_path / "rmi_data"):
        assert filecmp.cmp(tmp_path / "rmi_data" / f, d2 / "rmi_data" / f, shallow=False)


def test_artifact_without_errors(tmp_path):
    rp = _port_build("u64", "linear,linear", 32)
    meta = rt.output_rmi("ne", rp, data_dir=str(tmp_path), include_errors=False,
                         emit_cpp=False)
    loaded = rt.load_artifact(meta, device="cpu")
    assert loaded.leaf_errors is None
    assert rt.rmi_size(loaded) == rt.rmi_size(rp) - 8 * 32
    q = tkeys.to_image(_queries(_keys("u64")))
    g, e = rt.lookup(loaded, q)
    np.testing.assert_array_equal(g.numpy(), rt.lookup(rp, q)[0].numpy())
    assert not e.any()


# --------------------------------------------------------------------------
# (e) generated C++
# --------------------------------------------------------------------------

HARNESS = textwrap.dedent("""
    #include "{ns}.h"
    #include <cstdio>
    #include <cstdint>
    #include <vector>

    int main(int argc, char** argv) {{
      // argv: data_dir keys_file out_file
      if (!{ns}::load(argv[1])) {{ printf("LOAD FAIL\\n"); return 2; }}
      FILE* f = fopen(argv[2], "rb");
      uint64_t n; if (fread(&n, 8, 1, f) != 1) return 3;
      std::vector<{key_c}> keys(n);
      if (fread(keys.data(), sizeof({key_c}), n, f) != n) return 3;
      fclose(f);
      FILE* out = fopen(argv[3], "wb");
      for (uint64_t i = 0; i < n; i++) {{
        size_t err = 0;
        uint64_t guess = {ns}::lookup(keys[i]{err_arg});
        uint64_t e64 = err;
        fwrite(&guess, 8, 1, out);
        fwrite(&e64, 8, 1, out);
      }}
      fclose(out);
      {ns}::cleanup();
      printf("RMI_SIZE=%zu\\n", {ns}::RMI_SIZE);
      return 0;
    }}
""")


def compile_and_run(workdir, rmi, ns, keys, include_errors=True):
    """Emit the artifact and C++ into ``workdir``, build it with g++ -O2
    and the harness above, run it over ``keys``; (guess, err, RMI_SIZE)."""
    os.makedirs(workdir, exist_ok=True)
    data_dir = os.path.join(workdir, "rmi_data")
    rt.output_rmi(ns, rmi, data_dir=data_dir, cpp_dir=workdir,
                  include_errors=include_errors)
    key_c = "uint64_t" if rmi.cache_fix is not None else rmi.key_type.c_type
    err_arg = ", &err" if include_errors or rmi.cache_fix is not None else ""
    with open(os.path.join(workdir, "harness.cpp"), "w") as f:
        f.write(HARNESS.format(ns=ns, key_c=key_c, err_arg=err_arg))
    exe = os.path.join(workdir, "harness")
    subprocess.run([shutil.which("g++") or "g++", "-O2", "-std=c++17", "-o", exe,
                    os.path.join(workdir, "harness.cpp"),
                    os.path.join(workdir, f"{ns}.cpp"), "-I", workdir],
                   check=True, capture_output=True)
    kf, of = os.path.join(workdir, "keys.bin"), os.path.join(workdir, "out.bin")
    rt.write_sosd_file(kf, keys)
    r = subprocess.run([exe, data_dir, kf, of], check=True, capture_output=True,
                       text=True)
    raw = np.fromfile(of, dtype="<u8").reshape(-1, 2)
    size = int(next(ln for ln in r.stdout.splitlines() if "RMI_SIZE" in ln).split("=")[1])
    return raw[:, 0].astype(np.int64), raw[:, 1].astype(np.int64), size


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """One g++ build and run per configuration in this module."""
    runs = {}

    def get(kind, spec, B, include_errors=True):
        key = (kind, spec, B, include_errors)
        if key not in runs:
            rp = _port_build(kind, spec, B)
            ns = "g" + spec.replace(",", "_") + ("" if include_errors else "_ne")
            runs[key] = (rp, compile_and_run(str(tmp_path_factory.mktemp(ns)), rp, ns,
                                             _keys(kind), include_errors))
        return runs[key]
    return get


@pytest.mark.parametrize("spec,B", CPP_SPECS)
def test_generated_cpp_matches_the_port(compiled, spec, B):
    rp, (cg, ce, csize) = compiled("u64", spec, B)
    keys = _keys("u64")
    g, e = rt.lookup(rp, tkeys.to_image(keys))
    np.testing.assert_array_equal(cg, g.numpy())
    np.testing.assert_array_equal(ce, e.numpy())
    assert csize == rt.rmi_size(rp)


@pytest.mark.parametrize("spec,B", CPP_SPECS)
def test_generated_cpp_bound_on_every_key(compiled, spec, B):
    _, (cg, ce, _) = compiled("u64", spec, B)
    keys = _keys("u64")
    assert (np.abs(cg - np.searchsorted(keys, keys)) <= ce).all()


def test_generated_cpp_u32(compiled):
    rp, (cg, ce, _) = compiled("u32", "linear,linear", 32)
    keys = _keys("u32")
    g, e = rt.lookup(rp, tkeys.to_image(keys))
    np.testing.assert_array_equal(cg, g.numpy())
    assert (np.abs(cg - np.searchsorted(keys, keys)) <= ce).all()


def test_no_errors_signature(compiled, tmp_path):
    """--no-errors changes the lookup signature (README.md:66-70), and the
    compiled lookup still gives the same guesses."""
    rp, (cg, ce, csize) = compiled("u64", "linear,linear", 32, include_errors=False)
    rt.output_rmi("gne", rp, data_dir=str(tmp_path / "rmi_data"), cpp_dir=str(tmp_path),
                  include_errors=False)
    hdr = (tmp_path / "gne.h").read_text()
    assert "uint64_t lookup(uint64_t key);" in hdr
    assert "size_t* err" not in hdr
    np.testing.assert_array_equal(cg, rt.lookup(rp, rp.keys)[0].numpy())
    assert csize == rt.rmi_size(rp) - 8 * 32


# --------------------------------------------------------------------------
# (f) the native server
# --------------------------------------------------------------------------

def test_native_library_builds_here():
    path = native.build()
    assert path.startswith(str(rt.config.BUILD_DIR)) and os.path.exists(path)
    assert native.library_path() == path
    assert native.load() is native.load()


@pytest.mark.parametrize("spec,B", NATIVE_SPECS)
def test_native_server_matches_the_port(tmp_path, spec, B):
    rp = _port_build("u64", spec, B)
    keys = _keys("u64")
    meta = rt.output_rmi("nat", rp, data_dir=str(tmp_path), emit_cpp=False)
    q = _queries(keys)
    with native.NativeRMI(meta) as srv:
        ng, ne = srv.lookup(q)
        g, e = rt.lookup(rp, tkeys.to_image(q))
        np.testing.assert_array_equal(ng.astype(np.int64), g.numpy())
        np.testing.assert_array_equal(ne.astype(np.int64), e.numpy())
        np.testing.assert_array_equal(srv.search(q, keys), np.searchsorted(keys, q))
