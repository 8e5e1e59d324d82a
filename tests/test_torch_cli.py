"""The port's CLI against rmi_tpu's on one SOSD file on the CPU:
``rmi_tpu_torch.cli.main([...], device="cpu")`` and
``rmi_tpu.cli.main([...])``, each in its own working directory.

The configurations are ones whose fits hold no floating-point sum (a
cubic or linear_spline top over linear_spline leaves; the cubic top's
sums follow XLA's order), so the two independent builds are bit-equal
and so are the files: the rmi_data/ blobs, .h, .cpp and _data.h byte for
byte, ll_errors.json and ll_model_data_*.json too.  The JSON files
(stats, metadata, the param grid's results) hold the same keys and
integers, and floats within 1e-7 relative (the average errors are sums
in each package's order).  Covered: namespace mode with --stats-file and
--zero-build-time, --no-code, --no-errors, --bounded 8, --param-grid
(its _results file, --disable-parallel-training), --dump-ll-errors and
--dump-ll-model-data; the module entry point defaults to the card.

The optimizer's flags run on OPT_N keys (tests/test_torch_optimizer.py's
draw) under the fast profile over OPT_BFS (patched in both packages),
rmi_tpu under RMI_OPT_BUCKETED=0, its per-build sweep, which the port's
sweep is: --optimize writes the same configs file (layers, branching
factor, namespace, size and binary equal, the average log2 error within
1e-7 relative) and prints the same table; --max-size picks rmi_tpu's
configuration and writes an artifact of the same RMI_SIZE, or raises
rmi_tpu's error when nothing fits; --param-grid over the device pool
writes the _results file and artifacts of the sequential run.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import rmi_tpu.cli as j_cli
import rmi_tpu.optimizer as j_opt
from rmi_tpu_torch import cli, write_sosd_file
from rmi_tpu_torch import optimizer as t_opt

N = 6000
OPT_N = 5000
OPT_BFS = [16, 64, 256, 1024]


@pytest.fixture(scope="module")
def sosd_file(tmp_path_factory):
    rng = np.random.default_rng(31)
    keys = np.sort(rng.integers(0, 2 ** 40, size=N, dtype=np.uint64))
    keys[2000:2050] = keys[2000]
    path = str(tmp_path_factory.mktemp("data") / f"keys_{N}_uint64")
    write_sosd_file(path, keys)
    return path


@pytest.fixture(scope="module")
def opt_file(tmp_path_factory):
    rng = np.random.default_rng(2024)
    keys = np.sort(rng.integers(0, 2 ** 40, size=OPT_N, dtype=np.uint64))
    keys[1000:1040] = keys[1000]
    path = str(tmp_path_factory.mktemp("opt") / f"opt_{OPT_N}_uint64")
    write_sosd_file(path, keys)
    return path


@pytest.fixture
def small_grid(monkeypatch):
    """The fast profile over OPT_BFS in both packages; rmi_tpu's per-build
    sweep."""
    monkeypatch.setenv("RMI_OPTIMIZER_PROFILE", "fast")
    monkeypatch.setenv("RMI_OPT_BUCKETED", "0")
    for mod in (j_opt, t_opt):
        monkeypatch.setattr(mod, "branching_factors", lambda: list(OPT_BFS))


def run_both(tmp_path, monkeypatch, argv):
    """Run both CLIs on ``argv`` in tmp_path/rmi_tpu and tmp_path/port;
    returns the two directories and the exit codes."""
    out = []
    for name, main in (("rmi_tpu", j_cli.main),
                       ("port", lambda a: cli.main(a, device="cpu"))):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        out.append((d, main(list(argv))))
    return out


def _close(a, b, path):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert b == pytest.approx(a, rel=1e-7, abs=0), path
    else:
        assert a == b, path


def assert_same_outputs(d1, d2):
    """The same files; JSON files equal up to their floats, all others
    byte for byte."""
    def listing(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)
    assert listing(d1) == listing(d2)
    for f in listing(d1):
        a, b = (d1 / f).read_bytes(), (d2 / f).read_bytes()
        if f.endswith(".json") or f.endswith("_results"):
            _close(json.loads(a), json.loads(b), f)
        else:
            assert a == b, f
    return listing(d1)


@pytest.mark.parametrize("spec,B", [("cubic,linear_spline", 64),
                                    ("linear_spline,linear_spline", 32)])
def test_namespace_mode(tmp_path, monkeypatch, sosd_file, spec, B):
    (d1, r1), (d2, r2) = run_both(tmp_path, monkeypatch, [
        sosd_file, "myrmi", spec, str(B), "--stats-file", "stats.json",
        "--dump-ll-errors", "--dump-ll-model-data", "3", "--zero-build-time"])
    assert r1 == r2 == 0
    files = assert_same_outputs(d1, d2)
    assert {"myrmi.cpp", "myrmi.h", "myrmi_data.h", "stats.json", "ll_errors.json",
            "ll_model_data_3.json", "rmi_data/myrmi.json",
            "rmi_data/myrmi_L1_PARAMETERS"} <= set(files)
    assert (d2 / "ll_errors.json").read_bytes() == (d1 / "ll_errors.json").read_bytes()
    stats = json.loads((d2 / "stats.json").read_text())
    assert stats["layers"] == spec and stats["branching factor"] == B
    assert "BUILD_TIME_NS = 0;" in (d2 / "myrmi.h").read_text()
    assert len(json.loads((d2 / "ll_model_data_3.json").read_text())["keys"]) > 0


def test_no_code(tmp_path, monkeypatch, sosd_file):
    (d1, r1), (d2, r2) = run_both(tmp_path, monkeypatch, [
        sosd_file, "nc", "cubic,linear_spline", "64", "--no-code"])
    assert r1 == r2 == 0
    assert assert_same_outputs(d1, d2) == []
    assert (d2 / "rmi_data").is_dir()


def test_no_errors(tmp_path, monkeypatch, sosd_file):
    (d1, r1), (d2, r2) = run_both(tmp_path, monkeypatch, [
        sosd_file, "ne", "cubic,linear_spline", "64", "--no-errors",
        "--zero-build-time", "--data-path", "out"])
    assert r1 == r2 == 0
    assert "out/ne_L1_PARAMETERS" in assert_same_outputs(d1, d2)
    assert "uint64_t lookup(uint64_t key);" in (d2 / "ne.h").read_text()


def test_bounded(tmp_path, monkeypatch, sosd_file):
    (d1, r1), (d2, r2) = run_both(tmp_path, monkeypatch, [
        sosd_file, "cfw", "linear_spline,linear_spline", "64", "--bounded", "8",
        "--stats-file", "stats.json", "--zero-build-time", "--threads", "2"])
    assert r1 == r2 == 0
    assert "rmi_data/cfw_L2_PARAMETERS" in assert_same_outputs(d1, d2)
    meta = json.loads((d2 / "rmi_data" / "cfw.json").read_text())
    stats = json.loads((d2 / "stats.json").read_text())
    assert stats["size binary search"] == \
        16 + 24 * 64 + 16 * meta["cache_fix"]["num_points"]
    assert meta["num_data_rows"] == N


def test_param_grid(tmp_path, monkeypatch, sosd_file):
    grid = {"configs": [
        {"layers": "cubic,linear_spline", "branching factor": 32, "namespace": "ga"},
        {"layers": "linear_spline,linear_spline", "branching factor": 16,
         "namespace": "gb"},
        {"layers": "linear,linear", "branching factor": 8}]}
    gp = tmp_path / "grid.json"
    gp.write_text(json.dumps(grid))
    (d1, r1), (d2, r2) = run_both(tmp_path, monkeypatch, [
        sosd_file, "--param-grid", str(gp), "--zero-build-time",
        "--disable-parallel-training"])
    assert r1 == r2 == 0
    # the _results file lies beside the grid: the port's run, the second,
    # wrote the one read here (test_param_grid_results_equal compares both)
    assert {"ga.cpp", "gb.cpp", "rmi_data/ga.json", "rmi_data/gb.json"} <= \
        set(assert_same_outputs(d1, d2))
    results = json.loads((tmp_path / "grid.json_results").read_text())["results"]
    assert [r["namespace"] for r in results] == ["ga", "gb", None]


def test_param_grid_results_equal(tmp_path, monkeypatch, sosd_file):
    """The _results files of both CLIs, each beside its own copy of the grid."""
    grid = {"configs": [{"layers": "cubic,linear_spline", "branching factor": 32},
                        {"layers": "linear,linear", "branching factor": 8}]}
    results = []
    for name, main in (("rmi_tpu", j_cli.main),
                       ("port", lambda a: cli.main(a, device="cpu"))):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        (d / "grid.json").write_text(json.dumps(grid))
        assert main([sosd_file, "--param-grid", "grid.json", "--zero-build-time",
                     "--disable-parallel-training"]) == 0
        results.append(json.loads((d / "grid.json_results").read_text()))
    _close(results[0], results[1], "results")


@pytest.mark.parametrize("namespace", [[], ["front"]])
def test_optimize_writes_rmi_tpus_configs(tmp_path, monkeypatch, capsys, opt_file,
                                          small_grid, namespace):
    """The configs file and the printed table; the prefix is the namespace
    or the input's file name."""
    configs, tables = [], []
    for name, main in (("rmi_tpu", j_cli.main),
                       ("port", lambda a: cli.main(a, device="cpu"))):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        capsys.readouterr()
        assert main([opt_file, *namespace, "--optimize", "out.json"]) == 0
        tables.append(capsys.readouterr().out)
        configs.append(json.loads((d / "out.json").read_text())["configs"])
        assert os.listdir(d) == ["out.json"]
    want, got = configs
    assert len(want) >= 3
    exact = ("layers", "branching factor", "namespace", "size", "binary")
    assert [[c[k] for k in exact] for c in got] == [[c[k] for k in exact] for c in want]
    prefix = namespace[0] if namespace else os.path.basename(opt_file)
    assert [c["namespace"] for c in got] == [f"{prefix}_{i}" for i in range(len(got))]
    for a, b in zip(got, want):
        assert a["average log2 error"] == pytest.approx(b["average log2 error"],
                                                        rel=1e-7, abs=0)
    assert tables[1] == tables[0] and tables[1].startswith("Models")


@pytest.mark.parametrize("budget", [10 ** 8, 10000])
def test_max_size_picks_rmi_tpus_config(tmp_path, monkeypatch, opt_file, small_grid,
                                        budget):
    (d1, r1), (d2, r2) = run_both(tmp_path, monkeypatch, [
        opt_file, "sized", "--max-size", str(budget), "--stats-file", "stats.json",
        "--zero-build-time"])
    assert r1 == r2 == 0
    want, got = (json.loads((d / "stats.json").read_text()) for d in (d1, d2))
    assert (got["layers"], got["branching factor"], got["size binary search"]) == \
        (want["layers"], want["branching factor"], want["size binary search"])
    assert got["size binary search"] < budget
    metas = [json.loads((d / "rmi_data" / "sized.json").read_text()) for d in (d1, d2)]
    assert metas[1]["rmi_size"] == metas[0]["rmi_size"] == got["size binary search"]
    assert sorted(os.listdir(d2)) == sorted(os.listdir(d1))


def test_max_size_too_small_raises_as_rmi_tpu(tmp_path, monkeypatch, opt_file,
                                              small_grid):
    monkeypatch.chdir(tmp_path)
    msg = "Could not find any configurations smaller than 1000"
    with pytest.raises(RuntimeError, match=msg):
        j_cli.main([opt_file, "tiny", "--max-size", "1000"])
    with pytest.raises(RuntimeError, match=msg):
        cli.main([opt_file, "tiny", "--max-size", "1000"], device="cpu")


def test_param_grid_parallel_equals_sequential(tmp_path, monkeypatch, sosd_file):
    """--param-grid through the device pool (parallel/sweep.py) writes the
    sequential run's _results file and artifacts, byte for byte."""
    grid = {"configs": [
        {"layers": "cubic,linear", "branching factor": 64, "namespace": "pa"},
        {"layers": "linear,linear_spline", "branching factor": 16},
        {"layers": "radix18,cubic", "branching factor": 32, "namespace": "pc"}]}
    dirs = []
    for flags in ([], ["--disable-parallel-training"]):
        d = tmp_path / ("sequential" if flags else "pool")
        d.mkdir()
        monkeypatch.chdir(d)
        (d / "grid.json").write_text(json.dumps(grid))
        assert cli.main([sosd_file, "--param-grid", "grid.json", "--zero-build-time",
                         *flags], device="cpu") == 0
        dirs.append(d)
    files = os.listdir(dirs[0])
    assert {"grid.json_results", "pa.cpp", "pc.cpp", "rmi_data"} <= set(files)
    for r, _, fs in os.walk(dirs[0]):
        for f in fs:
            a = os.path.join(r, f)
            b = os.path.join(dirs[1], os.path.relpath(a, dirs[0]))
            assert open(a, "rb").read() == open(b, "rb").read(), f


def test_usage_errors(tmp_path, monkeypatch, sosd_file):
    monkeypatch.chdir(tmp_path)
    assert cli.main([sosd_file, "ns", "--param-grid", "g.json"], device="cpu") == 1
    assert cli.main([sosd_file], device="cpu") == 1
    assert cli.main([sosd_file, "ns"], device="cpu") == 1


def test_module_entry_point_needs_the_card(tmp_path, sosd_file):
    """python -m rmi_tpu_torch trains on the card: without one it fails."""
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(__file__)))
    r = subprocess.run([sys.executable, "-m", "rmi_tpu_torch", sosd_file, "ns",
                        "linear,linear", "8"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
