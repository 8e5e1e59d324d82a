"""One of SOSD_SYNTH.json's configurations, both packages on the CPU:
rmi_tpu (JAX) and rmi_tpu_torch build it on the same synthetic keys.

    python3 tools/witness_sosd.py [--config max_size_wiki] [--n 200000000]
        [--seed 7] [--cap-gib 40] [--phases keys,top-port,top-ref,build-port,build-ref]

SOSD_SYNTH.json's rows are rmi_tpu's builds on a TPU (df64 arithmetic) on
synthetic_dataset("wiki" | "osm", 200M, seed=7).  Where the port's max_err
differs from a row's, this tool asks rmi_tpu's own CPU build (IEEE f64,
the reference run) how its top routes the keys and what its leaves err.
``--config`` names the row (CONFIGS: tests/test_sosd.py's five
configurations with flags, and max_size_wiki as the optimizer chose it,
``linear,linear 1048576``).  A cachefix (--bounded) configuration builds
with train_bounded in both packages, and its top and leaves are the RMI's
over the spline's knots.

Phases, each in a process of its own, in this order:
  keys        each package's synthetic_dataset of the row's kind, asserted
              equal, saved to .data/witness_<kind>_<n>_<seed>.npy (reused
              when present);
  top-port    the port's top fit (stage A) and leaf assignment;
  top-ref     rmi_tpu's (its jitted stage A, as RMI_BUILD_STAGED=1 runs it);
              neither top phase runs for a cachefix configuration;
  build-port  rmi_tpu_torch.train (train_bounded) on the CPU;
  build-ref   rmi_tpu.train (train_bounded; its default whole-build program).
A top phase reports the top's parameters and the keys routed to the final
leaf; a build phase max_err with its leaf and the keys routed there, the
final leaf's key count and error, and avg_log2, and the two builds' leaf
errors are compared leaf by leaf.
Each phase's peak resident memory is read from /proc while
it runs; a phase that passes --cap-gib is killed and reported with the
peak it reached.  Runs outside the tests (minutes and tens of GB at 200M
keys).  Prints one JSON line a phase, then one with all of them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("keys", "top-port", "top-ref", "build-port", "build-ref")
# config -> (key kind, top, leaf, branching factor, --bounded line or None)
CONFIGS = {"max_size_wiki": ("wiki", "linear", "linear", 1048576, None),
           "simple_model_wiki": ("wiki", "cubic", "linear", 262144, None),
           "simple_model_osm": ("osm", "robust_linear", "linear", 262144, None),
           "radix_model_wiki": ("wiki", "radix", "linear", 1024, None),
           "cache_fix_wiki": ("wiki", "linear_spline", "linear", 4194304, 8),
           "cache_fix_osm": ("osm", "cubic", "linear", 786432, 8)}
CONFIG, CONFIG_NAME = CONFIGS["max_size_wiki"], "max_size_wiki"


def keys_path(n: int, seed: int) -> str:
    return os.path.join(REPO, ".data", f"witness_{CONFIG[0]}_{n}_{seed}.npy")


def _jax():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    return jax


def phase_keys(n, B, seed):
    import numpy as np
    path = keys_path(n, seed)
    if os.path.exists(path):
        return {"path": path, "reused": True}
    kind = CONFIG[0]
    from rmi_tpu_torch.data import synthetic_dataset as t_synth
    from rmi_tpu_torch.keys import KeyType
    t_keys = t_synth(kind, n, KeyType.U64, seed=seed)
    _jax()
    from rmi_tpu.data import synthetic_dataset as j_synth
    from rmi_tpu.keys import KeyType as JKeyType
    j_keys = j_synth(kind, n, JKeyType.U64, seed=seed)
    if not np.array_equal(t_keys, j_keys):
        raise RuntimeError(f"the two packages' {kind} keys differ")
    del j_keys
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, t_keys)
    return {"path": path, "reused": False, "equal": True, "first": int(t_keys[0]),
            "last": int(t_keys[-1]), "duplicates": int(np.count_nonzero(t_keys[1:] == t_keys[:-1]))}


def _routing(t, B):
    """Keys routed to the final leaf and the first of them (-1 if none)."""
    import numpy as np
    t = np.asarray(t)
    last = np.flatnonzero(t == B - 1)
    return {"final_leaf_keys": int(last.size),
            "first_key_in_final_leaf": int(last[0]) if last.size else -1,
            "keys_in_last_4_leaves": np.bincount(t[t >= B - 4] - (B - 4),
                                                 minlength=4).tolist()}


def _row(w):
    """A top's parameters: a float row's values and their hex (for a
    linear top alpha, beta in the normalized key domain, which both
    packages share), or an integer model's parameters by name."""
    import numpy as np
    if isinstance(w, dict):
        return {k: np.asarray(v).reshape(-1)[:8].tolist() for k, v in w.items()}
    row = [float(v) for v in np.asarray(w, dtype=np.float64).reshape(-1)]
    return {"row": row, "row_hex": [v.hex() for v in row]}


def phase_top_port(n, B, seed):
    import numpy as np
    from rmi_tpu_torch.data import RMIDataset
    from rmi_tpu_torch.keys import KeyType
    from rmi_tpu_torch.models import get_model
    from rmi_tpu_torch.train import two_layer
    keys = RMIDataset.from_numpy(np.load(keys_path(n, seed)), device="cpu").keys
    kminf, s = two_layer.norm_constants(keys, KeyType.U64)
    top_in = two_layer.model_float_input(get_model(CONFIG[1]), keys, kminf, s, KeyType.U64)
    yfix = two_layer.fixdups_i32(keys)
    top_w, t, _ = two_layer._assign_body(top_in, yfix, top_type=CONFIG[1], B=B, keys=keys)
    return {"norm": [kminf, s], "top": _row(top_w), **_routing(t.numpy(), B)}


def phase_top_ref(n, B, seed):
    import numpy as np
    _jax()
    import jax.numpy as jnp
    from rmi_tpu.data import RMIDataset
    from rmi_tpu.keys import KeyType as JKeyType
    from rmi_tpu.train import two_layer
    keys = RMIDataset.from_numpy(np.load(keys_path(n, seed))).keys
    kminf, s = two_layer.norm_constants(keys, JKeyType.U64)
    _, top_p, t = two_layer._stage_assign(keys, jnp.float64(kminf), jnp.float64(s),
                                          top_type=CONFIG[1], B=B, key_type=JKeyType.U64)
    return {"norm": [kminf, s], "top": _row(top_p.get("w", top_p)), **_routing(t, B)}


def leaves_path(name: str, n: int, seed: int) -> str:
    return os.path.join(REPO, ".data", f"witness_{CONFIG_NAME}_{name}_{n}_{seed}.npz")


def _build_summary(name, n, seed, r, errors, counts, B):
    """The build's metrics; its leaf errors and key counts saved for compare()."""
    import numpy as np
    np.savez(leaves_path(name, n, seed), errors=errors.astype(np.int64), counts=counts)
    L = int(r.model_max_error_idx)
    out = {"max_err": int(r.model_max_error), "max_err_leaf": L,
           "max_err_leaf_keys": int(counts[L]), "avg_log2": float(r.model_avg_log2_error),
           "final_leaf_error": int(errors[B - 1]), "final_leaf_keys": int(counts[B - 1])}
    if CONFIG[4]:
        out["knots"] = int(len(r.cache_fix[1]))
    return out


def compare(n, seed, B):
    """Leaf errors of the two builds: how many differ, by how much, and the
    avg_log2 gap they explain, each build's leaves with its own key counts
    over the keys its RMI serves (a cachefix index's: the knots)."""
    import numpy as np
    p, j = (np.load(leaves_path(name, n, seed)) for name in ("build-port", "build-ref"))
    ep, ej, cp, cj = p["errors"], j["errors"], p["counts"], j["counts"]
    diff = ep != ej
    moved = diff | (cp != cj)
    explained = float(np.sum((cp * np.log2(2.0 * ep + 2.0) - cj * np.log2(2.0 * ej + 2.0))
                             [moved]) / cp.sum())
    return {"leaves_differing": int(diff.sum()),
            "max_abs_diff": int(np.abs(ep - ej).max()) if diff.any() else 0,
            "port_minus_ref_on_them": np.bincount((ep - ej)[diff] + 2, minlength=5).tolist(),
            "key_counts_equal": bool(np.array_equal(cp, cj)),
            "leaves_counted_otherwise": np.flatnonzero(cp != cj)[:10].tolist(),
            "avg_log2_gap_explained": explained,
            "first_differing_leaves": np.flatnonzero(diff)[:10].tolist()}


def phase_build_port(n, B, seed):
    import numpy as np
    import rmi_tpu_torch as rt
    from rmi_tpu_torch.models import get_model
    from rmi_tpu_torch.train import two_layer
    data = rt.RMIDataset.from_numpy(np.load(keys_path(n, seed)), device="cpu")
    spec, line = ",".join(CONFIG[1:3]), CONFIG[4]
    r = rt.train_bounded(data, spec, B, line) if line else rt.train(data, spec, B)
    # a cachefix index's RMI serves over its knots, which r.keys holds
    t = two_layer.top_assignment(get_model(r.top_type), r.device_top_params, r.keys,
                                 r.norm_offset, r.norm_scale, B - 1, r.key_type)
    counts = np.bincount(t.numpy(), minlength=B)
    return {"top": _row(r.device_top_params),
            **_build_summary("build-port", n, seed, r, r.leaf_errors.numpy(), counts, B)}


def phase_build_ref(n, B, seed):
    import numpy as np
    jax = _jax()
    from rmi_tpu.data import RMIDataset
    from rmi_tpu.models import get_model
    from rmi_tpu.train import two_layer
    from rmi_tpu.train.api import train, train_bounded
    data = RMIDataset.from_numpy(np.load(keys_path(n, seed)))
    spec, line = ",".join(CONFIG[1:3]), CONFIG[4]
    if line:
        r = train_bounded(data, spec, B, line)
        data = RMIDataset.from_numpy(r.cache_fix[1])      # the RMI's keys: the knots
    else:
        r = train(data, spec, B)
    mtop = get_model(r.top_type)
    kminf, s = r.norm_offset, r.norm_scale

    def leaf_ids(k):
        xraw = two_layer.keymod.as_float(k)
        return two_layer.predict_top_assignment(mtop, r.device_top_params, k,
                                                (xraw - kminf) * s, xraw, B - 1)

    counts = np.bincount(np.asarray(jax.jit(leaf_ids)(data.keys)), minlength=B)
    top = r.device_top_params
    return {"top": _row(top["w"] if "w" in top else top),
            **_build_summary("build-ref", n, seed, r, np.asarray(r.leaf_errors), counts, B)}


RUNNERS = {"keys": phase_keys, "top-port": phase_top_port, "top-ref": phase_top_ref,
           "build-port": phase_build_port, "build-ref": phase_build_ref}


def _status_kib(pid, field):
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith(field + ":"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


def run_phase(name, args):
    """The phase in a child process, its peak RSS watched; killed past the cap."""
    cmd = [sys.executable, os.path.abspath(__file__), "--child", name, "--config",
           args.config, "--n", str(args.n), "--seed", str(args.seed)]
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, text=True)
    peak_kib, killed = 0, False
    cap_kib = int(args.cap_gib * 2**20)
    while proc.poll() is None:
        hwm = _status_kib(proc.pid, "VmHWM")
        if hwm is not None:
            peak_kib = max(peak_kib, hwm)
        if peak_kib > cap_kib:
            proc.kill()
            killed = True
            break
        time.sleep(0.2)
    out, _ = proc.communicate()
    result = {"phase": name, "seconds": round(time.time() - t0, 1), "rc": proc.returncode}
    lines = [ln for ln in (out or "").splitlines() if ln.startswith("{")]
    if lines:
        result.update(json.loads(lines[-1]))
    result["peak_rss_gib"] = round(max(peak_kib, int(result.pop("child_maxrss_kib", 0)))
                                   / 2**20, 2)
    if killed:
        result["killed_at_cap_gib"] = args.cap_gib
    print(json.dumps(result), flush=True)
    return result


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="max_size_wiki")
    ap.add_argument("--n", type=int, default=200_000_000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--cap-gib", type=float, default=40.0,
                    help="kill a phase whose resident memory passes this")
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--child", choices=PHASES, help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    global CONFIG, CONFIG_NAME
    CONFIG, CONFIG_NAME = CONFIGS[args.config], args.config
    B = CONFIG[3]
    if args.child:
        import resource
        out = RUNNERS[args.child](args.n, B, args.seed)
        out["child_maxrss_kib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        print(json.dumps(out), flush=True)
        return
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in PHASES:
            raise SystemExit(f"unknown phase {p}")
    if CONFIG[4]:          # a cachefix top is fitted over the knots: builds only
        phases = [p for p in phases if not p.startswith("top-")]
    results = {}
    for p in PHASES:
        if p in phases:
            results[p] = run_phase(p, args)
            if p == "keys" and results[p]["rc"] != 0:
                break
    summary = {"config": args.config, "spec": ",".join(CONFIG[1:3]), "B": B,
               "bounded": CONFIG[4], "n": args.n, "seed": args.seed, "phases": results}
    if all(results.get(p, {}).get("rc") == 0 for p in ("build-port", "build-ref")):
        summary["leaf_errors"] = compare(args.n, args.seed, B)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
