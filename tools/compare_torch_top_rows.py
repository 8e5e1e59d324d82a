"""The port's linear and normal top rows against rmi_tpu's fused stage A,
on the CPU.

    JAX_PLATFORMS=cpu python3 tools/compare_torch_top_rows.py [--root DIR]

Draws the keys of tests/test_torch_top_kernels.py (u64, u32 and f64, seed
22, 20011 keys with runs of equal keys), fits the top of ``linear,*`` and
``normal,*`` at B = 1000 with the port's _assign_body (the port found
under --root, this checkout by default: give another checkout's root to
see its rows) and with rmi_tpu's jitted _stage_assign (from this
checkout), and prints per top and key type both rows and their
difference: in ulps of each entry and in ulps of the row's largest
entry, the measure tests/test_torch_top_kernels.py bounds (STAGE_ULPS).
A CPU tool: it imports JAX for the reference, as the tests do.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 20011
B = 1000


def draw(kind, rng):
    """tests/test_torch_top_kernels._draw's keys and their key type name."""
    if kind == "u32":
        base = rng.integers(0, 2 ** 32, N // 2, dtype=np.uint64)
        keys = np.repeat(base, rng.integers(1, 6, base.size))[:N]
        return np.sort(keys).astype(np.uint32)
    if kind == "f64":
        base = np.concatenate([[0.0, -0.0, 0.0, -0.0], rng.normal(0.0, 1e6, N // 2)])
        return np.sort(np.repeat(base, rng.integers(1, 6, base.size))[:N])
    c = np.cumsum(rng.exponential(size=N // 2))
    base = (c * (2.0 ** 60 / c[-1])).astype(np.uint64)
    return np.sort(np.repeat(base, rng.integers(1, 6, base.size))[:N])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="the checkout whose port fits the rows")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, HERE)
    import jax.numpy as jnp
    from rmi_tpu import keys as jkeys
    from rmi_tpu.train import two_layer as j_two_layer
    from rmi_tpu_torch import keys as tkeys
    from rmi_tpu_torch.keys import KeyType
    from rmi_tpu_torch.models import get_model
    from rmi_tpu_torch.train import two_layer

    print(f"port from {os.path.dirname(sys.modules['rmi_tpu_torch'].__file__)}")
    for top in ("linear", "normal"):
        for kind in ("u64", "u32", "f64"):
            keys = draw(kind, np.random.default_rng(22))
            key_type = KeyType[kind.upper()]
            img = tkeys.to_image(keys)
            kminf, s = two_layer.norm_constants(img, key_type)
            _, params, _ = j_two_layer._stage_assign(
                jnp.asarray(keys), jnp.float64(kminf), jnp.float64(s), top_type=top, B=B,
                key_type=jkeys.KeyType[kind.upper()])
            want = np.asarray(j_two_layer._predict_params(params)["w"])[0]
            top_in = two_layer.model_float_input(get_model(top), img, kminf, s, key_type)
            yfix = two_layer.fixdups_i32(img)
            w, _, _ = two_layer._assign_body(top_in, yfix, top_type=top, B=B, keys=img,
                                             key_type=key_type)
            got = w.numpy()[0]
            print(json.dumps({
                "top": top, "keys": kind, "port": got.tolist(), "rmi_tpu": want.tolist(),
                "ulps_of_entry": ((got - want) / np.spacing(np.abs(want))).tolist(),
                "ulps_of_largest": float((np.abs(got - want)
                                          / np.spacing(np.abs(want).max())).max())}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
