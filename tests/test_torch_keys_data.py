"""rmi_tpu_torch keys and data layer against rmi_tpu.

Exact comparisons throughout: the u64 -> f64 cast rounds once in both
packages, the epsilons are integer steps, and an SOSD file is bytes.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rmi_tpu import data as jdata
from rmi_tpu import keys as jkeys
from rmi_tpu_torch import data as tdata
from rmi_tpu_torch import keys as tkeys

EDGE_KEYS = [0, 1, 2**53 + 1, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 1025,
             2**64 - 1024, 2**64 - 1]


@pytest.mark.parametrize("key", EDGE_KEYS)
def test_as_float_edge_keys(key):
    u = np.array([key], dtype=np.uint64)
    got = tkeys.as_float(tkeys.to_image(u)).numpy()
    want = np.asarray(jkeys.as_float(jnp.asarray(u)))
    assert got.view(np.uint64)[0] == want.view(np.uint64)[0]
    assert got[0] == u.astype(np.float64)[0]


def test_as_float_random_keys(rng):
    u = rng.integers(0, 2**64 - 1, size=20_000, dtype=np.uint64, endpoint=True)
    got = tkeys.as_float(tkeys.to_image(u)).numpy()
    want = np.asarray(jkeys.as_float(jnp.asarray(u)))
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


def test_image_order_and_round_trip(rng):
    u = np.concatenate([np.array(EDGE_KEYS, dtype=np.uint64),
                        rng.integers(0, 2**64 - 1, 5_000, dtype=np.uint64,
                                     endpoint=True)])
    img = tkeys.to_image(u)
    np.testing.assert_array_equal(tkeys.from_image(img), u)
    # signed order of images is unsigned order of keys
    np.testing.assert_array_equal(np.argsort(img.numpy(), kind="stable"),
                                  np.argsort(u, kind="stable"))


@pytest.mark.parametrize("kt", ["U64", "U32"])
def test_epsilons_saturate(kt):
    jt, tt = getattr(jkeys.KeyType, kt), getattr(tkeys.KeyType, kt)
    top = 2**64 - 1 if kt == "U64" else 2**32 - 1
    u = np.array([0, 1, 12345, top - 1, top], dtype=jt.np_dtype)
    img = tkeys.to_image(u)
    for tfn, jfn in ((tkeys.minus_epsilon, jkeys.minus_epsilon),
                     (tkeys.plus_epsilon, jkeys.plus_epsilon)):
        got = tkeys.from_image(tfn(img, tt), tt)
        want = np.asarray(jfn(jnp.asarray(u), jt))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sosd_file_cross_load(tmp_path, rng, writer):
    keys = np.sort(rng.integers(0, 2**64 - 1, 4_097, dtype=np.uint64,
                                endpoint=True))
    path = str(tmp_path / "keys_uint64")
    (jdata if writer == "jax" else tdata).write_sosd_file(path, keys)
    via_jax = np.asarray(jdata.load_data(path).keys)
    ds = tdata.load_data(path)
    assert ds.key_type is tkeys.KeyType.U64 and ds.n == keys.size
    np.testing.assert_array_equal(ds.to_numpy(), via_jax)
    np.testing.assert_array_equal(via_jax, keys)


def test_synthetic_books_matches_jax():
    for kt in ("U64", "U32"):
        got = tdata.synthetic_dataset("books", 3_000, getattr(tkeys.KeyType, kt),
                                      seed=7)
        want = jdata.synthetic_dataset("books", 3_000, getattr(jkeys.KeyType, kt),
                                       seed=7)
        np.testing.assert_array_equal(got, want)


def test_port_imports_no_jax():
    code = ("import sys, rmi_tpu_torch, rmi_tpu_torch.lookup; "
            "import rmi_tpu_torch.ops.scan_kernel, rmi_tpu_torch.ops.select_kernel; "
            "import rmi_tpu_torch.ops.sweep_kernel, rmi_tpu_torch.ops.eval_kernel; "
            "bad = [m for m in sys.modules if m in ('jax', 'rmi_tpu') "
            "or m.startswith(('jax.', 'rmi_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


@pytest.mark.parametrize("n", [1, 7, 4096, 70_001])
def test_books_like_on_device_reproducible(n):
    """The seeded books-like keys are the same on every call, sorted,
    and end at 2^62."""
    keys = tdata.books_like_on_device(n, 11, "cpu")
    assert torch.equal(keys, tdata.books_like_on_device(n, 11, "cpu"))
    u = tkeys.from_image(keys, tkeys.KeyType.U64)
    assert u.shape == (n,) and u[-1] == 2**62
    assert (np.diff(u.astype(np.float64)) >= 0).all()
