"""u32 keys end to end, and the synthetic kinds, against rmi_tpu on the CPU.

  (a) synthetic_dataset's books, osm, fb and wiki keys equal rmi_tpu's
      arrays for two seeds and every key type (u32, u64, f64);
  (b) independent u32 builds of ``linear,linear 100`` (the reference's
      books-u32 CI configuration) and ``cubic,linear 1024`` on
      books_like_u32 keys (tools/parity_report.py's generator, copied)
      held to the PARITY rule (tests/test_torch_f64.assert_parity), the
      bound on every key, and search equal to rmi_tpu's and exact, the
      search plan's kind rmi_tpu's.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest

import rmi_tpu
from rmi_tpu import data as jdata
from rmi_tpu import keys as jkeys
from rmi_tpu import lookup_fast as jlf
from rmi_tpu.data import RMIDataset as JDataset

import rmi_tpu_torch as rt
from rmi_tpu_torch import data as tdata
from rmi_tpu_torch import keys as tkeys
from rmi_tpu_torch import lookup_fast as lf
from test_torch_artifacts import carry
from test_torch_f64 import assert_parity

N = 1 << 15


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kt", ["U32", "U64", "F64"])
@pytest.mark.parametrize("kind", ["books", "osm", "fb", "wiki"])
def test_synthetic_kinds_match_rmi_tpu(kind, kt, seed):
    got = tdata.synthetic_dataset(kind, 5000, getattr(tkeys.KeyType, kt), seed=seed)
    want = jdata.synthetic_dataset(kind, 5000, getattr(jkeys.KeyType, kt), seed=seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_synthetic_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown synthetic"):
        tdata.synthetic_dataset("sosd", 10)


def books_like_u32(n: int, seed: int = 11) -> np.ndarray:
    """u32 keys (the books_200M_uint32 CI shape): tools/parity_report.py's
    generator."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(size=n)
    csum = np.cumsum(gaps)
    return np.maximum((csum * (2.0 ** 31 / csum[-1])).astype(np.uint32), np.uint32(1))


@functools.lru_cache(maxsize=None)
def _builds(spec, B):
    keys = books_like_u32(N)
    rj = rmi_tpu.train(JDataset.from_numpy(keys), spec, B)
    rj.raw_inputs = rj.raw_thunk.__defaults__
    rp = rt.train(rt.RMIDataset.from_numpy(keys, device="cpu"), spec, B)
    return keys, rj, rp, carry(rj, keys)


@pytest.mark.parametrize("spec,B", [("linear,linear", 100), ("cubic,linear", 1024)])
def test_u32_build_and_search(spec, B):
    keys, rj, rp, rc = _builds(spec, B)
    assert rp.key_type is tkeys.KeyType.U32
    assert_parity(keys, rj, rp, rc)
    g, e = rt.lookup(rp, rp.keys)
    lb = np.searchsorted(keys, keys, side="left")
    assert int(np.sum(np.abs(g.numpy() - lb) > e.numpy())) == 0
    rng = np.random.default_rng(3)
    q = np.concatenate([rng.integers(0, 2 ** 32, 4000, dtype=np.uint64).astype(np.uint32),
                        np.array([0, 1, keys[0], keys[-1], 2 ** 32 - 1], np.uint32),
                        keys[rng.integers(0, N, 1000)]])
    got = rt.search(rp, tkeys.to_image(q)).numpy()
    np.testing.assert_array_equal(got, np.searchsorted(keys, q, side="left"))
    np.testing.assert_array_equal(rt.search(rc, tkeys.to_image(q)).numpy(),
                                  np.asarray(rmi_tpu.search(rj, jnp.asarray(q))))
    assert lf.get_plan(rp).kind == jlf.get_plan(rj).kind
