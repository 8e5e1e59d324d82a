"""The port's card probes (rmi_tpu_torch/ops/probe_kernels.py) against
probes/probe_pallas.py on the CPU.

A, B1-B3 and C1-C3 run the JAX probe itself: ``pl.pallas_call`` is
patched, inside the test only, to run the kernel in interpret mode and to
keep the call's inputs and output.  The port's inputs must be those
arrays (same shapes, same numpy seeds) and its plain version must give
that output, exactly: compares and gathers never round.  E and D run
the same way, so the port's index, rows and table are the JAX script's
own arrays.  E's Pallas kernel rests on the TPU's DMA semantics and does
not reproduce in interpret mode, so its plain version is held to the
probe's own expectation, ``x[idx]`` of the recorded arrays.  D's kernel
(``_dma_rate``, un-jitted inside the test) does: its sum is 4096.0, and
run again on the marked table it gives the port's sum, which shows the
port's row walk is the script's (i * 7919) mod 2^17.  On CPU tensors each
wrapper runs its plain version; tests/test_torch_cuda_kernels.py holds
the kernels to them on the card.
"""

import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from rmi_tpu_torch.ops import probe_kernels as pk

_PATH = pathlib.Path(__file__).resolve().parent.parent / "probes" / "probe_pallas.py"
BY_KEY = {p.key: p for p in pk.PROBES}


@pytest.fixture(scope="module")
def probe_pallas():
    spec = importlib.util.spec_from_file_location("probe_pallas", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits(a):
    """A recorded JAX array as the numpy array the port carries: unsigned
    64- and 32-bit values as the signed type of the same bits."""
    a = np.asarray(a)
    signed = {np.dtype(np.uint64): np.int64, np.dtype(np.uint32): np.int32}
    return a.view(signed[a.dtype]) if a.dtype in signed else a


class _NoJit:
    """The jax module with ``jit`` as the identity, so that a probe's
    jitted pallas_call sees, and the recorder keeps, concrete arrays."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn):
        return fn


def _run_recorded(probe_pallas, monkeypatch, name, *args):
    """Run function ``name`` of the JAX script with its kernels in
    interpret mode; the list of (kernel, pallas_call keywords, inputs,
    output) of its pallas_calls, inputs and output as numpy arrays."""
    calls = []
    real = probe_pallas.pl.pallas_call

    def interpreted(kernel, **kw):
        call = real(kernel, interpret=True, **kw)

        def run(*arrays):
            out = call(*arrays)
            calls.append((kernel, kw, [_bits(a) for a in arrays], _bits(out)))
            return out
        return run

    monkeypatch.setattr(probe_pallas.pl, "pallas_call", interpreted)
    monkeypatch.setattr(probe_pallas, "jax", _NoJit())
    getattr(probe_pallas, name)(*args)
    return calls


def _same_arrays(mine, theirs):
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


JAX_PROBES = {"A": "t_a", "B1": "t_b1", "B2": "t_b2", "B3": "t_b3", "C1": "t_c1",
              "C2": "t_c2", "C3": "t_c3", "E": "t_e"}


def _expected(key, probe_pallas, monkeypatch, capsys):
    """(the port's inputs, the output the probe expects) for probe ``key``.
    The port's inputs must be the arrays the JAX script gave its kernel."""
    probe = BY_KEY[key]
    if key == "D":                                # _dma_rate: a warm-up and 5 timed calls
        calls = _run_recorded(probe_pallas, monkeypatch, "_dma_rate", 128)
        tbl, = pk.probe_inputs(probe, "cpu")
        assert len(calls) == 6
        for _, _, jax_in, jax_out in calls:
            _same_arrays([tbl.numpy()], jax_in)
            np.testing.assert_array_equal(jax_out, np.float32([[4096.0]]))
        return (tbl,), calls[0][3].reshape(1)
    (_, _, jax_in, jax_out), = _run_recorded(probe_pallas, monkeypatch,
                                             JAX_PROBES[key])
    verdict = capsys.readouterr().err
    _same_arrays(probe.inputs(), jax_in)
    if key == "E":                 # interpret mode does not copy as the TPU does:
        assert "[FAIL]" in verdict                # the probe's own expectation stands in
        idx, x = jax_in
        return pk.probe_inputs(probe, "cpu"), x[idx]
    assert "[OK]" in verdict                      # the probe's own check passed
    return pk.probe_inputs(probe, "cpu"), jax_out


@pytest.mark.parametrize("key", [p.key for p in pk.PROBES])
def test_probe_plain_matches_probe_pallas(key, probe_pallas, monkeypatch, capsys):
    probe = BY_KEY[key]
    args, want = _expected(key, probe_pallas, monkeypatch, capsys)
    for fn in (probe.plain, probe.wrapper):       # on the CPU the wrapper is the plain version
        got = fn(*args).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_ring_walk_and_marked_table(probe_pallas, monkeypatch):
    """D's row walk is probe_pallas's (i * 7919) mod 2^17, block after
    block, and the marked table's sum is the f32 running sum in order:
    the JAX script's own kernel, given the marked table, sums the same."""
    kernel, kw, _, _ = _run_recorded(probe_pallas, monkeypatch, "_dma_rate", 128)[0]
    marked = pk.ring_table(128, "cpu", marked=True)
    jax_sum = np.asarray(probe_pallas.pl.pallas_call(kernel, **kw)(marked.numpy()))
    np.testing.assert_array_equal(jax_sum.reshape(1), pk.row_ring_plain(marked).numpy())
    i = np.arange(4096, dtype=np.int64)
    np.testing.assert_array_equal(pk.ring_rows(pk.RING_ROWS).numpy()[0],
                                  (i * 7919) % (1 << 17))
    rows = pk.ring_rows(pk.RING_ROWS, blocks=3).numpy()
    for b in range(3):
        np.testing.assert_array_equal(rows[b], ((i * 3 + b) * 7919) % (1 << 17))
    assert len(np.unique(rows)) == rows.size        # no row twice: nothing is cached
    many = pk.ring_rows(pk.RING_ROWS, blocks=132).numpy()
    assert len(np.unique(many[:, :900])) == 132 * 900    # nor among 132 blocks at a time
    tbl = pk.ring_table(128, "cpu", marked=True)
    assert bool((tbl[:, 1:] == 1).all())
    got = pk.row_ring(tbl, blocks=3).numpy()
    want = np.zeros(3, np.float32)
    for b in range(3):
        for r in rows[b]:
            want[b] += np.float32(r % 251)
    np.testing.assert_array_equal(got, want)
    assert float(pk.row_ring(tbl, iters=40)[0]) == float(sum(
        (k * 7919) % (1 << 17) % 251 for k in range(40)))


@pytest.mark.parametrize("warps", [1, 2, 3, 8, 16])
def test_ring_card_form_splits_the_probe_walk(probe_pallas, monkeypatch, warps):
    """D's whole-card form on the CPU (its plain version): the probe's
    walk, rows (j * 7919) mod 2^17 for j < 4096, split over S = blocks *
    warps streams (3 warps: streams of 3 and 4 fetches), stream s summing
    j = s (mod S) in order; its partial sums add up to the JAX probe's
    own sum of the marked table."""
    marked = pk.ring_table(128, "cpu", marked=True)
    got = pk.row_ring_card(marked, warps=warps).numpy()
    streams = pk.ring_card_blocks(warps) * warps
    assert got.shape == (streams,) and streams >= pk.RING_ITERS // pk.RING_PER_WARP
    rows = (np.arange(pk.RING_ITERS) * 7919) % (1 << 17)
    want = np.zeros(streams, np.float32)
    for j, r in enumerate(rows):
        want[j % streams] += np.float32(r % 251)
    np.testing.assert_array_equal(got, want)
    ones = pk.row_ring_card(pk.ring_table(128, "cpu"), warps=warps)
    assert float(ones.double().sum()) == pk.RING_ITERS
    kernel, kw, _, _ = _run_recorded(probe_pallas, monkeypatch, "_dma_rate", 128)[0]
    jax_sum = np.asarray(probe_pallas.pl.pallas_call(kernel, **kw)(marked.numpy()))
    assert float(jax_sum.reshape(())) == float(got.astype(np.float64).sum())


@pytest.mark.parametrize("width", pk.RING_WIDTHS)
def test_ring_cold_views_share_no_row(width):
    """D's cold views (made on the meta device: shapes and offsets, no
    memory): [2^17, width] views of one table, enough that the walks of
    all but one of them fetch twice the L2 cache, and no row is fetched
    by the walks of two of them, so a view's rows are never in L2 from
    the calls on the others."""
    views = pk.ring_cold_views(width, "meta")
    walk_bytes = pk.RING_ITERS * width * 4
    assert all(v.shape == (pk.RING_ROWS, width) and v.is_contiguous() for v in views)
    assert (len(views) - 1) * walk_bytes >= 2 * pk.L2_BYTES
    walk = pk.ring_rows(pk.RING_ROWS)[0].numpy()
    rows = np.concatenate([v.storage_offset() // width + walk for v in views])
    assert len(np.unique(rows)) == len(rows)
    assert all(v.storage_offset() * 4 % 16 == 0 for v in views)   # bulk-copy aligned


def test_probe_main_is_the_card_form_for_d():
    """chip_smoke drives each probe's ``main``: D's whole-card form, every
    other probe's wrapper, each beside its own plain version, which it
    equals on the CPU."""
    for probe in pk.PROBES:
        if probe.key == "D":
            assert (probe.main, probe.main_plain) == (pk.row_ring_card,
                                                      pk.row_ring_card_plain)
            args = (pk.ring_table(128, "cpu", marked=True),)
        else:
            assert (probe.main, probe.main_plain) == (probe.wrapper, probe.plain)
            args = pk.probe_inputs(probe, "cpu")
        assert torch.equal(probe.main(*args), probe.main_plain(*args))


@pytest.mark.parametrize("blocks,warps", [(1, 4), (3, 2)])
def test_ring_warps_are_streams(blocks, warps):
    """With several issuing warps a block, D's streams are blocks * warps
    walks of ring_rows, stream s = b * warps + w, as with one warp a
    block of blocks * warps blocks."""
    tbl = pk.ring_table(128, "cpu", marked=True)
    got = pk.row_ring(tbl, iters=50, blocks=blocks, warps=warps)
    assert torch.equal(got, pk.row_ring(tbl, iters=50, blocks=blocks * warps))
    with pytest.raises(ValueError):
        pk.row_ring(tbl, warps=17)


def test_unsigned_compares_near_the_sign_bit():
    """B2's image compare and B3's pair compare equal numpy's uint64 <
    on values around 2^63, 2^32 and 0, where a signed compare of the raw
    bits or of the halves goes wrong."""
    edge = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**32 + 1, 2**63 - 1,
                     2**63, 2**63 + 1, 2**64 - 2**32, 2**64 - 1], dtype=np.uint64)
    x, q = [a.ravel() for a in np.meshgrid(edge, edge)]
    want = (x < q).astype(np.int32)
    tx, tq = (torch.from_numpy(a.view(np.int64)) for a in (x, q))
    np.testing.assert_array_equal(pk.less_than_u64(tx, tq).numpy(), want)
    assert (pk.less_than_i64(tx, tq).numpy() != want).any()      # the raw bits differ
    halves = [torch.from_numpy((a >> np.uint64(s)).astype(np.uint32).view(np.int32))
              for a in (x, q) for s in (32, 0)]
    np.testing.assert_array_equal(pk.less_than_u32pair(*halves).numpy(), want)


def _indices(rng, n, nq, offset=0):
    """nq int32 indices in [0, n), the first third one repeated value,
    as a view ``offset`` elements into its array."""
    idx = rng.integers(0, n, nq + offset, dtype=np.int32)[offset:]
    idx[: nq // 3] = idx[nq // 2] if nq else 0
    return idx


# rows of 36 at 70000 rows, and 2^22- or 60000-entry tables, are more than
# a block's shared memory holds (the old C1 and C2 limits); widths 1 and 3
# are not 16-byte multiples
@pytest.mark.parametrize("rows,width,nq,offset", [
    (70_000, 36, 257, 0), (4099, 3, 257, 1), (4099, 1, 70_000, 0), (512, 128, 0, 0),
    (4099, 2048, 2, 3)])
def test_gather_rows_is_fancy_indexing(rows, width, nq, offset):
    """C1's contract, through its wrapper on the CPU: numpy's tbl[idx],
    bit for bit, at any size, width and nq, on offset views too."""
    rng = np.random.default_rng(rows + width + nq)
    tbl = rng.normal(size=(rows * width + offset,)).astype(np.float32)[offset:]
    tbl = tbl.reshape(rows, width)
    idx = _indices(rng, rows, nq, offset)
    got = pk.gather_rows(torch.from_numpy(tbl), torch.from_numpy(idx)).numpy()
    want = tbl[idx]
    assert got.dtype == want.dtype and got.shape == want.shape == (nq, width)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("ntbl,nq,offset", [
    (1 << 22, 70_000, 0), (60_000, 257, 1), (4096, 0, 0), (4096, 1, 2), (4096, 6, 3)])
def test_take_is_fancy_indexing(ntbl, nq, offset):
    """C2's contract, through its wrapper on the CPU: numpy's tbl[idx],
    bit for bit, at any table size and nq, on offset views too."""
    rng = np.random.default_rng(ntbl + nq)
    tbl = rng.normal(size=ntbl + offset).astype(np.float32)[offset:]
    idx = _indices(rng, ntbl, nq, offset)
    got = pk.take(torch.from_numpy(tbl), torch.from_numpy(idx)).numpy()
    want = tbl[idx]
    assert got.dtype == want.dtype and got.shape == want.shape == (nq,)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_probe_wrappers_refuse_bad_inputs():
    f = torch.zeros(8, 128)
    i = torch.zeros(8, 128, dtype=torch.int32)
    with pytest.raises(ValueError):
        pk.scale2(f.double())
    with pytest.raises(ValueError):
        pk.less_than_i64(i, i)
    with pytest.raises(ValueError):
        pk.less_than_u64(i.long(), i.long()[:4])
    with pytest.raises(ValueError):
        pk.less_than_u32pair(i, i, i, i.long())
    with pytest.raises(ValueError):
        pk.gather_rows(f, i.long()[0])
    with pytest.raises(ValueError):
        pk.take(f, i[0])
    with pytest.raises(ValueError):
        pk.take_lanes(f[:, :64], i[:, :64])
    with pytest.raises(ValueError):
        pk.row_ring(f, slots=17)
    with pytest.raises(ValueError):
        pk.row_copy(i, f)
