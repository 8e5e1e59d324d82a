"""Card probes (csrc/probes.cu): the nine feature and rate probes of
probes/probe_pallas.py, one wrapper and one plain PyTorch version each,
and each probe's inputs as that script makes them (same shapes, same
numpy seeds).  tools/probe_torch_kernels.py runs them.

  A   scale2             o = 2 x, f32
  B1  less_than_i64      x < q, int64
  B2  less_than_u64      x < q, uint64 bits carried as int64
  B3  less_than_u32pair  u64 x < q as (hi, lo) u32 pairs carried as int32
  C1  gather_rows        tbl[idx, :], each row read through L2, no stage
  C2  take               tbl[idx] from a 1-D table read through L2
  C3  take_lanes         take_along_axis(tbl, idx, 1) by warp shuffles
  D   row_ring           pipelined random-row bulk copies, 16 in flight
  E   row_copy           index-driven row copies, spread over the card

torch has no ``<`` on uint64 on the CPU, so B2's plain version compares
the order-preserving int64 images x ^ 2^63 (rmi_tpu_torch/keys.py): the
probe holds the kernel's unsigned compare to the signed compare of the
images that the port's keys rest on.  Every probe's output equals its
plain version's exactly; D's sum is exact because its tables hold small
integers.  On CPU tensors a wrapper runs the plain version.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from rmi_tpu_torch.ops import _build

INT64_MIN = -(1 << 63)
RING_ROWS = 1 << 17          # D's table rows
RING_ITERS = 4096            # D's copies per block
RING_SLOTS = 16              # D's copies in flight
RING_STEP = 7919             # D's pseudo-random walk: row i is (i * 7919) mod rows
RING_WIDTHS = (128, 256, 512, 1024, 2048)
MAX_SHARED_BYTES = 232448    # dynamic shared memory one block may ask for
COPY_WARPS = 4              # E: warps per block, each with its own ring
COPY_SHARE = 8192           # E: most indices a block stages


def _check(name, dtype, *tensors):
    for a in tensors:
        if a.dtype != dtype:
            raise ValueError(f"{name}: want {dtype}, got {a.dtype}")
        if a.shape != tensors[0].shape:
            raise ValueError(f"{name}: shapes differ")


def _check_index(name, idx):
    if idx.dtype != torch.int32:
        raise ValueError(f"{name}: idx must be int32")


def _check_bulk(name, x, width):
    """cp.async.bulk copies 16-byte multiples between 16-byte boundaries."""
    if width % 4 or x.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be 16-byte multiples on a "
                         f"16-byte boundary")


# --- A, B1-B3 ---------------------------------------------------------------

def scale2_plain(x):
    return x * 2.0


def scale2(x):
    """A: 2 x for f32 ``x`` of any shape."""
    _check("scale2", torch.float32, x)
    if x.is_cpu:
        return scale2_plain(x)
    _build.check_cuda("scale2", x)
    out = torch.empty_like(x)
    _build.launch("rmi_probe_scale2", x, out, x.numel())
    return out


def less_than_i64_plain(x, q):
    return (x < q).to(torch.int32)


def less_than_i64(x, q):
    """B1: x < q as int32 for int64 ``x`` and ``q`` of one shape."""
    _check("less_than_i64", torch.int64, x, q)
    if x.is_cpu:
        return less_than_i64_plain(x, q)
    _build.check_cuda("less_than_i64", x, q)
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    _build.launch("rmi_probe_lt_i64", x, q, out, x.numel())
    return out


def less_than_u64_plain(x, q):
    """The signed compare of the order-preserving images x ^ 2^63."""
    return ((x ^ INT64_MIN) < (q ^ INT64_MIN)).to(torch.int32)


def less_than_u64(x, q):
    """B2: x < q as int32 for uint64 values whose bits ``x`` and ``q``
    carry as int64."""
    _check("less_than_u64", torch.int64, x, q)
    if x.is_cpu:
        return less_than_u64_plain(x, q)
    _build.check_cuda("less_than_u64", x, q)
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    _build.launch("rmi_probe_lt_u64", x, q, out, x.numel())
    return out


def _u32(a):
    return a.long() & 0xFFFFFFFF


def less_than_u32pair_plain(hi, lo, qh, ql):
    h, g = _u32(hi), _u32(qh)
    return ((h < g) | ((h == g) & (_u32(lo) < _u32(ql)))).to(torch.int32)


def less_than_u32pair(hi, lo, qh, ql):
    """B3: (hi, lo) < (qh, ql) in lexicographic order as int32, for
    uint32 halves whose bits the four int32 tensors carry."""
    _check("less_than_u32pair", torch.int32, hi, lo, qh, ql)
    if hi.is_cpu:
        return less_than_u32pair_plain(hi, lo, qh, ql)
    _build.check_cuda("less_than_u32pair", hi, lo, qh, ql)
    out = torch.empty(hi.shape, dtype=torch.int32, device=hi.device)
    _build.launch("rmi_probe_lt_u32pair", hi, lo, qh, ql, out, hi.numel())
    return out


# --- C1-C3 ------------------------------------------------------------------

def gather_rows_plain(tbl, idx):
    return tbl[idx.long()]


def gather_rows(tbl, idx):
    """C1: tbl[idx, :] for f32 ``tbl`` [rows, width] and int32 ``idx``
    [nq] in [0, rows), for a table of any size.  No shared memory: a
    group of lanes takes a row and moves it from where it lies with
    16-byte loads and stores (4-byte ones where the width is not a
    multiple of 4 or ``tbl`` does not start on a 16-byte boundary).
    Indices are not range-checked, since that would synchronise: on the
    card one out of range is undefined (a stray read or a fault)."""
    _check("gather_rows", torch.float32, tbl)
    _check_index("gather_rows", idx)
    if tbl.dim() != 2 or idx.dim() != 1:
        raise ValueError("gather_rows: tbl must be 2-D and idx 1-D")
    if tbl.is_cpu:
        return gather_rows_plain(tbl, idx)
    _build.check_cuda("gather_rows", tbl, idx)
    rows, width = tbl.shape
    out = torch.empty(idx.shape[0], width, dtype=torch.float32, device=tbl.device)
    _build.launch("rmi_probe_gather_rows", tbl, idx, out, rows, width, idx.shape[0])
    return out


def take_plain(tbl, idx):
    return tbl[idx.long()]


def take(tbl, idx):
    """C2: tbl[idx] for 1-D f32 ``tbl`` of any size and int32 ``idx`` in
    [0, len(tbl)).  No shared memory: one thread an output reads its
    index and the table entry where it lies.  Indices are not
    range-checked, since that would synchronise: on the card one out of
    range is undefined (a stray read or a fault)."""
    _check("take", torch.float32, tbl)
    _check_index("take", idx)
    if tbl.dim() != 1 or idx.dim() != 1:
        raise ValueError("take: tbl and idx must be 1-D")
    if tbl.is_cpu:
        return take_plain(tbl, idx)
    _build.check_cuda("take", tbl, idx)
    out = torch.empty(idx.shape[0], dtype=torch.float32, device=tbl.device)
    _build.launch("rmi_probe_take", tbl, idx, out, tbl.shape[0], idx.shape[0])
    return out


def take_lanes_plain(tbl, idx):
    return torch.gather(tbl, 1, idx.long())


def take_lanes(tbl, idx):
    """C3: out[r, c] = tbl[r, idx[r, c]] for f32 ``tbl`` and int32 ``idx``,
    both [rows, 128], idx in [0, 128): warp shuffles, no shared memory."""
    _check("take_lanes", torch.float32, tbl)
    _check_index("take_lanes", idx)
    if tbl.dim() != 2 or tbl.shape[1] != 128 or idx.shape != tbl.shape:
        raise ValueError("take_lanes: tbl and idx must be [rows, 128]")
    if tbl.is_cpu:
        return take_lanes_plain(tbl, idx)
    _build.check_cuda("take_lanes", tbl, idx)
    out = torch.empty_like(tbl)
    _build.launch("rmi_probe_take_lanes", tbl, idx, out, tbl.shape[0], 128)
    return out


# --- D, E -------------------------------------------------------------------

def ring_rows(rows: int, iters: int = RING_ITERS, blocks: int = 1) -> torch.Tensor:
    """[blocks, iters] int64: the rows D's block b fetches, in order:
    ((i blocks + b) * 7919) mod rows, so that one block walks as the TPU
    probe does and several fetch no row twice at one time."""
    g = torch.arange(blocks * iters, dtype=torch.int64).view(iters, blocks).t()
    return (g * RING_STEP) % rows


def row_ring_plain(tbl, *, iters: int = RING_ITERS, blocks: int = 1):
    """The sum of the first value of each fetched row, per block; summed
    in f64, which equals the kernel's f32 running sum wherever that is
    exact (small integers, as in the probe's tables)."""
    rows = ring_rows(tbl.shape[0], iters, blocks).to(tbl.device)
    return tbl[:, 0][rows].double().sum(1).float()


def row_ring(tbl, *, iters: int = RING_ITERS, slots: int = RING_SLOTS,
             blocks: int = 1):
    """D: [blocks] f32.  Block b fetches rows ((i blocks + b) * 7919) mod
    rows of f32 ``tbl`` [rows, width] for i < iters, each whole row with
    one cp.async.bulk into a ring of ``slots`` shared-memory slots, and
    sums the rows' first values.  The probe runs 4096 copies through 16
    slots; ``iters`` and ``slots`` are there for the tests, which also
    drive a short walk and a ring that wraps more often."""
    _check("row_ring", torch.float32, tbl)
    if tbl.dim() != 2 or not 1 <= slots <= 16 or blocks < 1 or iters < 0:
        raise ValueError("row_ring: want a 2-D table, 1-16 slots, blocks >= 1")
    if tbl.is_cpu:
        return row_ring_plain(tbl, iters=iters, blocks=blocks)
    _build.check_cuda("row_ring", tbl)
    rows, width = tbl.shape
    _check_bulk("row_ring", tbl, width)
    if slots * width * 4 > MAX_SHARED_BYTES:
        raise ValueError("row_ring: the ring exceeds a block's shared memory")
    out = torch.empty(blocks, dtype=torch.float32, device=tbl.device)
    _build.launch("rmi_probe_row_ring", tbl, rows, width, iters, slots, blocks, out)
    return out


def row_copy_plain(idx, x):
    return x[idx.long()]


def row_copy(idx, x):
    """E: x[idx, :] for f32 ``x`` [rows, width] and int32 ``idx`` [nq] in
    [0, rows).  Each block stages a contiguous share of the indices in
    shared memory; each of its warps keeps a ring of bulk row copies in
    flight and writes the rows out with 16-byte stores.  A row may take
    at most a quarter of a block's shared memory beside the indices."""
    if (x.dtype != torch.float32 or idx.dtype != torch.int32 or x.dim() != 2
            or idx.dim() != 1):
        raise ValueError("row_copy: want f32 x [rows, width] and int32 idx [nq]")
    if x.is_cpu:
        return row_copy_plain(idx, x)
    _build.check_cuda("row_copy", idx, x)
    nq, width = idx.shape[0], x.shape[1]
    _check_bulk("row_copy", x, width)
    if COPY_WARPS * width * 4 + COPY_SHARE * 4 > MAX_SHARED_BYTES:
        raise ValueError("row_copy: a row per warp exceeds a block's shared memory")
    out = torch.empty((nq, width), dtype=torch.float32, device=x.device)
    _build.launch("rmi_probe_row_copy", idx, x, out, width, nq)
    return out


# --- the probes' inputs, as probes/probe_pallas.py makes them ----------------

def _tile_i64():
    return np.arange(8 * 128, dtype=np.int64).reshape(8, 128) << 40


def _inputs_a():
    return (np.arange(8 * 128, dtype=np.float32).reshape(8, 128),)


def _inputs_b1():
    return _tile_i64(), np.full((8, 128), 500 << 40, dtype=np.int64)


def _inputs_b2():
    x = _tile_i64().astype(np.uint64) + np.uint64(2**63)
    q = np.full((8, 128), 2**63 + (500 << 40), dtype=np.uint64)
    return x.view(np.int64), q.view(np.int64)


def _inputs_b3():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**64, (8, 128), dtype=np.uint64)
    q = rng.integers(0, 2**64, (8, 128), dtype=np.uint64)
    return tuple((a >> s).astype(np.uint32).view(np.int32)
                 for a in (x, q) for s in (np.uint64(32), np.uint64(0)))


def _inputs_c1():
    return (np.arange(512 * 128, dtype=np.float32).reshape(512, 128),
            np.random.default_rng(1).integers(0, 512, (256,), dtype=np.int32))


def _inputs_c2():
    return (np.arange(4096, dtype=np.float32),
            np.random.default_rng(1).integers(0, 4096, (1024,), dtype=np.int32))


def _inputs_c3():
    return (np.arange(8 * 128, dtype=np.float32).reshape(8, 128),
            np.random.default_rng(1).integers(0, 128, (8, 128), dtype=np.int32))


def _inputs_e():
    x = (np.arange(4096, dtype=np.float32)[:, None]
         * np.ones((1, 128), np.float32))
    return np.random.default_rng(3).integers(0, 4096, (256,), dtype=np.int32), x


def ring_table(width: int, device, *, marked: bool = False) -> torch.Tensor:
    """D's table [2^17, width] f32, made on ``device``: all ones, as the
    TPU probe's, or ``marked``, with x[r, 0] = r mod 251, which a copy
    that lands in the wrong slot or is read too early cannot sum right."""
    tbl = torch.ones(RING_ROWS, width, dtype=torch.float32, device=device)
    if marked:
        tbl[:, 0] = (torch.arange(RING_ROWS, device=device) % 251).float()
    return tbl


class Probe(NamedTuple):
    key: str                 # the probe's letter in probes/probe_pallas.py
    title: str               # its title there
    entry: str               # C entry point
    wrapper: Callable
    plain: Callable
    inputs: Callable         # () -> numpy arrays, None for D (ring_table)
    replaces: str            # file:line of the TPU kernel's pallas_call


_SRC = "probes/probe_pallas.py"
PROBES = (
    Probe("A", "minimal kernel", "rmi_probe_scale2", scale2, scale2_plain,
          _inputs_a, f"{_SRC}:53"),
    Probe("B1", "native int64 compare", "rmi_probe_lt_i64", less_than_i64,
          less_than_i64_plain, _inputs_b1, f"{_SRC}:67"),
    Probe("B2", "native uint64 compare", "rmi_probe_lt_u64", less_than_u64,
          less_than_u64_plain, _inputs_b2, f"{_SRC}:83"),
    Probe("B3", "u32-pair lexicographic compare", "rmi_probe_lt_u32pair",
          less_than_u32pair, less_than_u32pair_plain, _inputs_b3, f"{_SRC}:105"),
    Probe("C1", "shared-memory gather tbl[idx] (2D rows)", "rmi_probe_gather_rows",
          gather_rows, gather_rows_plain, _inputs_c1, f"{_SRC}:120"),
    Probe("C2", "shared-memory gather take 1-D", "rmi_probe_take", take, take_plain,
          _inputs_c2, f"{_SRC}:135"),
    Probe("C3", "take_along_axis lanes (warp shuffles)", "rmi_probe_take_lanes",
          take_lanes, take_lanes_plain, _inputs_c3, f"{_SRC}:150"),
    Probe("D", "pipelined random-row bulk-copy rate", "rmi_probe_row_ring", row_ring,
          row_ring_plain, None, f"{_SRC}:194"),
    Probe("E", "shared-memory index-driven row copies", "rmi_probe_row_copy",
          row_copy, row_copy_plain, _inputs_e, f"{_SRC}:261"),
)


def probe_inputs(probe: Probe, device, *, width: int = 128, marked: bool = False):
    """The probe's input tensors on ``device``; ``width`` and ``marked``
    choose D's table."""
    if probe.inputs is None:
        return (ring_table(width, device, marked=marked),)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in probe.inputs())
