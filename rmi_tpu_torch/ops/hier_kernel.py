"""The hierarchical plan's resolve (csrc/hier.cu): exact lower bounds
from lookup's (guess, err) through the levels keys[::64^k], k = 0..K.

  resolve        the wrapper: one launch of rmi_hier_resolve on a CUDA
                 tensor, resolve_plain on a CPU tensor;
  resolve_plain  the plain PyTorch version, the counts over [m, 128]
                 index tensors, one level after the other.

Counterpart of rmi_tpu/lookup_fast.py:resolve and _count_row
(:388-413), which rmi_tpu computes in XLA in the program that runs K4
(_fast_search_df64, :524-551).  Level 0 is the key array itself; the
kernel reads levels 1..K from one int64 tensor with their offsets and
lengths (pack_levels, each level on a 32-byte boundary), the plain
version from the list of levels.  The levels are sorted (the keys are),
so the kernel takes each count as its window's lower bound, and below
level K as the lower bound inside the 63 entries the count above
brackets; the plain version compares all 128 entries, as rmi_tpu does.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from rmi_tpu_torch.ops import _build

LEVEL_FAN = 64          # the sampling factor between the levels
WIDTH = 128             # entries of one level's count
MAX_K = 10              # the kernel's deepest start level: 64^K fits in int64
SECTOR = 4              # int64 entries of a 32-byte sector: where each packed level starts


def count_from(arr, start, q, width: int):
    """start + #(arr[start : start + width] < q) per query; positions
    past the end of ``arr`` count as not below q."""
    m = arr.shape[0]
    idx = start[:, None] + torch.arange(width, device=q.device)
    below = (idx < m) & (arr[idx.clamp(max=m - 1)] < q[:, None])
    return start + below.sum(1)


def _count_row(level, row, q):
    """64 r + #(level[64 r : 64 r + 128] < q) with r = row clipped to the
    level's rows (rmi_tpu's _count_row over its overlapped row r)."""
    nrows = max(1, -(-level.shape[0] // LEVEL_FAN))
    return count_from(level, row.clamp(0, nrows - 1) * LEVEL_FAN, q, WIDTH)


def resolve_plain(levels, queries, guess, err, *, K: int, n: int) -> torch.Tensor:
    """Exact lower bounds from lookup's (guess, err) through the levels'
    row counts (rmi_tpu lookup_fast.py:396-413): level K's lower limit
    from guess - err, each finer level's from the count above it.  A
    query at or below the first key answers 0 and one above the last
    answers the key count, whatever its guess: an integer top routes
    such a query by bits that no key shares, to a leaf whose window need
    not hold its lower bound (lookup_fast._hier_search); rmi_tpu's
    resolve counts it through the levels like any other."""
    sK = LEVEL_FAN ** K
    LB = ((guess - err).clamp(0, n) + sK - 1) // sK
    lb = _count_row(levels[K], LB >> 6, queries).clamp(max=levels[K].shape[0])
    for k in range(K - 1, -1, -1):
        LB = (lb * LEVEL_FAN - LEVEL_FAN + 1).clamp(min=0)
        lb = _count_row(levels[k], LB >> 6, queries).clamp(max=levels[k].shape[0])
    keys = levels[0]
    return torch.where(queries <= keys[0], 0,
                       torch.where(queries > keys[-1], keys.shape[0], lb))


def _offsets(levels) -> List[int]:
    """Where levels 1..K start in the packed tensor, one after the other,
    each at a multiple of SECTOR entries (the kernel reads a level's
    sectors whole); the last entry is the tensor's length."""
    offsets = [0]
    for lv in levels[1:]:
        offsets.append(-(-(offsets[-1] + lv.shape[0]) // SECTOR) * SECTOR)
    return offsets


def pack_levels(levels: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(upper, index): levels 1..K copied into one int64 tensor
    (_offsets; the gaps between them hold 0), and the [K, 2] int64
    (offset, length) of each."""
    offsets = _offsets(levels)
    upper = levels[0].new_zeros(offsets[-1])
    for lv, off in zip(levels[1:], offsets):
        upper[off:off + lv.shape[0]] = lv
    index = torch.tensor([[off, lv.shape[0]] for lv, off in zip(levels[1:], offsets)],
                         dtype=torch.int64).reshape(-1, 2).to(levels[0].device)
    return upper, index


def hier_levels(keys: torch.Tensor, K: int):
    """(levels, (upper, index)): the levels keys[::64^k], k = 0..K, as
    the keys themselves, then views into ``upper``, which pack_levels
    fills with the strided copies (n / 63 entries in all)."""
    strided = [keys]
    for _ in range(K):
        strided.append(strided[-1][::LEVEL_FAN])
    upper, index = pack_levels(strided)
    levels = [keys] + [upper[off:off + lv.shape[0]]
                       for lv, off in zip(strided[1:], _offsets(strided))]
    return levels, (upper, index)


def _check(levels, queries, guess, err, K: int):
    for name, t in (("queries", queries), ("guess", guess), ("err", err),
                    ("keys", levels[0])):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise ValueError(f"resolve: {name} must be 1-D int64")
    if guess.shape != queries.shape or err.shape != queries.shape:
        raise ValueError("resolve: guess and err must be shaped like queries")
    if not 0 <= K <= MAX_K or len(levels) != K + 1:
        raise ValueError(f"resolve: want levels 0..K with 0 <= K <= {MAX_K}")


def resolve(levels, queries, guess, err, *, K: int, n: int,
            packed: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """[m] int64: #(levels[0] < queries[i]) for lookup's (guess, err) of
    each query, (levels, packed) = hier_levels(keys, K), n the keys
    indexed.  On the card one launch of rmi_hier_resolve over the keys
    and ``packed``, levels 1..K as (upper, index); on the CPU
    resolve_plain over ``levels``."""
    _check(levels, queries, guess, err, K)
    if queries.is_cpu:
        return resolve_plain(levels, queries, guess, err, K=K, n=n)
    m = queries.shape[0]
    if m == 0:
        return torch.empty_like(queries)
    upper, index = packed
    keys = levels[0]
    return _build.launch("rmi_hier_resolve", queries, guess, err, keys, keys.shape[0],
                         upper, index, K, m, m, int(n))
