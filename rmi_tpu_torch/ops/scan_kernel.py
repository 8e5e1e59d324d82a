"""K1: inclusive running max/min over an int32 vector, and FixDups
(csrc/scan.cu).

Counterpart of rmi_tpu/ops/scan_kernel.py.  ``fixdups`` is the build's
first-occurrence index (train/two_layer.fixdups_i32): one launch of
rmi_fixdups over the sorted keys, where rmi_tpu runs the scan over
where(changed, i, 0) (rmi_tpu/train/two_layer.py:77-84).
``fixdups_carry`` is the same over one rank's shard in the data-parallel
build (parallel/dp_trainer.dist_fixdups), its indices global, the run
continuing in from the ranks before given as a carry: one launch of
rmi_fixdups_carry.  ``scan_i32`` (rmi_scan_i32) takes the dp build's
running max and min across the ranks' carries, and its primitive
dist_run_bounds; the run lengths' reverse cummin is taken per leaf off
each run's last key instead (ops/sweep_kernel.py:span_run_max and
span_run_max_carry), with this kernel's plain version in that pass's
plain version.
"""

from __future__ import annotations

import torch

from rmi_tpu_torch.ops import _build

TILE = 4096          # elements per block of csrc/scan.cu's K1
FIXDUPS_WARP_KEYS = 2048     # keys a warp of rmi_fixdups takes (kFixdupsWarpKeys)


def scan_i32_plain(v: torch.Tensor, *, is_max: bool,
                   reverse: bool = False) -> torch.Tensor:
    """The plain PyTorch version: torch.cummax / torch.cummin."""
    scan = torch.cummax if is_max else torch.cummin
    if reverse:
        return scan(v.flip(0), 0).values.flip(0)
    return scan(v, 0).values


def scan_i32(v: torch.Tensor, *, is_max: bool, fill: int,
             reverse: bool = False) -> torch.Tensor:
    """Inclusive running max (``is_max``) or min of [n] int32 ``v``,
    right to left when ``reverse``.  ``fill`` is the op's identity.
    Bit-equal to the plain version: max and min never round."""
    if v.dtype != torch.int32 or v.dim() != 1:
        raise ValueError(f"scan_i32: want a 1-D int32 tensor, got {v.dtype} {tuple(v.shape)}")
    if v.is_cpu:
        return scan_i32_plain(v, is_max=is_max, reverse=reverse)
    n = v.shape[0]
    out, _ = _build.launch("rmi_scan_i32", v, n, n, int(is_max), int(fill), int(reverse),
                           max(1, -(-n // TILE)))      # the output and a scratch
    return out


def fixdups_plain(keys: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the running max of where(keys[i] !=
    keys[i - 1], i, 0), as int32 (rmi_tpu's _fixdups_i32)."""
    n = keys.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=keys.device)
    changed = torch.ones(n, dtype=torch.bool, device=keys.device)
    torch.ne(keys[1:], keys[:-1], out=changed[1:])
    return scan_i32_plain(torch.where(changed, idx, 0), is_max=True)


def fixdups(keys: torch.Tensor) -> torch.Tensor:
    """[n] int32: the first index of each key's run of equal keys in the
    sorted int64 images ``keys`` (FixDups, models/mod.rs:143-185),
    bit-equal to the plain version: one launch of rmi_fixdups on the
    card, none for no keys."""
    _check_keys("fixdups", keys)
    n = keys.shape[0]
    if n > 1 << 31:
        raise ValueError("fixdups: int32 indices hold at most 2^31 keys")
    if keys.is_cpu:
        return fixdups_plain(keys)
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=keys.device)
    return _build.launch("rmi_fixdups", keys, n, n)


def _check_keys(name, keys):
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError(f"{name}: want 1-D int64 key images, got {keys.dtype} "
                         f"{tuple(keys.shape)}")


def fixdups_carry_plain(keys: torch.Tensor, offset: int, continues: torch.Tensor,
                        carry: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, the data-parallel build's eager chain:
    the running max of where(changed, offset + i, 0), the shard's first key
    a change unless ``continues``, then its maximum with ``carry``."""
    m = keys.shape[0]
    changed = torch.ones(m, dtype=torch.bool, device=keys.device)
    torch.ne(keys[1:], keys[:-1], out=changed[1:])
    changed[:1] = ~continues
    starts = torch.where(changed, torch.arange(offset, offset + m, dtype=torch.int32,
                                               device=keys.device), 0)
    return torch.maximum(scan_i32_plain(starts, is_max=True), carry)


def fixdups_carry(keys: torch.Tensor, offset: int, continues: torch.Tensor,
                  carry: torch.Tensor) -> torch.Tensor:
    """[m] int32: FixDups of one rank's shard of the sorted key images, in
    global indices: the shard's first key lies at global index ``offset``,
    ``continues`` (a bool [1]) says whether it equals the last key of the
    rank before, and ``carry`` (int32 [1] or scalar) is the global start of
    the run in progress at the end of the ranks before (at most offset - 1;
    0 on rank 0).  Bit-equal to the plain version: one launch of
    rmi_fixdups_carry on the card, its first run's start where(continues,
    carry, offset) handed over on the card, none for no keys."""
    _check_keys("fixdups_carry", keys)
    m = keys.shape[0]
    if offset < 0 or offset + m > 1 << 31:
        raise ValueError("fixdups_carry: int32 indices hold at most 2^31 keys")
    if keys.is_cpu:
        return fixdups_carry_plain(keys, offset, continues, carry)
    if m == 0:
        return torch.empty(0, dtype=torch.int32, device=keys.device)
    first = torch.where(continues, carry.long(), offset).reshape(1)
    return _build.launch("rmi_fixdups_carry", keys, m, m, int(offset), first)
