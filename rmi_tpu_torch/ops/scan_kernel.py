"""K1: inclusive running max/min over an int32 vector (csrc/scan.cu).

Counterpart of rmi_tpu/ops/scan_kernel.py.  Serves the build's n-scale
monotone scan, the FixDups first-occurrence cummax (train/two_layer.py);
the run lengths' reverse cummin is taken per leaf off each run's last
key instead (ops/sweep_kernel.py:span_run_max), with this kernel's plain
version in that pass's plain version.
"""

from __future__ import annotations

import torch

from rmi_tpu_torch.ops import _build

TILE = 4096          # elements per block of csrc/scan.cu


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
    _build.check_cuda("scan_i32", v)
    n = v.shape[0]
    out = torch.empty_like(v)
    scratch = torch.empty(max(1, -(-n // TILE)), dtype=torch.int32,
                          device=v.device)
    _build.launch("rmi_scan_i32", v, out, n, int(is_max), int(fill),
                  int(reverse), scratch)
    return out
