"""K3 and the run-length pass: stage C's two per-leaf maxima, taken over
the leaves' contiguous spans in one pass each (csrc/sweep.cu,
csrc/run_max.cu, both walking csrc/span_max.cuh).

``sweep_leaf_max`` is the counterpart of rmi_tpu/ops/sweep_kernel.py:
sweep_errors fused with the segmented max that follows it
(rmi_tpu/train/two_layer.py:337-338), one C entry point per leaf kernel:
linear, cubic, loglinear and normal.  ``span_run_max`` is the longest
duplicate run per leaf (two_layer.py:339-341 of rmi_tpu).  Neither
writes a per-key array.  ``sweep_errors`` is the per-key definition,
plain PyTorch on any device, that rmi_tpu's sweep_errors is held to.

K3 and K4 (ops/eval_kernel.py) evaluate leaves with the device functions
of csrc/leaf_eval.cuh; their plain versions share
models.base.leaf_predict.  Both take the leaf kernel's input
(models.base.kernel_input: for lognormal leaves max(ln x, 0), computed
by the caller).  The leaf type is passed, never read off the row width:
loglinear rows are [B, 2] as linear ones are.
"""

from __future__ import annotations

import torch

from rmi_tpu_torch.models.base import get_model, leaf_predict, predict_clamped
from rmi_tpu_torch.ops import _build, scan_kernel
from rmi_tpu_torch.ops.select_kernel import span_elements
from rmi_tpu_torch.utils import segments as seg


def _check_keys(name, xn, yfix, dtype):
    if xn.dtype != dtype or xn.dim() != 1:
        raise ValueError(f"{name}: the keys must be 1-D {dtype}")
    if yfix.dtype != torch.int32 or yfix.shape != xn.shape:
        raise ValueError(f"{name}: yfix must be int32, one per key")


def _check_spans(name, starts, ends):
    if (starts.dtype != torch.int64 or ends.dtype != torch.int64
            or starts.dim() != 1 or starts.shape != ends.shape):
        raise ValueError(f"{name}: starts and ends must be int64 [B]")


def _check_rows(name, w, ppm):
    if w.dtype != torch.float64 or w.dim() != 2 or w.shape[1] != ppm:
        raise ValueError(f"{name}: w must be a [B, {ppm}] float64 table")


def sweep_errors_plain(xn, yfix, t, w, n: int, *, leaf_type: str) -> torch.Tensor:
    """The plain PyTorch version (two_layer.py:269-280 of rmi_tpu)."""
    pred = predict_clamped(leaf_predict(leaf_type, w, t.long(), xn), n)
    return (pred - yfix.clamp(max=n)).abs().to(torch.int32)


def sweep_errors(xn, yfix, t, w, n: int, *, leaf_type: str) -> torch.Tensor:
    """err [n] int32: |clip(floor(leaf_t(x)), 0, n) - min(y, n)| per key,
    for rows ``w`` [B, ppm] of leaf model ``leaf_type`` and its kernel
    input ``xn``: the per-key definition of K3, on the tensors' device."""
    _check_keys("sweep_errors", xn, yfix, torch.float64)
    if t.dtype != torch.int32 or t.shape != xn.shape:
        raise ValueError("sweep_errors: t must be int32, one per key")
    _check_rows("sweep_errors", w, get_model(leaf_type).ppm)
    return sweep_errors_plain(xn, yfix, t, w, n, leaf_type=leaf_type)


def sweep_leaf_max_plain(xn, yfix, starts, ends, w, n: int, *,
                         leaf_type: str) -> torch.Tensor:
    """The plain PyTorch version of K3: every key's error under its
    span's row (a key in no span takes row 0 and is never read), then the
    plain segmented max."""
    leaf, elem = span_elements(starts, ends)
    t = torch.zeros(xn.shape[0], dtype=torch.int32, device=xn.device)
    t[elem] = leaf.to(torch.int32)
    del leaf, elem
    err = sweep_errors_plain(xn, yfix, t, w, n, leaf_type=leaf_type)
    return seg.range_max(err, starts, ends, 0)


def sweep_leaf_max(xn, yfix, starts, ends, w, n: int, *,
                   leaf_type: str) -> torch.Tensor:
    """max_err [B] int32: per leaf j the largest
    |clip(floor(leaf_j(x)), 0, n) - min(y, n)| over the keys of its span
    [starts[j], ends[j]), 0 for an empty leaf, for rows ``w`` [B, ppm] of
    leaf model ``leaf_type`` and its kernel input ``xn``.  The spans must
    be sorted and disjoint (``starts`` non-decreasing, as
    segments.make_spans makes them): the kernel finds a chunk's span by
    binary search and does not check.  ``n`` and the number of keys stay
    below 2^31, the range of the int32 errors.  Equal to the plain
    version: the errors are the per-key ones bit for bit and a maximum
    has no order."""
    mdef = get_model(leaf_type)
    _check_keys("sweep_leaf_max", xn, yfix, torch.float64)
    _check_spans("sweep_leaf_max", starts, ends)
    _check_rows("sweep_leaf_max", w, mdef.ppm)
    if w.shape[0] != starts.shape[0]:
        raise ValueError("sweep_leaf_max: one row of w per span")
    if max(int(n), xn.shape[0]) >= 2**31:
        raise ValueError("sweep_leaf_max: n must be below 2^31")
    if xn.is_cpu:
        return sweep_leaf_max_plain(xn, yfix, starts, ends, w, n,
                                    leaf_type=leaf_type)
    _build.check_cuda("sweep_leaf_max", xn, yfix, starts, ends, w)
    B = starts.shape[0]
    max_err = torch.zeros(B, dtype=torch.int32, device=xn.device)
    _build.launch(f"rmi_sweep_max_{mdef.leaf_kernel}", xn, yfix, starts, ends, w,
                  max_err, B, xn.shape[0], int(n))
    return max_err


def run_lengths_plain(keys: torch.Tensor, run_start: torch.Tensor) -> torch.Tensor:
    """Per-key duplicate-run length [n] int32, 0 for the array's FINAL run
    (the reference never flushes it).  ``run_start`` is FixDups' output."""
    n = keys.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=keys.device)
    ends_run = torch.ones(n, dtype=torch.bool, device=keys.device)
    torch.ne(keys[1:], keys[:-1], out=ends_run[:-1])
    run_end = scan_kernel.scan_i32_plain(torch.where(ends_run, idx, n - 1),
                                         is_max=False, reverse=True)
    del idx, ends_run
    run_len = run_end - run_start + 1
    return torch.where(run_end < n - 1, run_len, 0)


def span_run_max_plain(keys, yfix, starts, ends) -> torch.Tensor:
    """The plain PyTorch version of the run-length pass: every key's run
    length (a reverse running min finds its run's end), then the plain
    segmented max."""
    return seg.range_max(run_lengths_plain(keys, yfix), starts, ends, 0)


def span_run_max(keys, yfix, starts, ends) -> torch.Tensor:
    """longest_run [B] int32: per leaf j the longest duplicate run among
    the keys of its span [starts[j], ends[j]) of the sorted int64 ``keys``,
    0 if it has none; the array's final run counts 0.  ``yfix`` is
    FixDups' first-occurrence index per key.  The kernel reads a run's
    length off its last key, i - yfix[i] + 1; that equals the plain
    version's maximum over every key's run length because a run lies in
    one span: equal keys get one leaf id."""
    _check_keys("span_run_max", keys, yfix, torch.int64)
    _check_spans("span_run_max", starts, ends)
    if keys.is_cpu:
        return span_run_max_plain(keys, yfix, starts, ends)
    _build.check_cuda("span_run_max", keys, yfix, starts, ends)
    B = starts.shape[0]
    longest_run = torch.zeros(B, dtype=torch.int32, device=keys.device)
    _build.launch("rmi_span_run_max", keys, yfix, starts, ends, longest_run, B,
                  keys.shape[0])
    return longest_run
