"""K3: the build's per-key error sweep (csrc/sweep.cu), one C entry
point per leaf kernel: linear, cubic, loglinear and normal.

Counterpart of rmi_tpu/ops/sweep_kernel.py:sweep_errors.  The kernel
and K4 (ops/eval_kernel.py) evaluate leaves with the device functions of
csrc/leaf_eval.cuh; their plain versions share models.base.leaf_predict.
Both take the leaf kernel's input (models.base.kernel_input: for
lognormal leaves max(ln x, 0), computed by the caller).  The leaf type
is passed, never read off the row width: loglinear rows are [B, 2] as
linear ones are.
"""

from __future__ import annotations

import torch

from rmi_tpu_torch.models.base import get_model, leaf_predict, predict_clamped
from rmi_tpu_torch.ops import _build


def _check(xn, yfix, t, w, ppm):
    if xn.dtype != torch.float64 or xn.dim() != 1:
        raise ValueError("sweep_errors: xn must be 1-D float64")
    if yfix.dtype != torch.int32 or t.dtype != torch.int32:
        raise ValueError("sweep_errors: yfix and t must be int32")
    if yfix.shape != xn.shape or t.shape != xn.shape:
        raise ValueError("sweep_errors: xn, yfix and t differ in shape")
    if w.dtype != torch.float64 or w.dim() != 2 or w.shape[1] != ppm:
        raise ValueError(f"sweep_errors: w must be a [B, {ppm}] float64 table")


def sweep_errors_plain(xn, yfix, t, w, n: int, *, leaf_type: str) -> torch.Tensor:
    """The plain PyTorch version (two_layer.py:269-280 of rmi_tpu)."""
    pred = predict_clamped(leaf_predict(leaf_type, w, t.long(), xn), n)
    return (pred - yfix.clamp(max=n)).abs().to(torch.int32)


def sweep_errors(xn, yfix, t, w, n: int, *, leaf_type: str) -> torch.Tensor:
    """err [n] int32: |clip(floor(leaf_t(x)), 0, n) - min(y, n)| per key,
    for rows ``w`` [B, ppm] of leaf model ``leaf_type`` and its kernel
    input ``xn``."""
    mdef = get_model(leaf_type)
    _check(xn, yfix, t, w, mdef.ppm)
    if xn.device.type == "cpu":
        return sweep_errors_plain(xn, yfix, t, w, n, leaf_type=leaf_type)
    _build.check_cuda("sweep_errors", xn, yfix, t, w)
    err = torch.empty(xn.shape[0], dtype=torch.int32, device=xn.device)
    _build.launch(f"rmi_sweep_{mdef.leaf_kernel}", xn, yfix, t, w, err,
                  xn.shape[0], int(n))
    return err
