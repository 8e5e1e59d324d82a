"""K3: the build's per-key error sweep for linear leaves (csrc/sweep.cu).

Counterpart of rmi_tpu/ops/sweep_kernel.py:sweep_errors.  The kernel
and K4 (ops/eval_kernel.py) evaluate leaves with one device function,
csrc/leaf_eval.cuh; their plain versions share
models.linear.linear_predict.
"""

from __future__ import annotations

import torch

from rmi_tpu_torch.models.base import predict_clamped
from rmi_tpu_torch.models.linear import linear_predict
from rmi_tpu_torch.ops import _build


def _check(xn, yfix, t, w):
    if xn.dtype != torch.float64 or xn.dim() != 1:
        raise ValueError("sweep_errors: xn must be 1-D float64")
    if yfix.dtype != torch.int32 or t.dtype != torch.int32:
        raise ValueError("sweep_errors: yfix and t must be int32")
    if yfix.shape != xn.shape or t.shape != xn.shape:
        raise ValueError("sweep_errors: xn, yfix and t differ in shape")
    if w.dtype != torch.float64 or w.dim() != 2 or w.shape[1] != 2:
        raise ValueError("sweep_errors: w must be a [B, 2] float64 table")


def sweep_errors_plain(xn, yfix, t, w, n: int) -> torch.Tensor:
    """The plain PyTorch version (two_layer.py:269-280 of rmi_tpu)."""
    tl = t.long()
    pred = predict_clamped(linear_predict(w[tl, 0], w[tl, 1], xn), n)
    return (pred - yfix.clamp(max=n)).abs().to(torch.int32)


def sweep_errors(xn, yfix, t, w, n: int) -> torch.Tensor:
    """err [n] int32: |clip(floor(leaf_t(x)), 0, n) - min(y, n)| per key,
    for linear leaf rows ``w`` [B, 2] = (alpha, beta)."""
    _check(xn, yfix, t, w)
    if xn.device.type == "cpu":
        return sweep_errors_plain(xn, yfix, t, w, n)
    _build.check_cuda("sweep_errors", xn, yfix, t, w)
    err = torch.empty(xn.shape[0], dtype=torch.int32, device=xn.device)
    _build.launch("rmi_sweep_linear", xn, yfix, t, w, err, xn.shape[0], int(n))
    return err
