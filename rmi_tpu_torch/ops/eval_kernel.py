"""K4: clamped integer leaf predictions for linear leaves (csrc/eval.cu).

Counterpart of rmi_tpu/ops/eval_kernel.py:leaf_eval_clamped.  Serves the
build's epsilon probes (bound n) and lookup (bound n - 1).  Its leaf
evaluation is the one the error sweep (K3) measured the bounds with
(csrc/leaf_eval.cuh; models.linear.linear_predict in the plain
version), which is what makes |guess - lower_bound| <= err hold.
"""

from __future__ import annotations

import torch

from rmi_tpu_torch.models.base import predict_clamped
from rmi_tpu_torch.models.linear import linear_predict
from rmi_tpu_torch.ops import _build


def _check(x, w, leaf_ids):
    if x.dtype != torch.float64 or x.dim() != 1:
        raise ValueError("leaf_eval_clamped: x must be 1-D float64")
    if leaf_ids.dtype != torch.int64 or leaf_ids.shape != x.shape:
        raise ValueError("leaf_eval_clamped: leaf_ids must be int64 shaped like x")
    if w.dtype != torch.float64 or w.dim() != 2 or w.shape[1] != 2:
        raise ValueError("leaf_eval_clamped: w must be a [B, 2] float64 table")


def leaf_eval_clamped_plain(x, w, leaf_ids, bound: int) -> torch.Tensor:
    """The plain PyTorch version: predict_clamped(fma(beta, x, alpha))."""
    pred = linear_predict(w[leaf_ids, 0], w[leaf_ids, 1], x)
    return predict_clamped(pred, bound).to(torch.int32)


def leaf_eval_clamped(x, w, leaf_ids, bound: int) -> torch.Tensor:
    """[m] int32: clip(floor(fma(w[l, 1], x, w[l, 0])), 0, bound), NaN -> 0,
    with l = leaf_ids[i]."""
    _check(x, w, leaf_ids)
    if x.device.type == "cpu":
        return leaf_eval_clamped_plain(x, w, leaf_ids, bound)
    _build.check_cuda("leaf_eval_clamped", x, w, leaf_ids)
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    _build.launch("rmi_leaf_eval_linear", x, w, leaf_ids, out, x.shape[0],
                  int(bound))
    return out
