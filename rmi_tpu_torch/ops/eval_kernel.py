"""K4: clamped integer leaf predictions (csrc/eval.cu), one C entry
point per leaf kernel: linear, cubic, loglinear and normal.

Counterpart of rmi_tpu/ops/eval_kernel.py:leaf_eval_clamped.  Serves the
build's epsilon probes (bound n) and lookup (bound n - 1).  Its leaf
evaluation is the one the error sweep (K3) measured the bounds with
(csrc/leaf_eval.cuh; models.base.leaf_predict in the plain version),
which is what makes |guess - lower_bound| <= err hold.  ``x`` is the
leaf kernel's input (models.base.kernel_input).
"""

from __future__ import annotations

import torch

from rmi_tpu_torch.models.base import get_model, leaf_predict, predict_clamped
from rmi_tpu_torch.ops import _build


def _check(x, w, leaf_ids, ppm):
    if x.dtype != torch.float64 or x.dim() != 1:
        raise ValueError("leaf_eval_clamped: x must be 1-D float64")
    if leaf_ids.dtype != torch.int64 or leaf_ids.shape != x.shape:
        raise ValueError("leaf_eval_clamped: leaf_ids must be int64 shaped like x")
    if w.dtype != torch.float64 or w.dim() != 2 or w.shape[1] != ppm:
        raise ValueError(f"leaf_eval_clamped: w must be a [B, {ppm}] float64 table")


def leaf_eval_clamped_plain(x, w, leaf_ids, bound: int, *,
                            leaf_type: str) -> torch.Tensor:
    """The plain PyTorch version: predict_clamped(leaf_predict(...))."""
    pred = leaf_predict(leaf_type, w, leaf_ids, x)
    return predict_clamped(pred, bound).to(torch.int32)


def leaf_eval_clamped(x, w, leaf_ids, bound: int, *, leaf_type: str) -> torch.Tensor:
    """[m] int32: clip(floor(leaf(w[l], x)), 0, bound), NaN -> 0, with
    l = leaf_ids[i] and the leaf evaluation of model ``leaf_type``."""
    mdef = get_model(leaf_type)
    _check(x, w, leaf_ids, mdef.ppm)
    if x.device.type == "cpu":
        return leaf_eval_clamped_plain(x, w, leaf_ids, bound, leaf_type=leaf_type)
    _build.check_cuda("leaf_eval_clamped", x, w, leaf_ids)
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    _build.launch(f"rmi_leaf_eval_{mdef.leaf_kernel}", x, w, leaf_ids, out,
                  x.shape[0], int(bound))
    return out
