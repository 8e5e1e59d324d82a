"""Model registry: the contract every RMI layer model satisfies
(counterpart of rmi_tpu/models/base.py).

A model is a definition whose fit produces parameter rows for all of a
layer's models at once ([B, ppm] f64 in the normalized key domain) and
whose predict evaluates a batch of keys.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from rmi_tpu_torch import keys as keymod


def predict_clamped(pred_f: torch.Tensor, bound) -> torch.Tensor:
    """min(bound, predict_to_int(pred)) as int64: max(0, floor(f)) with
    NaN -> 0 (models/mod.rs:735-737), valid for bound < 2^53."""
    p = torch.floor(pred_f)
    p = torch.where(torch.isnan(p), torch.zeros_like(p),
                    p.clamp(0.0, float(bound)))
    return p.to(torch.int64)


def leaf_columns(w: torch.Tensor, leaf_ids: Optional[torch.Tensor]):
    """The parameter columns of each element's row w[leaf_ids], gathered
    column by column, or of the single top row w[0] when ``leaf_ids`` is
    None."""
    if leaf_ids is None:
        return w[0].unbind(-1)
    return tuple(w[leaf_ids, k] for k in range(w.shape[1]))


@dataclasses.dataclass(frozen=True)
class ModelDef:
    """One RMI layer model type.

    fit_top(xf, yf, ep_y_first, ep_y_last) -> [1, ppm]
        Fit the single top model over the whole array: ``yf`` are the
        FixDups positions scaled by B/n and truncated; ``ep_y_*`` the
        scaled raw indices of the container's first and last rows
        (RMITrainingData::get bypasses FixDups, models/mod.rs:268-274).
    fit_leaves(xf, yfix, spans) -> [B, ppm]
        Batched per-leaf fit over overlap-augmented spans, ``yfix`` the
        int32 FixDups positions.
    predict(w [B, ppm], leaf_ids, x) -> f64 predictions, each element
        through its row w[leaf_ids]; leaf_ids None evaluates the top row
        (rmi_tpu's predict(params, leaf_idx, keys_f)).
    constant_params(value_f [B]) -> [B, ppm], or None
        set_to_constant_model (models/mod.rs:761-763); None for the
        models whose empty leaves stay unpatched (loglinear, normal,
        lognormal; rmi_tpu two_layer.py:235-243).
    leaf_kernel: the leaf evaluation of csrc/leaf_eval.cuh that kernels
        K3 and K4 run for this model as a leaf ("linear", "cubic",
        "loglinear" or "normal"), itself the name of the model whose
        ``predict`` is that evaluation's plain version.
    input_domain: "affine" models fit and predict on the normalized keys
        x' = (x - offset) * scale; "raw" ones (lognormal, whose log is
        not affine-covariant) on the keys' f64 values (rmi_tpu
        models/base.py:81-85), and their leaf kernel on log_input of
        them (kernel_input).
    """

    name: str
    ppm: int
    fit_top: Callable
    fit_leaves: Callable
    predict: Callable
    constant_params: Optional[Callable]
    leaf_kernel: str
    input_domain: str = "affine"


REGISTRY: Dict[str, ModelDef] = {}


def register(model: ModelDef) -> ModelDef:
    REGISTRY[model.name] = model
    return model


def get_model(name: str) -> ModelDef:
    if name not in REGISTRY:
        raise NotImplementedError(
            f"model type {name!r} is not in rmi_tpu_torch, which carries "
            f"{sorted(REGISTRY)}; the rest of the reference's model zoo is "
            f"ROADMAP.md Queue 1, item 7")
    return REGISTRY[name]


def log_input(x: torch.Tensor) -> torch.Tensor:
    """max(ln x, 0) with NaN -> 0: lognormal's prediction input (Rust's
    f64::max maps NaN to 0, normal.rs:166), on which the "normal" leaf
    kernel serves it."""
    raw = torch.log(x)
    return torch.where(torch.isnan(raw), 0.0, raw.clamp(min=0.0))


def kernel_input(mdef: ModelDef, x: torch.Tensor) -> torch.Tensor:
    """The input of model ``mdef``'s leaf kernel for its model input
    ``x``: x itself, or log_input(x) for a "raw" model, applied outside
    K3 and K4.  The build's sweep, its probes and lookup all take it from
    here, so build and serve compute the same bits on one device."""
    return log_input(x) if mdef.input_domain == "raw" else x


def normalize(keys: torch.Tensor, kminf: float, s: float) -> torch.Tensor:
    """x' = (as_float(key) - offset) * scale, f64."""
    return keymod.as_float(keys).sub_(kminf).mul_(s)


def model_float_input(mdef, keys: torch.Tensor, kminf: float, s: float) -> torch.Tensor:
    """The f64 input model ``mdef`` fits and predicts on: the normalized
    keys, or the keys' raw values for a "raw" model (rmi_tpu
    two_layer.py:63-66)."""
    if mdef.input_domain == "raw":
        return keymod.as_float(keys)
    return normalize(keys, kminf, s)


def predict_top_assignment(mtop, top_w, x, bound: int) -> torch.Tensor:
    """min(bound, predict_to_int(top(x))) as int64 (two_layer.rs:49),
    ``x`` the top's model_float_input."""
    return predict_clamped(mtop.predict(top_w, None, x), bound)


def leaf_predict(leaf_type: str, w: torch.Tensor, leaf_ids: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """f64 predictions of the leaf kernel of model ``leaf_type`` on its
    kernel input ``x`` (kernel_input), each element x[i] through its row
    w[leaf_ids[i]]: the leaf evaluation of every plain path (the
    kernels' is csrc/leaf_eval.cuh)."""
    return get_model(get_model(leaf_type).leaf_kernel).predict(w, leaf_ids, x)


def validate_spec(spec_list) -> None:
    """Two layers, every name known."""
    if len(spec_list) != 2:
        raise ValueError(
            "rmi_tpu_torch supports exactly two model layers (the "
            "reference's multi-layer trainer is disabled upstream, "
            "train/mod.rs:125)")
    for name in spec_list:
        get_model(name)
