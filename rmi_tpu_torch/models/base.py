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


def predict_clamped(pred_f: torch.Tensor, bound) -> torch.Tensor:
    """min(bound, predict_to_int(pred)) as int64: max(0, floor(f)) with
    NaN -> 0 (models/mod.rs:735-737), valid for bound < 2^53."""
    p = torch.floor(pred_f)
    p = torch.where(torch.isnan(p), torch.zeros_like(p),
                    p.clamp(0.0, float(bound)))
    return p.to(torch.int64)


@dataclasses.dataclass(frozen=True)
class ModelDef:
    """One RMI layer model type.

    fit_top(xf, yf, ep_y_first, ep_y_last) -> [1, ppm]
        Fit the single top model over the whole array: ``yf`` are the
        FixDups positions scaled by B/n and truncated; ``ep_y_*`` the
        scaled raw indices of the container's first and last rows
        (RMITrainingData::get bypasses FixDups, models/mod.rs:268-274).
    fit_leaves(xf, yf, spans) -> [B, ppm]
        Batched per-leaf fit over overlap-augmented spans (None if the
        model cannot be a leaf in this port yet).
    predict(w [1, ppm], x) -> f64 predictions of the top model.
    constant_params(value_f [B]) -> [B, ppm]
        set_to_constant_model (models/mod.rs:761-763).
    """

    name: str
    fit_top: Callable
    fit_leaves: Optional[Callable]
    predict: Callable
    constant_params: Optional[Callable]


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


def validate_spec(spec_list) -> None:
    """Two layers, every name known, the last one leaf-capable here."""
    if len(spec_list) != 2:
        raise ValueError(
            "rmi_tpu_torch supports exactly two model layers (the "
            "reference's multi-layer trainer is disabled upstream, "
            "train/mod.rs:125)")
    get_model(spec_list[0])
    leaf = get_model(spec_list[1])
    if leaf.fit_leaves is None:
        raise NotImplementedError(
            f"model type {leaf.name} as a leaf layer is not ported to "
            f"rmi_tpu_torch yet (ROADMAP.md Queue 1, item 7)")
