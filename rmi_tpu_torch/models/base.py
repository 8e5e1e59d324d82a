"""Model registry: the contract every RMI layer model satisfies
(counterpart of rmi_tpu/models/base.py).

A model is a definition whose fit produces the parameters of all of a
layer's models at once and whose predict evaluates a batch of keys.  A
float model's parameters are rows ([B, ppm] f64 in the normalized key
domain); an integer-output model's (radix, bradix, the radix hint
tables, histogram) a dict of int tensors, named as rmi_tpu names them.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, Optional, Union

import torch

from rmi_tpu_torch import keys as keymod
from rmi_tpu_torch.keys import KeyType


class Restriction(enum.Enum):
    """Where in the layers a model may stand (models/mod.rs:724-728)."""

    NONE = "none"
    MUST_BE_TOP = "top"
    MUST_BE_BOTTOM = "bottom"


Params = Union[torch.Tensor, Dict[str, torch.Tensor]]


def predict_clamped(pred_f: torch.Tensor, bound) -> torch.Tensor:
    """min(bound, predict_to_int(pred)) as int64: max(0, floor(f)) with
    NaN -> 0 (models/mod.rs:735-737), valid for bound < 2^53."""
    p = torch.floor(pred_f)
    p = torch.where(torch.isnan(p), torch.zeros_like(p),
                    p.clamp(0.0, float(bound)))
    return p.to(torch.int64)


def clamp_int(pred: torch.Tensor, bound) -> torch.Tensor:
    """min(bound, pred) in the u64 domain for an integer-output model's
    predictions (u64 bits in int64): a wrapped -1, histogram's underflow,
    clamps to ``bound``, not to 0."""
    return keymod.umin(pred, bound)


def params_to(p: Params, device) -> Params:
    """A model layer's parameters on ``device``."""
    if isinstance(p, dict):
        return {k: v.to(device) for k, v in p.items()}
    return p.to(device)


def params_equal(a: Params, b: Params) -> bool:
    """Two layers' parameters bit-equal (on one device)."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys()
                and all(torch.equal(a[k], b[k]) for k in a))
    return torch.equal(a, b)


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
        An integer-output model: fit_top(keys, yf, B, scale) -> dict,
        ``keys`` the sorted key images and ``scale`` = B / n.
    fit_leaves(xf, yfix, spans) -> [B, ppm], or None for a top-only model
        Batched per-leaf fit over overlap-augmented spans, ``yfix`` the
        int32 FixDups positions; an integer-output model takes the key
        images for xf and returns a dict.
    predict(w, leaf_ids, x) -> the predictions of each element through
        its leaf's parameters (row w[leaf_ids]); leaf_ids None evaluates
        the top (rmi_tpu's predict(params, leaf_idx, keys_f)).  f64 for
        a float model; u64 bits in int64 for an integer-output one, which
        takes the key images for x.
    constant_params(value_f [B]) -> [B, ppm], or None
        set_to_constant_model (models/mod.rs:761-763); None for the
        models whose empty leaves stay unpatched (loglinear, normal,
        lognormal and the integer-output ones; rmi_tpu
        two_layer.py:222-243).
    leaf_kernel: the leaf evaluation of csrc/leaf_eval.cuh that kernels
        K3 and K4 run for this model as a leaf ("linear", "cubic",
        "loglinear" or "normal"), itself the name of the model whose
        ``predict`` is that evaluation's plain version; None for the
        integer-output models, which no kernel evaluates (rmi_tpu
        computes them outside Pallas, two_layer.py:382-400).
    fit_aux: None, or for cubic fit_aux(xf, yf, spans, ep_y, keys, key_type,
        sf=1.0) -> (rows, aux): the fit that fit_top (spans over the whole
        array, ep_y its endpoint targets, ``yf`` the int32 FixDups
        positions and sf = B / n, which scales them as they are read) and
        fit_leaves (ep_y None, sf 1) return the rows of, with the
        generator statistics from which convert.py recomputes the raw
        coefficients (rmi_tpu models/cubic.py:183-194; ``keys`` the images
        of ``key_type`` keys, whose raw floats give xmin and xmax).
    bytes_per_model: the artifact bytes of one model's parameters
        (codegen.rs:375-394); None where they follow the data (histogram).
    function_name: the model's function in the reference's generated code.
    input_domain: "affine" models fit and predict on the normalized keys
        x' = (x - offset) * scale; "raw" ones (lognormal, whose log is
        not affine-covariant) on the keys' f64 values (rmi_tpu
        models/base.py:81-85), and their leaf kernel on log_input of
        them (kernel_input); "int" ones, the integer-output models, on
        integer-key images: the key images themselves, or of f64 keys
        the images of their as_int values (keys.int_image).
    output_int, restriction, leaf_capable, needs_bounds_check: as
        rmi_tpu's (models/base.py:44-116).
    table_bits: a radix hint table's bits (its 2^bits slots), None for
        the other models.
    """

    name: str
    ppm: int
    fit_top: Callable
    fit_leaves: Optional[Callable]
    predict: Callable
    constant_params: Optional[Callable]
    leaf_kernel: Optional[str]
    bytes_per_model: Optional[int]
    function_name: str
    fit_aux: Optional[Callable] = None
    input_domain: str = "affine"
    output_int: bool = False
    restriction: Restriction = Restriction.NONE
    leaf_capable: bool = True
    needs_bounds_check: bool = True
    table_bits: Optional[int] = None


REGISTRY: Dict[str, ModelDef] = {}


def register(model: ModelDef) -> ModelDef:
    REGISTRY[model.name] = model
    return model


def get_model(name: str) -> ModelDef:
    if name not in REGISTRY:
        raise ValueError(f"Unknown model type: {name}")  # train/mod.rs:53
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


def normalize(keys: torch.Tensor, kminf: float, s: float,
              key_type: KeyType = KeyType.U64) -> torch.Tensor:
    """x' = (as_float(key) - offset) * scale, f64, of images of
    ``key_type`` keys."""
    return keymod.as_float(keys, key_type).sub_(kminf).mul_(s)


def model_float_input(mdef, keys: torch.Tensor, kminf: float, s: float,
                      key_type: KeyType = KeyType.U64) -> torch.Tensor:
    """The input model ``mdef`` fits and predicts on, from images of
    ``key_type`` keys: the normalized keys (on the card one launch of
    rmi_key_normalize, ops/top_kernel.key_normalize; normalize here on
    the CPU), the keys' raw f64 values for a "raw" model (rmi_tpu
    two_layer.py:63-66), or for an integer-output model the integer-key
    images (keys.int_image)."""
    # the kernel wrappers import this module
    from rmi_tpu_torch.ops import top_kernel

    if mdef.input_domain == "int":
        return keymod.int_image(keys, key_type)
    if mdef.input_domain == "raw":
        return keymod.as_float(keys, key_type)
    return top_kernel.key_normalize(keys, kminf, s, key_type)


def predict_top_assignment(mtop, top_w, x, bound: int) -> torch.Tensor:
    """min(bound, predict_to_int(top(x))) as int64 (two_layer.rs:49),
    ``x`` the top's model_float_input; clamp_int of an integer-output
    top's prediction (rmi_tpu two_layer.py:68-73)."""
    if mtop.output_int:
        return clamp_int(mtop.predict(top_w, None, x), bound)
    return predict_clamped(mtop.predict(top_w, None, x), bound)


def leaf_predict(leaf_type: str, w: torch.Tensor, leaf_ids: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """f64 predictions of the leaf kernel of model ``leaf_type`` on its
    kernel input ``x`` (kernel_input), each element x[i] through its row
    w[leaf_ids[i]]: the leaf evaluation of every plain path (the
    kernels' is csrc/leaf_eval.cuh)."""
    return get_model(get_model(leaf_type).leaf_kernel).predict(w, leaf_ids, x)


def validate_spec(spec_list) -> None:
    """Two layers, every name known, and the layer restrictions
    (train/mod.rs:59-85; rmi_tpu models/base.py:103-116)."""
    if len(spec_list) != 2:
        raise ValueError(
            "rmi_tpu_torch supports exactly two model layers (the "
            "reference's multi-layer trainer is disabled upstream, "
            "train/mod.rs:125)")
    last = len(spec_list) - 1
    for idx, name in enumerate(spec_list):
        m = get_model(name)
        if m.restriction is Restriction.MUST_BE_TOP and idx != 0:
            raise ValueError(f"if used, model type {name} must be the root model")
        if m.restriction is Restriction.MUST_BE_BOTTOM and idx != last:
            raise ValueError(
                f"if used, model type {name} must be the bottommost model")
        if idx == last and not m.leaf_capable:
            raise NotImplementedError(
                f"model type {name} is not supported as a leaf layer")
