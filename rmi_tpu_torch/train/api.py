"""Training facade: ``train`` and the TrainedRMI result (counterpart of
rmi_tpu/train/api.py:19-253)."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from rmi_tpu_torch import config, keys as keymod
from rmi_tpu_torch.data import RMIDataset
from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.models import get_model, validate_spec
from rmi_tpu_torch.models.base import Params
from rmi_tpu_torch.train import two_layer
from rmi_tpu_torch.utils import segments as seg


@dataclasses.dataclass
class TrainedRMI:
    """A trained two-layer RMI on one device.

    ``device_top_params`` [1, ppm] and ``device_leaf_params`` [B, ppm]
    are in the normalized key domain x' = (x - norm_offset) * norm_scale;
    an integer-output model's are a dict of tensors named as rmi_tpu's
    (radix and bradix ``w_int``, bradix ``high``, a hint-table top
    ``w_int`` and ``table``, hint-table leaves ``tables``, ``prefixes``
    and ``shifts``, histogram ``count``, ``pivots`` as key images and
    ``radix_index``), u64 values as int64 bits and tables as int32.
    ``leaf_errors`` [B] int64 bound |guess - lower_bound| per leaf.
    """

    models: str
    branching_factor: int
    key_type: KeyType
    num_rmi_rows: int
    device_top_params: Params
    device_leaf_params: Params
    leaf_errors: torch.Tensor
    model_avg_error: float
    model_avg_l2_error: float
    model_avg_log2_error: float
    model_max_error: int
    model_max_error_idx: int
    model_max_log2_error: float
    norm_offset: float
    norm_scale: float
    keys: torch.Tensor                 # [n] int64 images served over
    build_time: int = 0                # ns
    # serving state made on first use: lookup_fast's per-leaf (starts,
    # next_idx) and the search plan built from them, and lookup's table
    # of each leaf's row beside its error (eval_kernel.lookup_table)
    leaf_spans_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = \
        dataclasses.field(default=None, init=False, repr=False, compare=False)
    plan_cache: Optional[Any] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    lookup_table_cache: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def top_type(self) -> str:
        return self.models.split(",")[0]

    @property
    def leaf_type(self) -> str:
        return self.models.split(",")[1]


def _trained(data_keys, key_type, model_spec, B, out, build_time=0):
    return TrainedRMI(
        models=model_spec, branching_factor=int(B), key_type=key_type,
        num_rmi_rows=int(data_keys.shape[0]),
        device_top_params=out["top_w"], device_leaf_params=out["leaf_w"],
        leaf_errors=out["leaf_errors"], norm_offset=out["norm_offset"],
        norm_scale=out["norm_scale"], keys=data_keys, build_time=build_time,
        **out["metrics"])


def train(data: RMIDataset, model_spec: str, branch_factor: int) -> TrainedRMI:
    """Train a two-layer RMI (train/mod.rs:100-126) on ``data.keys.device``."""
    start = time.monotonic_ns()
    layers = model_spec.split(",")
    validate_spec(layers)
    top_type, leaf_type = layers
    out = two_layer.train_two_layer(data.keys, data.key_type, top_type,
                                    leaf_type, branch_factor)
    # the metrics transfer in train_two_layer has synchronized the device
    return _trained(data.keys, data.key_type, model_spec, branch_factor, out,
                    time.monotonic_ns() - start)


def _int_params_from_numpy(p: Dict[str, Any], dev) -> Dict[str, torch.Tensor]:
    """rmi_tpu's parameter dict of an integer-output model, numpy arrays,
    in the port's form: pivots as key images, u32 tables as int32, every
    other (u64) value's bits as int64."""
    out = {}
    for name, v in p.items():
        v = np.asarray(v)
        if name == "pivots":
            out[name] = keymod.to_image(v).to(dev)
        elif v.dtype == np.uint32:
            out[name] = torch.from_numpy(v.astype(np.int32)).to(dev)
        else:
            out[name] = torch.from_numpy(
                np.ascontiguousarray(v.astype(np.uint64).view(np.int64))).to(dev)
    return out


def trained_from_numpy(models: str, branching_factor: int, key_type: KeyType,
                       keys: np.ndarray, top_w: Union[np.ndarray, Dict[str, Any]],
                       leaf_w: Union[np.ndarray, Dict[str, Any]],
                       leaf_errors: np.ndarray, norm_offset: float,
                       norm_scale: float, device=None) -> TrainedRMI:
    """A port TrainedRMI serving an index built elsewhere, from numpy
    arrays: the JAX build's ``device_top_params["w"]`` [1, ppm],
    ``device_leaf_params["w"]`` [B, ppm], ``leaf_errors`` [B] and
    normalization constants, over the unsigned ``keys`` it was built on,
    on ``device`` (the card when None; the CPU only when asked for).
    Of a float model only the rows ``"w"`` cross over (cubic leaves:
    [B, 4], normal and lognormal: [B, 3]); rmi_tpu's generator aux waits
    for the artifacts (ROADMAP item 10).  An integer-output model's
    parameters cross over whole: pass rmi_tpu's parameter dict, its
    values as numpy arrays.  The metrics are recomputed from the leaf
    errors and the leaf counts that the top model assigns."""
    top_type, leaf_type = models.split(",")
    validate_spec([top_type, leaf_type])
    dev = config.require_cuda() if device is None else torch.device(device)
    keys_img = keymod.to_image(keys).to(dev)
    mtop, mleaf = get_model(top_type), get_model(leaf_type)
    B = int(branching_factor)
    if mtop.output_int:
        top = _int_params_from_numpy(top_w, dev)
    else:
        top = torch.tensor(np.asarray(top_w, np.float64), device=dev).reshape(1, -1)
    if mleaf.output_int:
        leaf = _int_params_from_numpy(leaf_w, dev)
        if leaf["tables"].shape[0] != B:
            raise ValueError(f"leaf_w['tables'] must have {B} rows")
    else:
        leaf = torch.tensor(np.asarray(leaf_w, np.float64), device=dev)
        if leaf.shape != (B, mleaf.ppm):
            raise ValueError(f"leaf_w must be [B, {mleaf.ppm}] for {leaf_type} "
                             f"leaves, not {list(leaf.shape)}")
    errs = torch.tensor(np.asarray(leaf_errors).astype(np.int64), device=dev)
    t = two_layer.top_assignment(mtop, top, keys_img, norm_offset,
                                 norm_scale, B - 1).to(torch.int32)
    spans = seg.make_spans(t, B)
    metrics = two_layer.error_metrics(errs, spans.ends - spans.starts,
                                      keys_img.shape[0])
    out = {"top_w": top, "leaf_w": leaf, "leaf_errors": errs,
           "metrics": metrics, "norm_offset": float(norm_offset),
           "norm_scale": float(norm_scale)}
    return _trained(keys_img, key_type, models, B, out)
