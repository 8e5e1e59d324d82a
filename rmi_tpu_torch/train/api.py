"""Training facade: ``train`` and the TrainedRMI result (counterpart of
rmi_tpu/train/api.py:19-253)."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from rmi_tpu_torch import keys as keymod
from rmi_tpu_torch.data import RMIDataset
from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.models import get_model, validate_spec
from rmi_tpu_torch.train import two_layer
from rmi_tpu_torch.utils import segments as seg


@dataclasses.dataclass
class TrainedRMI:
    """A trained two-layer RMI on one device.

    ``device_top_params`` [1, ppm] and ``device_leaf_params`` [B, ppm]
    are in the normalized key domain x' = (x - norm_offset) * norm_scale;
    ``leaf_errors`` [B] int64 bound |guess - lower_bound| per leaf.
    """

    models: str
    branching_factor: int
    key_type: KeyType
    num_rmi_rows: int
    device_top_params: torch.Tensor
    device_leaf_params: torch.Tensor
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

    @property
    def top_type(self) -> str:
        return self.models.split(",")[0]


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


def trained_from_numpy(models: str, branching_factor: int, key_type: KeyType,
                       keys: np.ndarray, top_w: np.ndarray, leaf_w: np.ndarray,
                       leaf_errors: np.ndarray, norm_offset: float,
                       norm_scale: float, device=None) -> TrainedRMI:
    """A port TrainedRMI serving an index built elsewhere, from numpy
    arrays: the JAX build's ``device_top_params["w"]`` [1, ppm],
    ``device_leaf_params["w"]`` [B, ppm], ``leaf_errors`` [B] and
    normalization constants, over the unsigned ``keys`` it was built on.
    The metrics are recomputed from the leaf errors and the leaf counts
    that the top model assigns."""
    validate_spec(models.split(","))
    dev = torch.device("cpu") if device is None else torch.device(device)
    keys_img = keymod.to_image(keys).to(dev)
    top = torch.tensor(np.asarray(top_w, np.float64), device=dev).reshape(1, -1)
    leaf = torch.tensor(np.asarray(leaf_w, np.float64), device=dev)
    errs = torch.tensor(np.asarray(leaf_errors).astype(np.int64), device=dev)
    B = int(branching_factor)
    xn = two_layer.normalize(keys_img, norm_offset, norm_scale)
    t = two_layer.predict_top_assignment(get_model(models.split(",")[0]),
                                         top, xn, B - 1).to(torch.int32)
    spans = seg.make_spans(t, B)
    metrics = two_layer.error_metrics(errs, spans.ends - spans.starts,
                                      keys_img.shape[0])
    out = {"top_w": top, "leaf_w": leaf, "leaf_errors": errs,
           "metrics": metrics, "norm_offset": float(norm_offset),
           "norm_scale": float(norm_scale)}
    return _trained(keys_img, key_type, models, B, out)
