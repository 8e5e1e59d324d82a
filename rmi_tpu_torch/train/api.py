"""Training facade: ``train``, ``train_async`` and its PendingRMI,
``train_for_size``, ``train_bounded`` and the TrainedRMI result
(counterpart of rmi_tpu/train/api.py)."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from rmi_tpu_torch import config, convert, keys as keymod
from rmi_tpu_torch.data import RMIDataset
from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.models import get_model, validate_spec
from rmi_tpu_torch.models.base import Params
from rmi_tpu_torch.train import two_layer
from rmi_tpu_torch.utils import profiling, segments as seg


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
    ``leaf_errors`` [B] int64 bound |guess - lower_bound| per leaf (None
    for an artifact saved without them).

    ``raw_top`` and ``raw_leaf`` are the parameters in the reference's
    raw key domain and layout, numpy on the host, as the artifact, the
    generated C++ and the native server read them (rmi_tpu's
    ``top_params`` and ``leaf_params``): made on first use from the
    device parameters and ``raw_inputs`` (the cubic fits' generator
    statistics, the empty-leaf patch mask and its values next_idx) in
    one device-to-host transfer, with the leaf errors (``host_leaf_errors``).
    ``cache_fix`` is (line_size, knot keys, knot values) of a
    ``train_bounded`` index, whose RMI is built over the knots:
    ``num_rmi_rows`` counts the knots, ``num_data_rows`` the keys.
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
    keys: Optional[torch.Tensor]       # [n] int64 images served over
    build_time: int = 0                # ns
    num_data_rows: Optional[int] = None    # num_rmi_rows unless cache_fix
    cache_fix: Optional[Tuple[int, np.ndarray, np.ndarray]] = None
    raw_inputs: Optional[Dict[str, Any]] = dataclasses.field(
        default=None, repr=False, compare=False)
    # (raw_top, raw_leaf, host_leaf_errors), made on first use
    host_cache: Optional[Tuple[Any, Any, Optional[np.ndarray]]] = \
        dataclasses.field(default=None, repr=False, compare=False)
    # serving state made on first use: lookup_fast's per-leaf (starts,
    # next_idx) and the search plan built from them, and lookup's table
    # of each leaf's row beside its error (eval_kernel.lookup_rows: under a
    # folded hint table one row a bucket) with its top's kernel arguments
    # and route (eval_kernel.top_operands)
    leaf_spans_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = \
        dataclasses.field(default=None, init=False, repr=False, compare=False)
    plan_cache: Optional[Any] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    lookup_table_cache: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    lookup_top_cache: Optional[Tuple[Any, ...]] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    # a cache_fix index's knot values on its device, and on the card the
    # knots' sample its interpolation searches first
    # (ops/cachefix_kernel.knot_sample)
    spline_vals_cache: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    knot_sample_cache: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.num_data_rows is None:
            self.num_data_rows = self.num_rmi_rows

    @property
    def top_type(self) -> str:
        return self.models.split(",")[0]

    @property
    def leaf_type(self) -> str:
        return self.models.split(",")[1]

    @property
    def raw_top(self) -> Dict[str, np.ndarray]:
        return self._host()[0]

    @property
    def raw_leaf(self):
        return self._host()[1]

    @property
    def host_leaf_errors(self) -> Optional[np.ndarray]:
        return self._host()[2]

    def _host(self):
        if self.host_cache is None:
            self.host_cache = _raw_params(self)
        return self.host_cache


def to_host(tree):
    """``tree`` (tensors in nested dicts, lists and tuples) with every
    tensor as a numpy array, through ONE device-to-host copy per device:
    the tensors' bytes are packed into one buffer on their device."""
    flat = []

    def collect(x):
        if torch.is_tensor(x):
            flat.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                collect(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                collect(v)

    collect(tree)
    if not flat:
        return tree
    by_device = {}
    for i, t in enumerate(flat):
        by_device.setdefault(t.device, []).append(i)
    arrays = [None] * len(flat)
    for ids in by_device.values():
        buf = torch.cat([flat[i].detach().contiguous().reshape(-1).view(torch.uint8)
                         for i in ids]).cpu().numpy()
        at = 0
        for i in ids:
            t = flat[i]
            nbytes = t.numel() * t.element_size()
            dtype = torch.empty((), dtype=t.dtype).numpy().dtype
            # a copy: aligned, and free of the shared buffer
            arrays[i] = buf[at:at + nbytes].view(dtype).reshape(tuple(t.shape)).copy()
            at += nbytes
    it = iter(arrays)

    def rebuild(x):
        if torch.is_tensor(x):
            return next(it)
        if isinstance(x, dict):
            return {k: rebuild(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(rebuild(v) for v in x)
        return x

    return rebuild(tree)


def fetch_host(tree):
    """The one host-synchronizing transfer of a build's metrics, or of
    many builds' at once (rmi_tpu's ``_fetch_host``): to_host.  A named
    function so that tests can observe when the host waits."""
    return to_host(tree)


def numpy_int_params(p: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """An integer-output model's parameter dict, host copies of the port's
    tensors, in rmi_tpu's form: pivots from key images to u64 keys, int32
    tables as u32, every other value's int64 bits as u64 (the inverse of
    _int_params_from_numpy)."""
    out = {}
    for name, v in p.items():
        if name == "pivots":
            out[name] = v.view(np.uint64) ^ np.uint64(1 << 63)
        elif v.dtype == np.int32:
            out[name] = v.view(np.uint32)
        else:
            out[name] = v.view(np.uint64)
    return out


def _raw_params(rmi: "TrainedRMI"):
    """(raw_top, raw_leaf, leaf errors) on the host: rmi_tpu's raw_thunk
    (rmi_tpu/train/api.py:207-226) over one transfer of the device
    parameters, the raw inputs and the leaf errors."""
    top_type, leaf_type = rmi.top_type, rmi.leaf_type
    mtop, mleaf = get_model(top_type), get_model(leaf_type)
    inp = rmi.raw_inputs or {}
    for name, m in (("top_aux", mtop), ("leaf_aux", mleaf)):
        if m.fit_aux is not None and inp.get(name) is None:
            raise ValueError(f"{m.name}'s raw parameters need its fit's generator "
                             f"statistics ({name}), which this index does not carry")
    h = to_host((rmi.device_top_params, rmi.device_leaf_params, rmi.leaf_errors, inp))
    top_np, leaf_np, errs, inp = h
    kmin, s = rmi.norm_offset, rmi.norm_scale
    if mleaf.output_int:
        raw_leaf = numpy_int_params(leaf_np)
    else:
        patch = inp.get("patch")
        next_idx = inp.get("next_idx")
        raw_leaf = convert.raw_leaf_params(
            leaf_type, leaf_np, inp.get("leaf_aux"), patch,
            None if patch is None else next_idx.astype(np.float64), kmin, s)
    if mtop.output_int:
        raw_top = numpy_int_params(top_np)
    else:
        raw_top = convert.raw_top_params(top_type, {"w": top_np}, inp.get("top_aux"),
                                         kmin, s)
    return raw_top, raw_leaf, None if errs is None else errs.astype(np.uint64)


def _trained(data_keys, key_type, model_spec, B, out, build_time=0):
    """A TrainedRMI from train_two_layer's outputs, their metrics a dict."""
    return TrainedRMI(
        models=model_spec, branching_factor=int(B), key_type=key_type,
        num_rmi_rows=int(data_keys.shape[0]),
        device_top_params=out["top_w"], device_leaf_params=out["leaf_w"],
        leaf_errors=out["leaf_errors"], norm_offset=out["norm_offset"],
        norm_scale=out["norm_scale"], keys=data_keys, build_time=build_time,
        raw_inputs={k: out.get(k) for k in ("top_aux", "leaf_aux", "patch", "next_idx")},
        **out["metrics"])


@dataclasses.dataclass
class PendingRMI:
    """A build dispatched to the keys' device whose metrics have not
    reached the host (rmi_tpu's PendingRMI).

    ``metrics`` is error_metrics' [6] tensor on the device; ``result``
    fetches it (or takes ``prefetched``, its host copy from one
    fetch_host of many builds' metrics) and makes the TrainedRMI.  The
    build's parameters live as long as this object or its result."""

    models: str
    branching_factor: int
    data: RMIDataset
    start_ns: int
    out: dict
    _result: Optional[TrainedRMI] = dataclasses.field(default=None, repr=False)

    @property
    def metrics(self) -> torch.Tensor:
        return self.out["metrics"]

    def result(self, prefetched=None) -> TrainedRMI:
        if self._result is None:
            vals = fetch_host(self.out["metrics"]) if prefetched is None else prefetched
            out = dict(self.out, metrics=two_layer.metrics_dict(vals))
            self._result = _trained(self.data.keys, self.data.key_type, self.models,
                                    self.branching_factor, out,
                                    time.monotonic_ns() - self.start_ns)
        return self._result


def train_async(data: RMIDataset, model_spec: str, branch_factor: int,
                shared: Optional[dict] = None) -> PendingRMI:
    """Dispatch a two-layer build (train/mod.rs:100-126) on
    ``data.keys.device`` without waiting for its metrics.  ``shared`` is
    two_layer.shared_inputs of the same keys on the same device, which a
    sweep computes once for all its builds; the build is the same bits
    without it."""
    start = time.monotonic_ns()
    layers = model_spec.split(",")
    validate_spec(layers)
    top_type, leaf_type = layers
    with profiling.build_span(data.keys.device):
        out = two_layer.train_two_layer(data.keys, data.key_type, top_type, leaf_type,
                                        branch_factor, **(shared or {}))
    return PendingRMI(models=model_spec, branching_factor=int(branch_factor),
                      data=data, start_ns=start, out=out)


def train(data: RMIDataset, model_spec: str, branch_factor: int) -> TrainedRMI:
    """Train a two-layer RMI (train/mod.rs:100-126) on ``data.keys.device``:
    train_async, then its metrics' transfer."""
    return train_async(data, model_spec, branch_factor).result()


def train_for_size(data: RMIDataset, max_size: int) -> TrainedRMI:
    """--max-size (train/mod.rs:128-154): the Pareto search, then a build
    of the first configuration on its front (the most accurate first)
    smaller than ``max_size`` bytes; ``build_time`` covers the search."""
    from rmi_tpu_torch.optimizer import find_pareto_efficient_configs

    start = time.monotonic_ns()
    pareto = find_pareto_efficient_configs(data, restrict=1000)
    chosen = next((c for c in pareto if c.size < max_size), None)
    if chosen is None:
        raise RuntimeError(f"Could not find any configurations smaller than {max_size}")
    res = train(data, chosen.models, chosen.branching_factor)
    res.build_time = time.monotonic_ns() - start
    return res


def train_bounded(data: RMIDataset, model_spec: str, branch_factor: int,
                  line_size: int) -> TrainedRMI:
    """--bounded: the cachefix spline over the keys (u32 keys promoted to
    u64), then an RMI trained over its knots on the keys' device
    (train/mod.rs:156-184)."""
    from rmi_tpu_torch.cache_fix import cache_fix

    start = time.monotonic_ns()
    spline_keys, spline_vals = cache_fix(data.as_u64(), line_size)
    spline_ds = RMIDataset.from_numpy(spline_keys, KeyType.U64,
                                      device=data.keys.device)
    res = train(spline_ds, model_spec, branch_factor)
    res.cache_fix = (int(line_size), spline_keys, spline_vals)
    res.num_data_rows = data.n
    res.build_time = time.monotonic_ns() - start
    return res


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
                       norm_scale: float, device=None, top_aux=None,
                       leaf_aux=None, patch=None, next_idx=None,
                       metrics: Optional[Dict[str, Any]] = None) -> TrainedRMI:
    """A port TrainedRMI serving an index built elsewhere, from numpy
    arrays: the JAX build's ``device_top_params["w"]`` [1, ppm],
    ``device_leaf_params["w"]`` [B, ppm], ``leaf_errors`` [B] and
    normalization constants, over the ``keys`` it was built on (u32, u64
    or f64, of ``key_type``), on ``device`` (the card when None; the CPU
    only when asked for).
    Of a float model the rows ``"w"`` cross over (cubic leaves: [B, 4],
    normal and lognormal: [B, 3]), and for its raw parameters (the
    artifacts) what rmi_tpu's raw conversion reads: a cubic top's or
    leaves' generator statistics ``top_aux`` / ``leaf_aux`` (rmi_tpu's
    ``params["aux"]``), and the empty-leaf ``patch`` mask [B] with its
    values ``next_idx`` [B].  An integer-output model's parameters cross
    over whole: pass rmi_tpu's parameter dict, its values as numpy
    arrays (a histogram's pivots as rmi_tpu holds them: u64, of f64 keys
    their as_int values).  The metrics (the keys of metrics_dict) are
    recomputed from the leaf errors and the leaf counts that the top model
    assigns, unless given."""
    top_type, leaf_type = models.split(",")
    validate_spec([top_type, leaf_type])
    dev = config.require_cuda() if device is None else torch.device(device)
    mtop, mleaf = get_model(top_type), get_model(leaf_type)
    if mtop.output_int:
        top = _int_params_from_numpy(top_w, dev)
    else:
        top = torch.tensor(np.asarray(top_w, np.float64), device=dev).reshape(1, -1)
    if mleaf.output_int:
        leaf = _int_params_from_numpy(leaf_w, dev)
    else:
        leaf = torch.tensor(np.asarray(leaf_w, np.float64), device=dev)

    def tensors(a):
        if a is None:
            return None
        if isinstance(a, dict):
            return {k: tensors(v) for k, v in a.items()}
        return torch.from_numpy(np.array(a)).to(dev)

    return trained_from_tensors(
        models, branching_factor, key_type, keymod.to_image(keys).to(dev), top, leaf,
        torch.tensor(np.asarray(leaf_errors).astype(np.int64), device=dev),
        norm_offset, norm_scale, top_aux=tensors(top_aux), leaf_aux=tensors(leaf_aux),
        patch=tensors(patch), next_idx=tensors(next_idx), metrics=metrics)


def trained_from_tensors(models: str, branching_factor: int, key_type: KeyType,
                         keys_img: torch.Tensor, top_w: Params, leaf_w: Params,
                         leaf_errors: torch.Tensor, norm_offset: float,
                         norm_scale: float, top_aux=None, leaf_aux=None, patch=None,
                         next_idx=None, metrics: Optional[Dict[str, Any]] = None
                         ) -> TrainedRMI:
    """trained_from_numpy's tensor form: a TrainedRMI serving parameters
    already in the port's form (a float model's [1, ppm] / [B, ppm] f64
    rows, an integer-output model's dict of int64 bits and int32 tables)
    over the sorted key images ``keys_img``, all on one device, as
    parallel/dp_trainer.dp_train_two_layer returns them on each rank.
    The metrics are recomputed as trained_from_numpy's are, unless given."""
    top_type, leaf_type = models.split(",")
    validate_spec([top_type, leaf_type])
    mtop, mleaf = get_model(top_type), get_model(leaf_type)
    B = int(branching_factor)
    if mleaf.output_int:
        if leaf_w["tables"].shape[0] != B:
            raise ValueError(f"leaf_w['tables'] must have {B} rows")
    elif leaf_w.shape != (B, mleaf.ppm):
        raise ValueError(f"leaf_w must be [B, {mleaf.ppm}] for {leaf_type} "
                         f"leaves, not {list(leaf_w.shape)}")
    errs = leaf_errors.long()
    if metrics is None:
        t = two_layer.top_assignment(mtop, top_w, keys_img, norm_offset,
                                     norm_scale, B - 1, key_type)
        spans = seg.make_spans(t, B)
        metrics = two_layer.metrics_dict(fetch_host(two_layer.error_metrics(
            errs, spans.ends - spans.starts, keys_img.shape[0])))
    out = {"top_w": top_w, "leaf_w": leaf_w, "leaf_errors": errs,
           "metrics": dict(metrics), "norm_offset": float(norm_offset),
           "norm_scale": float(norm_scale), "top_aux": top_aux,
           "leaf_aux": leaf_aux, "patch": patch, "next_idx": next_idx}
    return _trained(keys_img, key_type, models, B, out)
