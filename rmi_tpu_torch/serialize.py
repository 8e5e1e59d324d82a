"""Artifacts and their size (counterpart of rmi_tpu/serialize.py).

An artifact is the reference's: binary parameter blobs
``<ns>_L<i>_PARAMETERS`` under ``rmi_data/`` (little-endian, each leaf's
error zipped after its parameters, codegen.rs:288-316) and a metadata
JSON, byte for byte what rmi_tpu writes for the same index, read by
``load_artifact`` (back onto the card), the native server
(native/rmi_native.cpp) and the generated C++ (codegen.py).

``rmi_size`` is codegen.rs:375-394: each layer's parameter bytes, 8 more
per leaf with the errors kept, 16 per cachefix knot.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from rmi_tpu_torch import config, convert
from rmi_tpu_torch import keys as keymod
from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.models import get_model
from rmi_tpu_torch.models.histogram import RADIX_INDEX_BITS


def _top_param_bytes(rmi) -> int:
    """Byte size of the single top model's parameter list."""
    m = get_model(rmi.top_type)
    if m.bytes_per_model is not None:
        return m.bytes_per_model
    if rmi.top_type == "histogram":
        tp = rmi.device_top_params
        num_bins = int(tp["count"].reshape(-1)[0])
        radix_len = int(tp["radix_index"].shape[0])
        return 8 * (1 + radix_len + num_bins)
    raise ValueError(f"unknown array-parameter model {rmi.top_type}")


def rmi_size(rmi) -> int:
    """In-memory artifact size in bytes (codegen.rs:375-394)."""
    total = _top_param_bytes(rmi)
    total += get_model(rmi.leaf_type).bytes_per_model * rmi.branching_factor
    if rmi.leaf_errors is not None:
        total += 8 * rmi.branching_factor
    if rmi.cache_fix is not None:
        total += 16 * len(rmi.cache_fix[1])
    return total


def predicted_rmi_size(models: str, branching_factor: int,
                       with_errors: bool = True) -> int:
    """rmi_size from the configuration alone, for every pair whose size
    the shapes fix: all but a histogram top (its bin count follows the
    data) and cachefix (its knots)."""
    top_type, leaf_type = models.split(",")
    mt = get_model(top_type)
    if mt.bytes_per_model is None:
        raise ValueError(f"{top_type} has data-dependent size; "
                         "train and use rmi_size()")
    total = mt.bytes_per_model + get_model(leaf_type).bytes_per_model * branching_factor
    if with_errors:
        total += 8 * branching_factor
    return total


def _saved_size(rmi, inc: bool) -> int:
    """RMI_SIZE of what is saved: without the errors when they are left out."""
    size = rmi_size(rmi)
    return size if inc or rmi.leaf_errors is None else size - 8 * rmi.branching_factor


# ---------------------------------------------------------------------------
# binary parameter blobs (little-endian, the reference's layout)
# ---------------------------------------------------------------------------

def top_layer_blob(rmi) -> Optional[bytes]:
    """Layer 0's blob, or None where the reference keeps the layer as
    constants in the header (scalar parameters, codegen.rs:57-62)."""
    t = rmi.top_type
    tp = rmi.raw_top
    if t == "histogram":
        return b"".join([np.uint64(int(np.asarray(tp["count"]).reshape(-1)[0])).tobytes(),
                         np.asarray(tp["radix_index"], dtype="<u8").tobytes(),
                         np.asarray(tp["pivots"], dtype="<u8").tobytes()])
    if t.startswith("radix") and t != "radix":
        return np.asarray(tp["table"], dtype="<u4").tobytes()
    return None


def top_constants(rmi):
    """Scalar top parameters as (c_type, value) pairs, for the generated
    header and the metadata."""
    t = rmi.top_type
    tp = rmi.raw_top
    if t in ("linear", "robust_linear", "linear_spline", "loglinear"):
        w = np.asarray(tp["w"]).reshape(-1)
        return [("double", float(w[0])), ("double", float(w[1]))]
    if t == "cubic":
        w = np.asarray(tp["w"]).reshape(-1)
        return [("double", float(w[i])) for i in range(4)]
    if t in ("normal", "lognormal"):
        w = np.asarray(tp["w"]).reshape(-1)
        return [("double", float(w[i])) for i in range(3)]
    if t == "radix":
        w = np.asarray(tp["w_int"]).reshape(-1)
        return [("uint64_t", int(w[0])), ("uint64_t", int(w[1]))]
    if t == "bradix":
        w = np.asarray(tp["w_int"]).reshape(-1)
        return [("uint64_t", int(w[i])) for i in range(3)]
    return []


def leaf_layer_blob(rmi, include_errors: bool) -> bytes:
    """Layer 1's blob: per leaf its ppm f64 parameters, then (optionally)
    its u64 max error (codegen.rs:288-316).  Hint-table leaves write
    per-leaf records [u64 prefix | u32 table | (u64 max_err)], rmi_tpu's
    correction of the reference, whose emitted radix_table bakes one
    prefix into shared code (radix.rs:146-160)."""
    errs = rmi.host_leaf_errors
    inc = include_errors and errs is not None
    raw_leaf = rmi.raw_leaf
    if isinstance(raw_leaf, dict):
        tables = np.asarray(raw_leaf["tables"], dtype="<u4")
        prefixes = np.asarray(raw_leaf["prefixes"], dtype="<u8")
        B, size = tables.shape
        rec = np.zeros((B, 2 + size + (2 if inc else 0)), dtype="<u4")
        rec[:, 0:2] = prefixes[:, None].view("<u4").reshape(B, 2)
        rec[:, 2:2 + size] = tables
        if inc:
            rec[:, 2 + size:] = np.asarray(errs, dtype="<u8")[:, None].view(
                "<u4").reshape(B, 2)
        return rec.tobytes()
    params = np.asarray(raw_leaf, dtype=np.float64)
    B, ppm = params.shape
    if inc:
        rec = np.zeros((B, ppm + 1), dtype="<u8")
        rec[:, :ppm] = params.astype("<f8").view("<u8")
        rec[:, ppm] = np.asarray(errs, dtype=np.uint64)
        return rec.tobytes()
    return params.astype("<f8").tobytes()


def cachefix_blob(rmi) -> Optional[bytes]:
    """The spline knots as packed (u64 key, u64 value) pairs
    (codegen.rs:407-410, 487-496)."""
    if rmi.cache_fix is None:
        return None
    _, sk, sv = rmi.cache_fix
    rec = np.zeros((len(sk), 2), dtype="<u8")
    rec[:, 0] = sk
    rec[:, 1] = sv
    return rec.tobytes()


# ---------------------------------------------------------------------------
# save and load
# ---------------------------------------------------------------------------

def _write(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)


def save_artifact(rmi, namespace: str, data_dir: str = "rmi_data",
                  include_errors: bool = True) -> str:
    """Write the binary parameter files and the metadata JSON; returns the
    metadata's path."""
    os.makedirs(data_dir, exist_ok=True)
    layers = []
    blob0 = top_layer_blob(rmi)
    if blob0 is not None:
        p = os.path.join(data_dir, f"{namespace}_L0_PARAMETERS")
        _write(p, blob0)
        layers.append({"index": 0, "kind": "array",
                       "file": os.path.basename(p), "bytes": len(blob0)})
    else:
        consts = top_constants(rmi)
        layers.append({"index": 0, "kind": "constant",
                       "values": [v for (_t, v) in consts],
                       "c_types": [t for (t, _v) in consts]})

    inc = include_errors and rmi.leaf_errors is not None
    blob1 = leaf_layer_blob(rmi, inc)
    p1 = os.path.join(data_dir, f"{namespace}_L1_PARAMETERS")
    _write(p1, blob1)
    layer1_meta = {"index": 1, "kind": "array", "file": os.path.basename(p1),
                   "bytes": len(blob1),
                   "params_per_model": get_model(rmi.leaf_type).ppm + (1 if inc else 0),
                   "zipped_errors": inc}
    if isinstance(rmi.raw_leaf, dict):
        layer1_meta["leaf_table_bits"] = int(
            np.log2(np.asarray(rmi.raw_leaf["tables"]).shape[1]))
    layers.append(layer1_meta)

    meta = {
        "namespace": namespace,
        "models": rmi.models,
        "norm_offset": rmi.norm_offset,
        "norm_scale": rmi.norm_scale,
        "branching_factor": rmi.branching_factor,
        "key_type": rmi.key_type.value,
        "num_rmi_rows": rmi.num_rmi_rows,
        "num_data_rows": rmi.num_data_rows,
        "rmi_size": _saved_size(rmi, inc),
        "build_time_ns": int(rmi.build_time),
        "include_errors": inc,
        "layers": layers,
        "metrics": {
            "model_max_error": rmi.model_max_error,
            "model_max_error_idx": rmi.model_max_error_idx,
            "model_avg_error": rmi.model_avg_error,
            "model_avg_l2_error": rmi.model_avg_l2_error,
            "model_avg_log2_error": rmi.model_avg_log2_error,
            "model_max_log2_error": rmi.model_max_log2_error,
        },
    }
    tp = rmi.raw_top
    if rmi.top_type == "histogram":
        meta["histogram"] = {"num_bins": int(np.asarray(tp["count"]).reshape(-1)[0]),
                             "radix_bits": RADIX_INDEX_BITS}
    if rmi.top_type.startswith("radix") and rmi.top_type != "radix":
        w = np.asarray(tp["w_int"]).reshape(-1)
        meta["radix_table"] = {"prefix": int(w[0]), "bits": int(w[1])}
    if rmi.top_type == "bradix":
        meta["bradix_high"] = bool(int(np.asarray(tp["high"]).reshape(-1)[0]))
    if rmi.cache_fix is not None:
        cfp = os.path.join(data_dir, f"{namespace}_L2_PARAMETERS")
        _write(cfp, cachefix_blob(rmi))
        meta["cache_fix"] = {"line_size": rmi.cache_fix[0],
                             "num_points": len(rmi.cache_fix[1]),
                             "file": os.path.basename(cfp)}

    meta_path = os.path.join(data_dir, f"{namespace}.json")
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=1)
    return meta_path


def _leaf_layer_from_file(layer1, data_dir, B, ppm):
    """(raw leaf parameters, leaf errors u64 or None) from layer 1's blob."""
    path = os.path.join(data_dir, layer1["file"])
    inc = bool(layer1.get("zipped_errors"))
    if "leaf_table_bits" in layer1:
        # hint-table leaves: [u64 prefix | u32 table | (u64 err)] per leaf
        size = 1 << layer1["leaf_table_bits"]
        raw4 = np.fromfile(path, dtype="<u4").reshape(B, 2 + size + (2 if inc else 0))
        prefixes = raw4[:, 0:2].copy().view("<u8").reshape(B)
        errs = raw4[:, 2 + size:].copy().view("<u8").reshape(B) if inc else None
        tb = np.uint64(layer1["leaf_table_bits"])
        shifts = np.where(prefixes + tb > 64, np.uint64(0), np.uint64(64) - prefixes - tb)
        return ({"tables": raw4[:, 2:2 + size].copy(), "prefixes": prefixes,
                 "shifts": shifts.astype(np.uint64)}, errs)
    raw = np.fromfile(path, dtype="<u8").reshape(B, layer1["params_per_model"])
    return raw[:, :ppm].copy().view("<f8"), raw[:, ppm].copy() if inc else None


def _top_layer_from_file(meta, layer0, data_dir, top_type):
    """The raw top parameters, rmi_tpu's dict, from layer 0."""
    if layer0["kind"] == "constant":
        vals = layer0["values"]
        if top_type in ("radix", "bradix"):
            tp = {"w_int": np.asarray(vals, dtype=np.uint64)}
            if top_type == "bradix":
                tp["high"] = np.uint64(1 if meta.get("bradix_high") else 0)
            return tp
        return {"w": np.asarray(vals, dtype=np.float64).reshape(1, -1)}
    blob = np.fromfile(os.path.join(data_dir, layer0["file"]), dtype=np.uint8)
    if top_type == "histogram":
        num_bins = meta["histogram"]["num_bins"]
        u = blob.view("<u8")
        radix_len = (1 << meta["histogram"]["radix_bits"]) + 1
        return {"count": np.uint64(num_bins),
                "radix_index": u[1:1 + radix_len].copy(),
                "pivots": u[1 + radix_len:1 + radix_len + num_bins].copy()}
    rt = meta["radix_table"]               # a hint-table top
    return {"w_int": np.asarray([rt["prefix"], rt["bits"]], dtype=np.uint64),
            "table": blob.view("<u4").copy()}


def load_artifact(meta_path: str, keys: Optional[torch.Tensor] = None,
                  device=None):
    """A servable port TrainedRMI from an artifact (the port's or
    rmi_tpu's), its parameters on ``device``: the card when None, the CPU
    only when asked for.  ``keys``, the sorted key images the index was
    built on, lets ``search`` serve through the index's plans as after
    ``train``; a cachefix index serves over its knots, and its ``search``
    takes the original keys as an argument."""
    from rmi_tpu_torch.train.api import TrainedRMI, _int_params_from_numpy

    with open(meta_path) as f:
        meta = json.load(f)
    dev = config.require_cuda() if device is None else torch.device(device)
    data_dir = os.path.dirname(meta_path)
    top_type, leaf_type = meta["models"].split(",")
    B = meta["branching_factor"]
    layer0 = next(layer for layer in meta["layers"] if layer["index"] == 0)
    layer1 = next(layer for layer in meta["layers"] if layer["index"] == 1)
    raw_leaf, errs = _leaf_layer_from_file(layer1, data_dir, B,
                                           get_model(leaf_type).ppm)
    raw_top = _top_layer_from_file(meta, layer0, data_dir, top_type)

    cache_fix = None
    if "cache_fix" in meta:
        cf = meta["cache_fix"]
        rec = np.fromfile(os.path.join(data_dir, cf["file"]), dtype="<u8").reshape(-1, 2)
        cache_fix = (cf["line_size"], rec[:, 0].copy(), rec[:, 1].copy())
        keys = keymod.to_image(cache_fix[1])      # the RMI serves over the knots

    kmin = meta.get("norm_offset", 0.0)
    s = meta.get("norm_scale", 1.0)
    if isinstance(raw_leaf, dict):
        dev_leaf = _int_params_from_numpy(raw_leaf, dev)
    else:
        dev_leaf = torch.from_numpy(convert.device_leaf_params(
            leaf_type, raw_leaf, kmin, s)).to(dev)
    if get_model(top_type).output_int:
        dev_top = _int_params_from_numpy(raw_top, dev)
    else:
        dev_top = torch.from_numpy(np.ascontiguousarray(convert.device_top_params(
            top_type, raw_top, kmin, s)["w"], dtype=np.float64)).reshape(1, -1).to(dev)
    m = meta["metrics"]
    return TrainedRMI(
        models=meta["models"], branching_factor=B,
        key_type=KeyType(meta["key_type"]), num_rmi_rows=meta["num_rmi_rows"],
        device_top_params=dev_top, device_leaf_params=dev_leaf,
        leaf_errors=None if errs is None else torch.from_numpy(
            errs.view(np.int64)).to(dev),
        model_avg_error=m["model_avg_error"],
        model_avg_l2_error=m["model_avg_l2_error"],
        model_avg_log2_error=m["model_avg_log2_error"],
        model_max_error=m["model_max_error"],
        model_max_error_idx=m["model_max_error_idx"],
        model_max_log2_error=m["model_max_log2_error"],
        norm_offset=kmin, norm_scale=s, keys=None if keys is None else keys.to(dev),
        build_time=meta["build_time_ns"], num_data_rows=meta["num_data_rows"],
        cache_fix=cache_fix, host_cache=(raw_top, raw_leaf, errs))


def output_rmi(namespace: str, rmi, data_dir: str = "rmi_data",
               include_errors: bool = True, emit_cpp: bool = True,
               cpp_dir: str = ".") -> str:
    """The whole artifact (codegen.rs:757-788): blobs and metadata, and the
    generated C++ sources unless ``emit_cpp`` is False."""
    meta_path = save_artifact(rmi, namespace, data_dir, include_errors=include_errors)
    if emit_cpp:
        from rmi_tpu_torch import codegen
        codegen.generate_cpp(namespace, rmi, out_dir=cpp_dir,
                             include_errors=include_errors)
    return meta_path
