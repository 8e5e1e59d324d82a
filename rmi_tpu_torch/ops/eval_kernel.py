"""K4: clamped integer leaf predictions (csrc/eval.cu), in two forms with
one C entry point per leaf kernel (linear, cubic, loglinear, normal):

  leaf_eval_clamped   (x, leaf id) pairs -> clip(floor(leaf(x)), 0, bound):
                      the build's epsilon probes (bound n), and lookup's
                      leaf step for lognormal leaves;
  lookup_clamped      key images -> (guess, err): lookup whole, from the
                      key to the leaf's error, in one pass over a table
                      that holds each leaf's row beside its error
                      (lookup_table), made once per index.

Counterpart of rmi_tpu/ops/eval_kernel.py:leaf_eval_clamped.  Its leaf
evaluation is the one the error sweep (K3) measured the bounds with
(csrc/leaf_eval.cuh; models.base.leaf_predict in the plain version),
which is what makes |guess - lower_bound| <= err hold.  ``x`` is the
leaf kernel's input (models.base.kernel_input).
"""

from __future__ import annotations

import torch

from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.models.base import (clamp_int, get_model, kernel_input,
                                       leaf_predict, model_float_input,
                                       predict_clamped, predict_top_assignment)
from rmi_tpu_torch.ops import _build

# csrc/leaf_eval.cuh's RmiLeaf, in its order: the top kind rmi_lookup_* takes
LEAF_KERNELS = ("linear", "cubic", "loglinear", "normal")


def key_kind(key_type: KeyType) -> int:
    """csrc/eval.cu's RmiKey, the key_kind rmi_lookup_* takes: how the
    kernel decodes an image, 0 as a u64 key's (u32 images are u64 ones),
    1 as an f64 key's."""
    return 1 if key_type is KeyType.F64 else 0
MAX_BOUND = (1 << 31) - 1      # rmi_clamp_floor returns int32


def _check(x, w, leaf_ids, ppm):
    if x.dtype != torch.float64 or x.dim() != 1:
        raise ValueError("leaf_eval_clamped: x must be 1-D float64")
    if leaf_ids.dtype != torch.int64 or leaf_ids.shape != x.shape:
        raise ValueError("leaf_eval_clamped: leaf_ids must be int64 shaped like x")
    _check_table("leaf_eval_clamped", w, ppm)


def _check_table(name, w, ppm, rows=None):
    if w.dtype != torch.float64 or w.dim() != 2 or w.shape[1] != ppm:
        raise ValueError(f"{name}: w must be a [B, {ppm}] float64 table")
    if rows is not None and w.shape[0] != rows:
        raise ValueError(f"{name}: want {rows} rows, got {w.shape[0]}")


def _check_params(name, mdef, p, rows=None):
    """A layer's parameters: a float model's [rows, ppm] f64 table, an
    integer-output model's dict of tensors."""
    if not mdef.output_int:
        _check_table(name, p, mdef.ppm, rows)
    elif not isinstance(p, dict):
        raise ValueError(f"{name}: {mdef.name} parameters must be a dict of tensors")


def _check_card_table(name, w):
    if w.data_ptr() % 16:
        raise ValueError(f"{name}: the table must start on a 16-byte boundary")


def _head(t: torch.Tensor) -> int:
    """Elements of 8 bytes before ``t``'s first 16-byte boundary: 0 or 1."""
    return (t.data_ptr() % 16) // 8


def _empty_in_phase(m: int, dtype, like: torch.Tensor) -> torch.Tensor:
    """An [m] tensor whose element _head(like) starts on a 16-byte
    boundary when ``like``'s does (its elements of 4 or 8 bytes), so that
    the kernels write it in the pairs they read ``like`` in."""
    head = _head(like)
    return torch.empty(m + head, dtype=dtype, device=like.device)[head:]


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
    if x.is_cpu:
        return leaf_eval_clamped_plain(x, w, leaf_ids, bound, leaf_type=leaf_type)
    _check_card_table("leaf_eval_clamped", w)
    if not 0 <= bound <= MAX_BOUND:
        raise ValueError(f"leaf_eval_clamped: bound {bound} outside [0, 2^31)")
    if _head(x) != _head(leaf_ids):       # read in pairs from one phase
        x, leaf_ids = x.clone(), leaf_ids.clone()
    out = _empty_in_phase(x.shape[0], torch.int32, x)
    _build.launch(f"rmi_leaf_eval_{mdef.leaf_kernel}", x, w, leaf_ids, out,
                  x.shape[0], int(bound))
    return out


def fused_lookup(top_type: str, leaf_type: str) -> bool:
    """Whether lookup_clamped serves this pair with rmi_lookup_*: both
    models "affine".  A "raw" model (lognormal) takes max(ln x, 0) of the
    keys' raw values, which stays one torch function outside the kernels
    (CUDA's log differs from glibc's on a few keys; the build computed it
    so), so a lognormal top or leaf keeps the two-step route; so does an
    integer-output top or leaf (radix, bradix, the hint tables,
    histogram), which rmi_lookup_*'s top branch does not evaluate."""
    return get_model(top_type).input_domain == get_model(leaf_type).input_domain == "affine"


def lookup_steps(queries, top_w, leaf_w, leaf_errors, n: int, kminf: float,
                 s: float, top_type: str, leaf_type: str, leaf_eval,
                 key_type: KeyType = KeyType.U64):
    """lookup as separate steps: the top's model input and its leaf (the
    build's leaf assignment), the leaf's kernel input, ``leaf_eval`` (K4's
    per-element wrapper or its plain version) clamped to n - 1
    (codegen.rs:713-717), and the leaf's error, for images of
    ``key_type`` keys.  A hint-table leaf has no kernel: its prediction,
    clamp_int to n - 1 (rmi_tpu lookup.py:52-54), is plain torch on every
    device."""
    mtop, mleaf = get_model(top_type), get_model(leaf_type)
    x_top = model_float_input(mtop, queries, kminf, s, key_type)
    midx = predict_top_assignment(mtop, top_w, x_top, leaf_errors.shape[0] - 1)
    x_leaf = (x_top if mleaf.input_domain == mtop.input_domain
              else model_float_input(mleaf, queries, kminf, s, key_type))
    if mleaf.output_int:
        return clamp_int(mleaf.predict(leaf_w, midx, x_leaf), n - 1), leaf_errors[midx]
    guess = leaf_eval(kernel_input(mleaf, x_leaf), leaf_w, midx, n - 1,
                      leaf_type=leaf_type).long()
    return guess, leaf_errors[midx]


def lookup_clamped_plain(queries, top_w, leaf_w, leaf_errors, n: int, kminf: float,
                         s: float, *, top_type: str, leaf_type: str,
                         key_type: KeyType = KeyType.U64):
    """The plain PyTorch version: lookup_steps with K4's plain version."""
    return lookup_steps(queries, top_w, leaf_w, leaf_errors, n, kminf, s,
                        top_type, leaf_type, leaf_eval_clamped_plain, key_type)


def lookup_width(ppm: int) -> int:
    """f64 values of a lookup row for leaves of ``ppm`` parameters: the
    row, the error's bits, padding to whole 32-byte sectors (csrc/eval.cu
    lookup_width)."""
    return (ppm + 1 + 3) & ~3


def lookup_table(leaf_w, leaf_errors) -> torch.Tensor:
    """[B, lookup_width(ppm)] float64: row j holds leaf_w[j], then the
    bits of leaf_errors[j] (int64), then zeros.  rmi_lookup_* gathers a
    leaf's row and error in one 32-byte sector (two for cubic leaves)
    where two tables cost two sectors, each sector with one load
    instruction.  Made from the bits, so every value and error crosses
    unchanged."""
    B, ppm = leaf_w.shape
    rows = torch.zeros(B, lookup_width(ppm), dtype=torch.int64, device=leaf_w.device)
    rows[:, :ppm] = leaf_w.view(torch.int64)
    rows[:, ppm] = leaf_errors
    return rows.view(torch.float64)


def lookup_clamped(queries, top_w, leaf_w, leaf_errors, n: int, kminf: float,
                   s: float, *, top_type: str, leaf_type: str, table=None,
                   key_type: KeyType = KeyType.U64):
    """(guess, err), both [m] int64, of int64 images ``queries`` of
    ``key_type`` keys under
    the index of ``n`` keys with top row ``top_w`` [1, ppm], leaf rows
    ``leaf_w`` [B, ppm] (an integer-output model's parameter dict
    instead), per-leaf errors ``leaf_errors`` [B] int64 and
    normalization (kminf, s).  ``table`` is lookup_table(leaf_w,
    leaf_errors) where the caller keeps one; else it is made here.

    Route, by the models' types: where fused_lookup holds, one launch of
    rmi_lookup_<leaf kernel>, which makes the top's input from the key
    (decoded as key_kind(key_type) says), evaluates the top (its kernel's
    rmi_leaf on row 0, the top kind a kernel argument), clamps the leaf
    id, gathers the leaf's row and error and evaluates the leaf; with a
    lognormal top or leaf, the two steps, the top and the kernel inputs
    in torch and the leaf in rmi_leaf_eval_<leaf kernel>, and ``table``
    is not read; so with an integer-output top, and with a hint-table
    leaf, whose step is plain torch (lookup_steps)."""
    mtop, mleaf = get_model(top_type), get_model(leaf_type)
    if queries.dtype != torch.int64 or queries.dim() != 1:
        raise ValueError("lookup_clamped: queries must be 1-D int64 key images")
    if leaf_errors.dtype != torch.int64 or leaf_errors.dim() != 1:
        raise ValueError("lookup_clamped: leaf_errors must be [B] int64")
    B = leaf_errors.shape[0]
    _check_params("lookup_clamped", mtop, top_w, rows=1)
    _check_params("lookup_clamped", mleaf, leaf_w, rows=B)
    if queries.is_cpu:
        return lookup_clamped_plain(queries, top_w, leaf_w, leaf_errors, n, kminf, s,
                                    top_type=top_type, leaf_type=leaf_type,
                                    key_type=key_type)
    if not fused_lookup(top_type, leaf_type):
        return lookup_steps(queries, top_w, leaf_w, leaf_errors, n, kminf, s,
                            top_type, leaf_type, leaf_eval_clamped, key_type)
    if table is None:
        table = lookup_table(leaf_w, leaf_errors)
    _check_table("lookup_clamped", table, lookup_width(mleaf.ppm), rows=B)
    _check_card_table("lookup_clamped", table)
    _check_card_table("lookup_clamped", top_w)
    if not 1 <= n <= MAX_BOUND + 1 or B > MAX_BOUND + 1:
        raise ValueError("lookup_clamped: n and B must lie in [1, 2^31]")
    m = queries.shape[0]
    guess = _empty_in_phase(m, torch.int64, queries)
    err = _empty_in_phase(m, torch.int64, queries)
    _build.launch(f"rmi_lookup_{mleaf.leaf_kernel}", queries, key_kind(key_type),
                  top_w, LEAF_KERNELS.index(mtop.leaf_kernel), table, guess, err, m,
                  B, int(n), float(kminf), float(s))
    return guess, err
