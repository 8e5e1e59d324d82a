"""K4: clamped integer leaf predictions (csrc/eval.cu), in two forms with
one C entry point per leaf kernel (linear, cubic, loglinear, normal):

  leaf_eval_clamped   (x, leaf id) pairs -> clip(floor(leaf(x)), 0, bound):
                      the build's epsilon probes (bound n), and lookup's
                      leaf step for lognormal leaves;
  lookup_clamped      key images -> (guess, err): lookup whole, from the
                      key to the leaf's error, in one pass over a table
                      that holds each leaf's row beside its error
                      (lookup_table), made once per index; the top an
                      affine one (its leaf kernel's evaluation) or an
                      integer-output one (radix, bradix, the hint tables,
                      histogram: csrc/int_top.cuh), whose parameters come
                      packed (top_operands), their operand staged on chip
                      where it fits (top_route).

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
# for an affine top, which its leaf kernel evaluates
LEAF_KERNELS = ("linear", "cubic", "loglinear", "normal")
# then csrc/int_top.cuh's RmiIntTop: the integer-output tops ("table": a
# radix hint table, radix8/18/22/26/28)
TOP_KINDS = LEAF_KERNELS + ("radix", "bradix", "table", "histogram")
# entries of an integer top's packed parameters (top_operands)
INT_PARAMS = {"radix": 2, "bradix": 4, "table": 2, "histogram": 0}


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
    """Whether lookup_clamped serves this pair with rmi_lookup_*: every
    pair but two kinds.  A "raw" model (lognormal) takes max(ln x, 0) of
    the keys' raw values, which stays one torch function outside the
    kernels (CUDA's log differs from glibc's on a few keys; the build
    computed it so), so a lognormal top or leaf keeps the two-step route;
    so does a hint-table leaf, which no kernel evaluates (its prediction
    is a table gather in torch, lookup_steps)."""
    mtop, mleaf = get_model(top_type), get_model(leaf_type)
    return mleaf.leaf_kernel is not None and "raw" not in (mtop.input_domain,
                                                           mleaf.input_domain)


def top_kind(top_type: str) -> int:
    """The top kind rmi_lookup_* takes for model ``top_type`` (TOP_KINDS)."""
    mtop = get_model(top_type)
    if not mtop.output_int:
        return TOP_KINDS.index(mtop.leaf_kernel)
    return TOP_KINDS.index("table" if mtop.function_name == "radix_table" else top_type)


# The routes of an integer top's operand (csrc/int_top.cuh RmiRoute):
# 0 read in place, through L1 and L2 (radix and bradix have none); 1 a
# histogram's pivots staged in each block's shared memory as their
# search tree, where one block holds it (BLOCK_BYTES: the trees are
# powers of two, so 16383 pivots, 128 KB, are the most); 2 a hint table
# folded into the lookup rows, one row a bucket, where those rows take
# at most FOLD_BYTES, a third of the H100's 50 MB L2 (radix18's 8 MB of
# folded rows beat its table in place, radix22's 128 MB lose to it:
# PERF.md §6).
IN_PLACE, BLOCK, FOLDED = 0, 1, 2
BLOCK_BYTES = 192 * 1024
FOLD_BYTES = 16 << 20


def table_width(B: int) -> int:
    """Bits of a narrowed hint-table entry under B leaves: 16 where every
    leaf id fits them (B <= 2^16), else 32 (csrc/int_top.cuh kNarrowLast)."""
    return 16 if B <= 1 << 16 else 32


def narrow_table(table: torch.Tensor, B: int) -> torch.Tensor:
    """A hint table as rmi_lookup_* reads it: each entry clamp_int(entry,
    B - 1), which the kernel took of every entry it read, in
    table_width(B) bits, two 16-bit entries to an int32 word (the even
    entry in the low half)."""
    t = clamp_int(table.long(), B - 1)
    if table_width(B) == 32:
        return t.to(torch.int32)
    words = t[0::2] | (t[1::2] << 16)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def unpack_table(words: torch.Tensor, B: int) -> torch.Tensor:
    """narrow_table's entries as int64 (its inverse on clamped entries)."""
    if table_width(B) == 32:
        return words.long()
    w = words.long() & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], 1).reshape(-1)


def operand_bytes(kind: str, length: int, row_bytes: int) -> int:
    """Bytes of an integer top's operand as a route would hold it: a
    histogram's ``length`` pivots as their complete search tree (2^h slots
    of 8 bytes, h the bit length of ``length``), a hint table's ``length``
    entries as folded lookup rows of ``row_bytes``; 0 for radix, bradix
    and an empty histogram, which read none."""
    if kind == "table":
        return length * row_bytes
    if kind == "histogram" and length:
        return 8 << length.bit_length()
    return 0


def top_route(kind: str, nbytes: int) -> int:
    """Where rmi_lookup_* reads an integer top's operand of ``nbytes``
    (operand_bytes): a histogram's tree in each block (BLOCK) where one
    block holds it, a hint table folded into the rows (FOLDED) where they
    fit FOLD_BYTES; else, and for no operand, in place (IN_PLACE)."""
    if kind == "histogram" and 0 < nbytes <= BLOCK_BYTES:
        return BLOCK
    if kind == "table" and nbytes <= FOLD_BYTES:
        return FOLDED
    return IN_PLACE


def _route(kind: str, length: int, leaf_type: str) -> int:
    """top_route of a ``kind`` operand of ``length`` entries over leaves of
    ``leaf_type`` (their lookup rows' bytes)."""
    row_bytes = 8 * lookup_width(get_model(leaf_type).ppm)
    return top_route(kind, operand_bytes(kind, length, row_bytes))


def route_name(top_type: str, route: int) -> str:
    """A lookup's route as chip_smoke logs it: "affine", "none" (radix,
    bradix), "l2", "block" or "folded"."""
    kind = TOP_KINDS[top_kind(top_type)]
    if kind in LEAF_KERNELS:
        return "affine"
    if kind in ("radix", "bradix"):
        return "none"
    return ("l2", "block", "folded")[route]


def top_operands(top_type: str, top_p, device, B: int, leaf_type: str):
    """(top_w, top_int, top_table, pivots, top_len, route): the top's
    arguments of rmi_lookup_* under B leaves of ``leaf_type``, empty where
    the kind reads none.  An affine top: its [1, ppm] row.  An integer
    top: its parameters packed in one int64 tensor (radix: prefix, bits;
    bradix: prefix, bits, clamp, high; a hint table: prefix, bits), a hint
    table's entries narrowed (narrow_table) or a histogram's pivot images,
    their count, and the route (top_route; FOLDED asks for lookup_rows'
    rows by bucket).  Made once per index (lookup keeps them); a bradix
    top's packing is one small torch.cat."""
    empty = [torch.empty(0, dtype=t, device=device)
             for t in (torch.float64, torch.int64, torch.int32)]
    f64, i64, i32 = empty
    kind = TOP_KINDS[top_kind(top_type)]
    if kind in LEAF_KERNELS:
        return top_p, i64, i32, i64, 0, IN_PLACE
    if kind == "histogram":
        length = top_p["pivots"].shape[0]
        return f64, i64, i32, top_p["pivots"], length, _route(kind, length, leaf_type)
    if kind == "table":
        length = top_p["table"].shape[0]
        return (f64, top_p["w_int"], narrow_table(top_p["table"], B), i64, length,
                _route(kind, length, leaf_type))
    if kind == "bradix":
        return (f64, torch.cat([top_p["w_int"], top_p["high"].reshape(1)]), i32, i64, 0,
                IN_PLACE)
    return f64, top_p["w_int"], i32, i64, 0, IN_PLACE


def _check_top_operands(top_type, leaf_type, operands, B):
    top_w, top_int, table, pivots, top_len, route = operands
    kind = TOP_KINDS[top_kind(top_type)]
    if kind in LEAF_KERNELS:
        _check_card_table("lookup_clamped", top_w)
        return
    if top_int.shape != (INT_PARAMS[kind],):
        raise ValueError(f"lookup_clamped: {top_type} takes {INT_PARAMS[kind]} packed "
                         f"parameters, not {list(top_int.shape)}")
    # a hint table holds 2^bits entries (bytes_per_model: 4 bytes each),
    # narrowed to table_width(B) bits
    want = (get_model(top_type).bytes_per_model // 4 if kind == "table"
            else pivots.shape[0] if kind == "histogram" else 0)
    if top_len != want or (kind == "table" and
                           table.shape != (want * table_width(B) // 32,)):
        raise ValueError(f"lookup_clamped: {top_type}'s table or pivots do not match "
                         f"their count {top_len} under {B} leaves")
    if route != _route(kind, top_len, leaf_type):
        raise ValueError(f"lookup_clamped: route {route} is not {top_type}'s over "
                         f"{B} {leaf_type} leaves")


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


def lookup_rows(leaf_w, leaf_errors, top_args, B: int) -> torch.Tensor:
    """The rows rmi_lookup_* reads: lookup_table(leaf_w, leaf_errors), or
    under a hint table folded into them (route FOLDED) one row a bucket,
    the row of the leaf the bucket's narrowed entry names."""
    rows = lookup_table(leaf_w, leaf_errors)
    if top_args[5] != FOLDED:
        return rows
    return rows[unpack_table(top_args[2], B)]


def lookup_clamped(queries, top_w, leaf_w, leaf_errors, n: int, kminf: float,
                   s: float, *, top_type: str, leaf_type: str, table=None,
                   top_args=None, key_type: KeyType = KeyType.U64):
    """(guess, err), both [m] int64, of int64 images ``queries`` of
    ``key_type`` keys under
    the index of ``n`` keys with top row ``top_w`` [1, ppm], leaf rows
    ``leaf_w`` [B, ppm] (an integer-output model's parameter dict
    instead), per-leaf errors ``leaf_errors`` [B] int64 and
    normalization (kminf, s).  ``top_args`` is top_operands(top_type,
    top_w, device, B, leaf_type) and ``table`` lookup_rows(leaf_w,
    leaf_errors, top_args, B) where the caller keeps them; else they are
    made here.

    Route, by the models' types: where fused_lookup holds, one launch of
    rmi_lookup_<leaf kernel>, which decodes the key (as key_kind(key_type)
    says), evaluates the top (an affine top's kernel's rmi_leaf on row 0,
    or an integer top on the key's u64 bits; the top kind a kernel
    argument; its operand read where top_args' route says), clamps the
    leaf id, gathers the leaf's row and error and evaluates the leaf on
    the normalized key; with a lognormal top or
    leaf, the two steps, the top and the kernel inputs in torch and the
    leaf in rmi_leaf_eval_<leaf kernel>, and ``table`` is not read; with
    a hint-table leaf, whose step is plain torch, lookup_steps."""
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
    if top_args is None:
        top_args = top_operands(top_type, top_w, queries.device, B, leaf_type)
    if table is None:
        table = lookup_rows(leaf_w, leaf_errors, top_args, B)
    _check_top_operands(top_type, leaf_type, top_args, B)
    _check_table("lookup_clamped", table, lookup_width(mleaf.ppm),
                 rows=top_args[4] if top_args[5] == FOLDED else B)
    _check_card_table("lookup_clamped", table)
    if not 1 <= n <= MAX_BOUND + 1 or B > MAX_BOUND + 1:
        raise ValueError("lookup_clamped: n and B must lie in [1, 2^31]")
    m = queries.shape[0]
    guess = _empty_in_phase(m, torch.int64, queries)
    err = _empty_in_phase(m, torch.int64, queries)
    _build.launch(f"rmi_lookup_{mleaf.leaf_kernel}", queries, key_kind(key_type),
                  top_args[0], top_kind(top_type), *top_args[1:], table, guess, err, m,
                  B, int(n), float(kminf), float(s))
    return guess, err
