"""Bit-manipulation models: radix, balanced radix (bradix) and the radix
hint tables radix8/18/22/26/28 (counterpart of rmi_tpu/models/radix.py;
radix.rs, balanced_radix.rs of the reference).

They compute on the keys' u64 bits (keys.u64_bits of the integer-key
images they take: of f64 keys the images of their as_int values,
keys.int_image, as rmi_tpu's compute on as_int of the raw float) and
predict u64 values, held in int64.  Each one's bucket is non-decreasing
over the sorted keys, so a histogram of the buckets or a table of the
first key at or above each bucket is a searchsorted of the slots into
the buckets.  radix and bradix are top models; a hint table is a top or
a leaf layer.
"""

from __future__ import annotations

import torch

from rmi_tpu_torch import keys as keymod
from rmi_tpu_torch.keys import shl, shr, u64_bits
from rmi_tpu_torch.models.base import ModelDef, Restriction, register
from rmi_tpu_torch.utils import segments as seg


def num_bits(largest: torch.Tensor) -> torch.Tensor:
    """The reference's loop ``while (1 << (nbits + 1)) - 1 <= largest``
    (utils.rs:13-21) as a count of the thresholds it passes, at least 1
    (the reference asserts nbits >= 1), of a 0-dim u64 ``largest``."""
    j = torch.arange(63, device=largest.device)
    thresholds = shl(torch.ones_like(j), j + 1) - 1
    return (~keymod.ult(largest, thresholds)).sum().clamp(min=1)


def common_prefix_size(keys: torch.Tensor) -> torch.Tensor:
    """Leading bits that no key of the sorted images ``keys`` varies
    (utils.rs:23-36), 0-dim: over sorted keys the OR and AND sweeps of
    rmi_tpu reduce to clz(first ^ last), and images xor as the keys do."""
    return keymod.clz64(keys[0] ^ keys[-1])


def _scaled_largest(ys: torch.Tensor) -> torch.Tensor:
    """The largest scaled target, the last (targets are non-decreasing),
    as u64."""
    return ys[-1].to(torch.int64)


# ---------------------------------------------------------------------------
# radix (radix.rs:13-81)
# ---------------------------------------------------------------------------

def _radix_fit_top(keys, ys, B, scale):
    return {"w_int": torch.stack([common_prefix_size(keys),
                                  num_bits(_scaled_largest(ys))])}


def _radix_predict(params, leaf_ids, keys):
    prefix, bits = params["w_int"].unbind()
    res = shr(shl(u64_bits(keys), prefix), 64 - bits)
    return torch.where(bits == 0, 0, res)


register(ModelDef(
    name="radix", ppm=2, fit_top=_radix_fit_top, fit_leaves=None,
    predict=_radix_predict, constant_params=None, leaf_kernel=None,
    bytes_per_model=16, function_name="radix", input_domain="int",
    output_int=True, restriction=Restriction.MUST_BE_TOP, leaf_capable=False,
    needs_bounds_check=False))


# ---------------------------------------------------------------------------
# bradix: balanced radix (balanced_radix.rs:20-170)
# ---------------------------------------------------------------------------

def _shift_low(res, clamp):
    """A radix bucket shifted low: res - clamp, 0 below it, in u64 (the
    clamped-high one is umin(res, clamp))."""
    return torch.where(keymod.ult(res, clamp), 0, res - clamp)


def _bradix_fit_top(keys, ys, B, scale):
    """bradix_fit over the whole array."""
    return bradix_fit(u64_bits(keys), _scaled_largest(ys), common_prefix_size(keys),
                      keys.shape[0], B, lambda bucket: seg.sorted_starts(bucket, B + 1))


def bradix_fit(ki, max_output, prefix, n: int, B: int, bucket_starts):
    """Try {bits, bits + 1} x {clamp high, shift low} and keep the
    candidate of least chi^2 against uniform bucket counts, the first of
    equal ones (balanced_radix.rs:39-85), for the u64 bits ``ki`` of n
    sorted keys, their common prefix and the largest scaled target
    ``max_output`` (< B).  ``bucket_starts(bucket)`` is [B + 1]
    #{keys whose bucket < j} of all n keys, for the non-decreasing
    buckets of ``ki``: a searchsorted of the slots into them (the
    data-parallel build adds it up across shards).  Buckets past
    max_output - 1 are clipped into the last bin where the reference would
    index out of its Vec (rmi_tpu's documented divergence).  The chi^2 sum
    adds as rmi_tpu's does on the CPU (segments.whole_array_sum), so near
    ties resolve as there."""
    bits = num_bits(max_output)
    live = keymod.ult(torch.arange(B, device=ki.device), max_output)
    e = float(n) / max_output.double().clamp(min=1.0)
    last_bin = max_output.clamp(min=1) - 1

    def chi2(bucket):
        bounds = bucket_starts(keymod.umin(bucket, last_bin))
        counts = (bounds[1:] - bounds[:B]).double()
        return seg.whole_array_sum(torch.where(live, (counts - e) ** 2 / e, 0.0), 0, B)[0]

    scores, cands = [], []
    for db in (0, 1):                  # test_bits in bits..min(bits + 2, 64)
        tb = (bits + db).clamp(max=63)
        valid = bits + db < 64
        res = shr(shl(ki, prefix), 64 - tb)
        bits_max = shl(torch.ones_like(tb), tb + 1) - 1
        # u64 wraps, as release Rust's do
        for high, clamp in ((1, max_output - 1), (0, max_output - bits_max)):
            score = chi2(keymod.umin(res, clamp) if high else _shift_low(res, clamp))
            scores.append(torch.where(valid, score, torch.inf))
            cands.append(torch.stack([prefix, tb, clamp, torch.ones_like(tb) * high]))
        del res
    w = torch.stack(cands)[torch.argmin(torch.stack(scores))]
    return {"w_int": w[:3], "high": w[3]}


def _bradix_predict(params, leaf_ids, keys):
    prefix, bits, clamp = params["w_int"].unbind()
    res = shr(shl(u64_bits(keys), prefix), 64 - bits)
    return torch.where(params["high"] != 0, keymod.umin(res, clamp),
                       _shift_low(res, clamp))


register(ModelDef(
    name="bradix", ppm=3, fit_top=_bradix_fit_top, fit_leaves=None,
    predict=_bradix_predict, constant_params=None, leaf_kernel=None,
    bytes_per_model=24, function_name="bradix", input_domain="int",
    output_int=True, restriction=Restriction.MUST_BE_TOP, leaf_capable=False,
    needs_bounds_check=False))


# ---------------------------------------------------------------------------
# radix hint tables: radix8/18/22/26/28 (radix.rs:83-170)
# ---------------------------------------------------------------------------

def _table_bucket(ki, prefix, shift):
    """((x << prefix) >> prefix) >> shift (radix.rs:126-133): the bits
    below the prefix, masked off, then the table's bits of them."""
    return shr(ki & shr(torch.full_like(prefix, -1), prefix), shift)


def _table_shift(prefix, bits: int):
    """64 - prefix - bits, or 0 where the prefix leaves fewer than
    ``bits`` bits."""
    return torch.where(prefix + bits > 64, 0, 64 - prefix - bits)


def _make_table_fit_top(bits: int):
    def fit(keys, ys, B, scale):
        """table[b] = the scaled target of the first key whose bucket is
        at least b; slots past the last key's bucket hold the table's
        size (hint_table.len(), radix.rs:111-113); slot 0 keeps its 0
        (the construction loop's last_radix starts at 0, so the first
        key never writes it, radix.rs:94-108).  int32: targets < 2^31.
        On the card the fit is rmi_top_table_fit (ops/top_kernel.
        top_table_fit), a thread a slot; this is its plain version."""
        n = keys.shape[0]
        prefix = common_prefix_size(keys)
        bucket = _table_bucket(u64_bits(keys), prefix, _table_shift(prefix, bits))
        size = 1 << bits
        first = seg.sorted_starts(bucket, size)
        slots = torch.arange(size, device=keys.device)
        table = torch.where(slots > bucket[-1], size,
                            ys[first.clamp(0, n - 1)].to(torch.int32))
        table[0] = 0
        return {"w_int": torch.stack([prefix, torch.full_like(prefix, bits)]),
                "table": table}
    return fit


# most entries of a hint-table leaf layer, B * 2^bits (256 MB as int32)
LEAF_TABLE_CAP = 1 << 26


def _make_table_fit_leaves(bits: int):
    def fit_leaves(keys, yfix, spans):
        """Per-leaf hint tables over the augmented spans (RadixTable::new
        per leaf, radix.rs:90-120).  Every key of a leaf's span shares
        the leaf's prefix clz(first ^ last), so "first key with bucket >=
        b" is a searchsorted of the VALUE threshold top_bits + (b <<
        shift) into all the keys, clipped into the leaf's span.  The
        prefix is kept per leaf, as rmi_tpu keeps it: the documented
        correction of the reference, whose generated code bakes one
        shared prefix into every leaf (radix.rs:146-160).  Empty leaves:
        prefix 0, table[0] = 0 and the size elsewhere."""
        n, B = spans.n, spans.B
        size = 1 << bits
        if B * size > LEAF_TABLE_CAP:
            raise ValueError(
                f"radix{bits} leaf layer needs {B} x {4 * size} bytes of "
                f"hint tables; reduce the branching factor or table bits")
        ki = u64_bits(keys)
        first, last = seg.aug_first_last(spans)
        kf, kl = ki[first], ki[last]
        empty = ~spans.nonempty
        prefix = torch.where(empty, 0, keymod.clz64(kf ^ kl))
        shift = _table_shift(prefix, bits)
        top_bits = kf & ~shr(torch.full_like(prefix, -1), prefix)   # the leaf's prefix bits
        bucket_last = _table_bucket(kl, prefix, shift)
        slots = torch.arange(size, device=keys.device)
        thresholds = top_bits[:, None] + (slots[None, :] << shift[:, None])   # u64, [B, size]
        # #{keys < threshold} (rmi_tpu's hier_count); u64_bits is its own
        # inverse, so this is the thresholds' images
        ss = torch.searchsorted(keys, u64_bits(thresholds).reshape(-1)).reshape(B, size)
        idx = torch.clamp(ss, spans.aug_starts[:, None],
                          (spans.aug_ends[:, None] - 1).clamp(min=0))
        table = torch.where(slots[None, :] > bucket_last[:, None], size,
                            yfix[idx.clamp(0, n - 1)])
        table[:, 0] = 0
        table = torch.where(empty[:, None] & (slots[None, :] > 0), size, table)
        return {"tables": table, "prefixes": prefix, "shifts": shift}
    return fit_leaves


def _table_predict(params, leaf_ids, keys):
    ki = u64_bits(keys)
    if "tables" in params:                     # a leaf layer
        tables = params["tables"]
        if leaf_ids is None:
            leaf_ids = torch.zeros_like(keys)
        leaf_ids = leaf_ids.long()
        bucket = _table_bucket(ki, params["prefixes"][leaf_ids],
                               params["shifts"][leaf_ids])
        return tables.view(-1)[leaf_ids * tables.shape[1] + bucket].long()
    prefix, bits = params["w_int"].unbind()
    return params["table"][_table_bucket(ki, prefix, _table_shift(prefix, bits))].long()


TABLE_BITS = (8, 18, 22, 26, 28)

for _bits in TABLE_BITS:
    register(ModelDef(
        name=f"radix{_bits}", ppm=1, fit_top=_make_table_fit_top(_bits),
        fit_leaves=_make_table_fit_leaves(_bits), predict=_table_predict,
        constant_params=None, leaf_kernel=None, bytes_per_model=4 * (1 << _bits),
        function_name="radix_table", input_domain="int", output_int=True,
        needs_bounds_check=False, table_bits=_bits))
