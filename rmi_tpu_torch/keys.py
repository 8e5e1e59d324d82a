"""Key/type system for rmi_tpu_torch (counterpart of rmi_tpu/keys.py).

torch has no usable unsigned 64-bit arithmetic on the CPU (no compare,
shift or subtract on uint64), so keys travel as their int64
ORDER-PRESERVING IMAGE: signed comparison of images is the comparison
of keys, so every sort, compare and searchsorted runs on the image
directly.

  * integer keys: ``u ^ 2^63``;
  * f64 keys: the IEEE bits viewed as int64, the low 63 bits of a
    negative value complemented (``ordered_u64(x) ^ 2^63`` of rmi_tpu,
    keys.py:240-262), with -0.0 mapped to +0.0's image 0 and every NaN
    to IMAGE_MIN, where rmi_tpu maps NaN to u64 0.  A bit view, not
    rmi_tpu's arithmetic image, which works round the TPU's missing
    64-bit bitcast and maps subnormals to zero's image; here a subnormal
    keeps its bits.  The decode is the exact inverse, and IMAGE_MIN
    decodes to a NaN.

``as_float`` is the key's f64 value.  Of an integer key it is the exact
u64 -> f64 cast (``*x as f64`` in the reference, models/mod.rs:421-426)
computed from the image by a 32-bit split: both halves convert exactly
and the single add rounds once, so the result is the correctly rounded
cast, bit-equal to numpy's.  Of an f64 key it is the decoded value.

The integer models (radix, bradix, the radix hint tables, histogram)
compute on the key's u64 BITS, ``u64_bits(image)``: the same 64 bits as
the unsigned key, held in an int64.  Adds, subtracts and bitwise
operations on them are the u64 ones; torch's int64 ``>>`` is
arithmetic and its compares are signed, so ``shr``, ``shl``, ``ult``,
``umin`` and ``clz64`` here give the unsigned shift, compare, minimum
and leading-zero count (counterparts of rmi_tpu/models/radix.py:52-63
and ``jax.lax.clz``).  ``as_int`` gives those bits for every key type:
an f64 key's is its value clipped to [0, 2^64 - 1] and truncated
(rmi_tpu/keys.py:265-274).
"""

from __future__ import annotations

import enum
import sys

import numpy as np
import torch

_SIGN = np.uint64(1 << 63)
IMAGE_MIN = -(1 << 63)            # image of u64 key 0, and of every f64 NaN
IMAGE_MAX = (1 << 63) - 1         # the largest image: no query is above it
_LOW32 = 0xFFFFFFFF
_LOW63 = (1 << 63) - 1
_F64_EPS = sys.float_info.epsilon  # f64::EPSILON = 2^-52


class KeyType(enum.Enum):
    """Key dtypes, chosen by file-name suffix (src/main.rs:122-132)."""

    U32 = "uint32"
    U64 = "uint64"
    F64 = "f64"

    @property
    def np_dtype(self):
        return {KeyType.U32: np.uint32, KeyType.U64: np.uint64,
                KeyType.F64: np.float64}[self]

    @property
    def c_type(self) -> str:
        """The key's type in generated C++ (models/mod.rs:46-53)."""
        return {KeyType.U32: "uint32_t", KeyType.U64: "uint64_t",
                KeyType.F64: "double"}[self]

    @property
    def itemsize(self) -> int:
        return 4 if self is KeyType.U32 else 8

    @property
    def is_float(self) -> bool:
        return self is KeyType.F64

    @property
    def max_value(self):
        """T::max_value() (models/mod.rs:81,93,105)."""
        if self is KeyType.F64:
            return sys.float_info.max
        return (1 << 32) - 1 if self is KeyType.U32 else (1 << 64) - 1

    @property
    def max_image(self) -> int:
        """The image of T::max_value()."""
        if self is KeyType.F64:
            return 0x7FEFFFFFFFFFFFFF        # the bits of f64::MAX, a positive value
        return image_of(self.max_value)

    @property
    def zero_image(self) -> int:
        """The image of T::zero_value() (models/mod.rs:79,91,103)."""
        return 0 if self is KeyType.F64 else IMAGE_MIN

    @classmethod
    def from_filename(cls, path: str) -> "KeyType":
        if "uint64" in path:
            return cls.U64
        if "uint32" in path:
            return cls.U32
        if "f64" in path:
            return cls.F64
        raise ValueError(
            f"Data file name must contain uint64, uint32, or f64: {path}")


def image_of(u: int) -> int:
    """int64 image of one unsigned key."""
    return u + IMAGE_MIN


def f64_image(x: torch.Tensor) -> torch.Tensor:
    """int64 images of f64 keys, on their device: the bits, a negative
    value's low 63 bits complemented, -0.0 -> 0, NaN -> IMAGE_MIN."""
    b = x.contiguous().view(torch.int64)
    img = torch.where(b < 0, b ^ _LOW63, b)
    img = torch.where(x == 0, 0, img)
    return torch.where(torch.isnan(x), IMAGE_MIN, img)


def f64_of_image(v: torch.Tensor) -> torch.Tensor:
    """The f64 keys of int64 images, f64_image's inverse (IMAGE_MIN
    decodes to a NaN): a bit view, no arithmetic on the value."""
    return torch.where(v < 0, v ^ _LOW63, v).view(torch.float64)


def to_image(arr: np.ndarray) -> torch.Tensor:
    """numpy keys -> int64 image tensor (CPU): f64 keys by f64_image,
    unsigned ones by u ^ 2^63."""
    if np.asarray(arr).dtype.kind == "f":
        return f64_image(torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float64)))
    u = np.ascontiguousarray(arr).astype(np.uint64, copy=False)
    return torch.from_numpy((u ^ _SIGN).view(np.int64))


def from_image(v: torch.Tensor, key_type: KeyType = KeyType.U64) -> np.ndarray:
    """int64 image tensor -> numpy keys of ``key_type``."""
    v = v.detach().cpu()
    if key_type is KeyType.F64:
        return f64_of_image(v).numpy()
    u = v.numpy().view(np.uint64) ^ _SIGN
    return u.astype(key_type.np_dtype)


def as_float(v: torch.Tensor, key_type: KeyType = KeyType.U64) -> torch.Tensor:
    """The f64 values of int64 images of ``key_type`` keys: an integer
    key's exact u64 -> f64 cast (one rounding), an f64 key decoded."""
    if key_type is KeyType.F64:
        return f64_of_image(v)
    hi = ((v >> 32) & _LOW32) ^ 0x80000000
    lo = v & _LOW32
    return hi.double() * 4294967296.0 + lo.double()


def as_int(v: torch.Tensor, key_type: KeyType = KeyType.U64) -> torch.Tensor:
    """ModelInput::as_int (models/mod.rs:428-433): the u64 bits, as
    int64, of int64 images of ``key_type`` keys.  An integer key's are
    its own; an f64 key's value is clipped to [0, 2^64 - 1] and truncated
    toward zero, as rmi_tpu's as_int converts (rmi_tpu/keys.py:265-274):
    values from 2^64 saturate to all ones and a NaN gives 0."""
    if key_type is not KeyType.F64:
        return u64_bits(v)
    f = f64_of_image(v)
    f = torch.where(torch.isnan(f), 0.0, f.clamp(0.0, 2.0 ** 64))
    top = f >= 2.0 ** 64
    high = f >= 2.0 ** 63
    # below 2^63 the value converts as it is; from 2^63 its distance to
    # 2^63 (exact: Sterbenz) converts and the top bit is set
    low = torch.where(high, f - 2.0 ** 63, f).masked_fill_(top, 0.0).long()
    return torch.where(top, -1, torch.where(high, low | IMAGE_MIN, low))


def int_image(v: torch.Tensor, key_type: KeyType = KeyType.U64) -> torch.Tensor:
    """The integer-key image of as_int(v): what the integer models take.
    Integer keys are their own; an f64 key's is the image of its
    truncated value, so the models and their tables compute on the same
    u64 bits as rmi_tpu's do on as_int of the raw float."""
    return u64_bits(as_int(v, key_type)) if key_type is KeyType.F64 else v


def u64_bits(v: torch.Tensor) -> torch.Tensor:
    """The unsigned keys' bits, as int64, of int64 images (and back: the
    map is its own inverse)."""
    return v ^ IMAGE_MIN


def _amount(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.int64, device=like.device)


def _below_64(a: torch.Tensor) -> torch.Tensor:
    """All ones where the shift amount a < 64, else 0: the mask that
    zeroes a shift of 64 or more."""
    return -(a < 64).long()


def shr(x: torch.Tensor, a) -> torch.Tensor:
    """Logical x >> a of u64 bits in int64, 0 for a shift of 64 or more:
    the arithmetic shift with the bits it fills from the sign cleared."""
    a = _amount(a, x)
    ac = a.clamp(0, 63)
    mask = ~((torch.full_like(ac, -1) << (63 - ac)) << 1) & _below_64(a)
    return (x >> ac) & mask


def shl(x: torch.Tensor, a) -> torch.Tensor:
    """x << a of u64 bits in int64, 0 for a shift of 64 or more (rmi_tpu
    radix.py:52-56: release Rust's shift, with its undefined case
    pinned)."""
    a = _amount(a, x)
    return (x << a.clamp(0, 63)) & _below_64(a)


def ult(a, b) -> torch.Tensor:
    """Unsigned a < b of u64 bits in int64: the signed compare of their
    images."""
    return (a ^ IMAGE_MIN) < (b ^ IMAGE_MIN)


def umin(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned min(a, b) of u64 bits in int64."""
    b = _amount(b, a)
    return torch.where(ult(b, a), b, a)


def clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading zero bits of u64 bits in int64, 64 for 0: a six-step
    search of the top half, quarter, ... that is zero (torch has no clz,
    and log2 of a float is inexact above 2^53)."""
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        zero = (x & -(1 << (64 - s))) == 0       # the top s bits
        n = n + torch.where(zero, s, 0)
        x = torch.where(zero, x << s, x)
    return torch.where(x == 0, 64, n)


def minus_epsilon(v: torch.Tensor, key_type: KeyType) -> torch.Tensor:
    """TrainingKey::minus_epsilon on images: an integer key less 1,
    saturating at 0 (models/mod.rs:78,90,449-454); an f64 key less the
    absolute f64::EPSILON (models/mod.rs:102), which leaves every key
    above ~2 unchanged, the reference's quirk (rmi_tpu/keys.py:120-128)."""
    if key_type is KeyType.F64:
        return f64_image(f64_of_image(v) - _F64_EPS)
    return torch.where(v > IMAGE_MIN, v - 1, v)


def plus_epsilon(v: torch.Tensor, key_type: KeyType) -> torch.Tensor:
    """TrainingKey::plus_epsilon on images: an integer key plus 1,
    saturating at T::max_value() (models/mod.rs:80,92); an f64 key plus
    the absolute f64::EPSILON (models/mod.rs:104)."""
    if key_type is KeyType.F64:
        return f64_image(f64_of_image(v) + _F64_EPS)
    mx = key_type.max_image
    return torch.where(v < mx, v + 1, v)
