"""Key/type system for rmi_tpu_torch (counterpart of rmi_tpu/keys.py).

torch has no usable unsigned 64-bit arithmetic on the CPU (no compare,
shift or subtract on uint64), so integer keys travel as their int64
ORDER-PRESERVING IMAGE ``u ^ 2^63``: signed comparison of images is
unsigned comparison of keys, so every sort, compare and searchsorted
runs on the image directly.

``as_float`` is the exact u64 -> f64 cast (``*x as f64`` in the
reference, models/mod.rs:421-426) computed from the image by a 32-bit
split: both halves convert exactly and the single add rounds once, so
the result is the correctly rounded cast, bit-equal to numpy's.

The integer models (radix, bradix, the radix hint tables, histogram)
compute on the key's u64 BITS, ``u64_bits(image)``: the same 64 bits as
the unsigned key, held in an int64.  Adds, subtracts and bitwise
operations on them are the u64 ones; torch's int64 ``>>`` is
arithmetic and its compares are signed, so ``shr``, ``shl``, ``ult``,
``umin`` and ``clz64`` here give the unsigned shift, compare, minimum
and leading-zero count (counterparts of rmi_tpu/models/radix.py:52-63
and ``jax.lax.clz``).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

_SIGN = np.uint64(1 << 63)
IMAGE_MIN = -(1 << 63)            # image of key 0
_LOW32 = 0xFFFFFFFF


class KeyType(enum.Enum):
    """Key dtypes, chosen by file-name suffix (src/main.rs:122-132).

    The port carries the integer key types; f64 keys (an IEEE total-order
    image, rmi_tpu/keys.py:240-262) come with a later slice."""

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
    def max_value(self) -> int:
        """T::max_value() of an integer key type (models/mod.rs:81,93)."""
        _integer_only(self)
        return (1 << 32) - 1 if self is KeyType.U32 else (1 << 64) - 1

    @property
    def max_image(self) -> int:
        return image_of(self.max_value)

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


def _integer_only(key_type: KeyType) -> None:
    if key_type is KeyType.F64:
        raise NotImplementedError(
            "f64 keys are not ported yet (ROADMAP.md Queue 1, item 1: "
            "serving breadth)")


def image_of(u: int) -> int:
    """int64 image of one unsigned key."""
    return u + IMAGE_MIN


def to_image(arr: np.ndarray) -> torch.Tensor:
    """Unsigned numpy keys -> int64 image tensor (CPU)."""
    u = np.ascontiguousarray(arr).astype(np.uint64, copy=False)
    return torch.from_numpy((u ^ _SIGN).view(np.int64))


def from_image(v: torch.Tensor, key_type: KeyType = KeyType.U64) -> np.ndarray:
    """int64 image tensor -> unsigned numpy keys of ``key_type``."""
    u = v.detach().cpu().numpy().view(np.uint64) ^ _SIGN
    return u.astype(key_type.np_dtype)


def as_float(v: torch.Tensor) -> torch.Tensor:
    """Exact u64 -> f64 cast of int64 images (one rounding)."""
    hi = ((v >> 32) & _LOW32) ^ 0x80000000
    lo = v & _LOW32
    return hi.double() * 4294967296.0 + lo.double()


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
    """TrainingKey::minus_epsilon on images, saturating at key 0
    (models/mod.rs:78,90,449-454)."""
    _integer_only(key_type)
    return torch.where(v > IMAGE_MIN, v - 1, v)


def plus_epsilon(v: torch.Tensor, key_type: KeyType) -> torch.Tensor:
    """TrainingKey::plus_epsilon on images, saturating at T::max_value()
    (models/mod.rs:80,92)."""
    mx = key_type.max_image
    return torch.where(v < mx, v + 1, v)
