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
            "f64 keys are not ported yet (ROADMAP.md Queue 1, item 8)")


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
