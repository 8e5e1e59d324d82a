"""Data layer: SOSD binary files -> device-resident int64 key images
(counterpart of rmi_tpu/data.py).

File format is SOSD's (README.md:29-33 of the reference): an 8-byte
little-endian u64 item count, then the packed little-endian keys; the
dtype comes from the file name (src/main.rs:122-132).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from rmi_tpu_torch import config, keys as keymod
from rmi_tpu_torch.keys import KeyType


@dataclasses.dataclass
class RMIDataset:
    """Sorted keys as int64 images (rmi_tpu_torch.keys) on one device."""

    keys: torch.Tensor            # [n] int64 images, non-decreasing
    key_type: KeyType
    source_path: Optional[str] = None

    @property
    def n(self) -> int:
        return int(self.keys.shape[0])

    @classmethod
    def from_numpy(cls, arr: np.ndarray, key_type: Optional[KeyType] = None,
                   device=None) -> "RMIDataset":
        """Sorted unsigned keys as images on ``device``: the card when
        None (no card raises); the CPU only when asked for."""
        if key_type is None:
            key_type = {np.dtype(np.uint32): KeyType.U32,
                        np.dtype(np.uint64): KeyType.U64,
                        np.dtype(np.float64): KeyType.F64}[arr.dtype]
        keymod._integer_only(key_type)
        dev = config.require_cuda() if device is None else torch.device(device)
        return cls(keys=keymod.to_image(arr).to(dev), key_type=key_type)

    def to_numpy(self) -> np.ndarray:
        return keymod.from_image(self.keys, self.key_type)

    def unique(self) -> Tuple[np.ndarray, np.ndarray]:
        """(keys, first offsets) of each duplicate run, DedupIter's
        semantics (models/mod.rs:198-231): the keys in their own type
        and the offsets as u64, on the host, for the cache_fix spline.
        The run starts are found on the keys' device and only they move."""
        k = self.keys
        changed = torch.ones(k.shape[0], dtype=torch.bool, device=k.device)
        torch.ne(k[1:], k[:-1], out=changed[1:])
        idx = torch.nonzero(changed).squeeze(1)
        del changed
        return (keymod.from_image(k[idx], self.key_type),
                idx.cpu().numpy().view(np.uint64))

    def as_u64(self) -> "RMIDataset":
        """RMIMMap::into_u64 (src/load.rs:123-128): cache_fix (--bounded)
        needs u64 keys.  A u32 key's image is its u64 image, so only the
        type changes."""
        if self.key_type is KeyType.U64:
            return self
        if self.key_type is KeyType.U32:
            return RMIDataset(keys=self.keys, key_type=KeyType.U64,
                              source_path=self.source_path)
        raise ValueError("Can only construct a bounded RMI on integer data.")


def load_data(path: str, key_type: Optional[KeyType] = None,
              device=None) -> RMIDataset:
    """Read an SOSD binary file (src/load.rs:132-157) onto ``device``, the
    card when None."""
    if key_type is None:
        key_type = KeyType.from_filename(os.path.basename(path))
    with open(path, "rb") as f:
        count = int(np.frombuffer(f.read(8), dtype="<u8")[0])
        raw = np.fromfile(f, dtype=np.dtype(key_type.np_dtype).newbyteorder("<"),
                          count=count)
    if raw.shape[0] != count:
        raise ValueError(
            f"{path}: header says {count} items but file holds {raw.shape[0]}")
    ds = RMIDataset.from_numpy(raw.astype(key_type.np_dtype), key_type,
                               device=device)
    ds.source_path = os.path.abspath(path)
    return ds


def write_sosd_file(path: str, arr: np.ndarray) -> None:
    """Write keys in the SOSD binary format the reference consumes."""
    with open(path, "wb") as f:
        f.write(np.uint64(arr.shape[0]).tobytes())
        f.write(np.ascontiguousarray(arr).astype(
            np.dtype(arr.dtype).newbyteorder("<")).tobytes())


def synthetic_dataset(kind: str, n: int, key_type: KeyType = KeyType.U64,
                      seed: int = 0) -> np.ndarray:
    """Sorted keys shaped like an SOSD file, the same arrays as
    rmi_tpu.data.synthetic_dataset for the same seed.  ``books``:
    exponential gaps, roughly uniform with mild local clustering."""
    if kind != "books":
        raise NotImplementedError(
            f"synthetic {kind!r} keys are not ported yet (ROADMAP.md Queue 1)")
    keymod._integer_only(key_type)
    rng = np.random.default_rng(seed)
    keys = np.sort(np.cumsum(rng.exponential(scale=float(2**63) / n, size=n)))
    hi = float(np.iinfo(key_type.np_dtype).max)
    keys = np.clip(keys, 0, hi)
    if key_type is KeyType.U32:
        keys = keys / keys[-1] * (hi - 1.0)
    return np.sort(keys.astype(key_type.np_dtype))


def books_like_on_device(n: int, seed: int, device) -> torch.Tensor:
    """Sorted books-like u64 key images made on ``device``: exponential
    gaps, cumulative sum, scaled so the last key is 2^62.  The gaps are
    rounded to integers before they are summed: an int64 sum does not
    depend on the order of its adds, so the keys are the same in every
    run, where a float cumsum on the card is not."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
    # a gap is at most -log(1e-7) < 2^5 units of 2^57 / n: the sum fits
    gaps = u.clamp_(min=1e-7).log_().neg_().double().mul_(2.0 ** 57 / n)
    del u
    csum = torch.cumsum(gaps.round_().to(torch.int64), 0)
    del gaps
    keys = csum.double().mul_((2.0 ** 62) / float(csum[-1])).to(torch.int64)
    del csum
    keys.add_(keymod.IMAGE_MIN)      # u < 2^63: u ^ 2^63 == u - 2^63
    return keys
