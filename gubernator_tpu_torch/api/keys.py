"""Key hashing: string hash-key -> 128-bit slot-table identity.

The slot table stores a 128-bit hash of `name + "_" + unique_key`
instead of the string (at 10M keys the collision probability is
~2.9e-25). The hash is MurmurHash3 x64-128 from the port's own C++
source (`csrc/guberhash.cc`), built with g++ at first use and loaded
with ctypes; it gives the same digests as the JAX package's native
hasher. (0, 0) marks an empty slot, so the C code nudges an all-zero
digest to lo = 1.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np

from gubernator_tpu_torch.ops import _build

_M64 = (1 << 64) - 1


def _to_signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _lib() -> ctypes.CDLL:
    lib = _build.load("guberhash")
    if getattr(lib, "_guber_typed", False):
        return lib
    lib.guber_hash128.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.guber_hash128.restype = None
    lib.guber_hash128_batch.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int,
        ctypes.c_uint64,
        np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    lib.guber_hash128_batch.restype = None
    lib._guber_typed = True
    return lib


def key_hash128(hash_key: str) -> Tuple[int, int]:
    """128-bit identity of a rate-limit key, as two signed int64 halves."""
    raw = hash_key.encode("utf-8")
    hi = ctypes.c_uint64()
    lo = ctypes.c_uint64()
    _lib().guber_hash128(raw, len(raw), ctypes.byref(hi), ctypes.byref(lo))
    return _to_signed(hi.value), _to_signed(lo.value)


def key_hash128_batch(
    keys: List[str], num_groups: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batch form, one native call: (hi int64[n], lo int64[n],
    group int32[n]) with group = unsigned(lo) % num_groups."""
    if num_groups < 1:
        raise ValueError("num_groups must be >= 1")
    encoded = [k.encode("utf-8") for k in keys]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    return key_hash128_batch_raw(b"".join(encoded), offsets, num_groups)


def key_hash128_batch_raw(
    key_data: bytes, offsets: np.ndarray, num_groups: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """`key_hash128_batch` over keys already concatenated as UTF-8 bytes,
    key i at key_data[offsets[i]:offsets[i + 1]] (the wire columns'
    `key_data` / `key_offsets`): one native call, no per-key Python."""
    if num_groups < 1:
        raise ValueError("num_groups must be >= 1")
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    hi = np.empty(n, dtype=np.uint64)
    lo = np.empty(n, dtype=np.uint64)
    group = np.empty(n, dtype=np.int32)
    _lib().guber_hash128_batch(key_data, offsets, n, num_groups, hi, lo, group)
    return hi.view(np.int64), lo.view(np.int64), group


def group_of(key_lo: int, num_groups: int) -> int:
    """Slot-group index from the (signed) low hash half."""
    return (key_lo & _M64) % num_groups
