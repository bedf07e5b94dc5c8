"""64-bit integer ops on (hi, lo) uint32 pairs.

JAX runs with 32-bit integers unless x64 mode is on; the hash and k-mer
math only needs shifts/adds/xors, which map directly onto uint32 lanes.
"""
from __future__ import annotations

import jax.numpy as jnp

U32 = jnp.uint32


def make(hi, lo):
    return (jnp.asarray(hi, U32), jnp.asarray(lo, U32))


def from_u64_np(x):
    """numpy uint64 array -> (hi, lo) device-ready uint32 arrays."""
    import numpy as np

    x = np.asarray(x, dtype=np.uint64)
    return (x >> np.uint64(32)).astype(np.uint32), x.astype(np.uint32)


def to_u64_np(hi, lo):
    import numpy as np

    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(
        lo, dtype=np.uint64)


def shl(p, n: int):
    hi, lo = p
    if n == 0:
        return p
    if n >= 32:
        return ((lo << (n - 32)) if n > 32 else lo, jnp.zeros_like(lo))
    return ((hi << n) | (lo >> (32 - n)), lo << n)


def shr(p, n: int):
    hi, lo = p
    if n == 0:
        return p
    if n >= 32:
        return (jnp.zeros_like(hi), (hi >> (n - 32)) if n > 32 else hi)
    return (hi >> n, (lo >> n) | (hi << (32 - n)))


def add(a, b):
    ahi, alo = a
    bhi, blo = b
    lo = alo + blo
    carry = (lo < alo).astype(U32)
    return (ahi + bhi + carry, lo)


def xor(a, b):
    return (a[0] ^ b[0], a[1] ^ b[1])


def not_(a):
    return (~a[0], ~a[1])


def and_const(a, mask64: int):
    return (a[0] & U32((mask64 >> 32) & 0xFFFFFFFF), a[1] & U32(mask64 & 0xFFFFFFFF))


def hash64_1(p):
    """Thomas Wang mix #1 (reference src/lib/utils.c:1067-1078)."""
    k = add(not_(p), shl(p, 21))
    k = xor(k, shr(k, 24))
    k = add(add(k, shl(k, 3)), shl(k, 8))
    k = xor(k, shr(k, 14))
    k = add(add(k, shl(k, 2)), shl(k, 4))
    k = xor(k, shr(k, 28))
    k = add(k, shl(k, 31))
    return k


def hash64_2(p):
    """Mix #2 (reference src/lib/utils.c:1081-1092)."""
    k = add(p, not_(shl(p, 32)))
    k = xor(k, shr(k, 22))
    k = add(k, not_(shl(k, 13)))
    k = xor(k, shr(k, 8))
    k = add(k, shl(k, 3))
    k = xor(k, shr(k, 15))
    k = add(k, not_(shl(k, 27)))
    k = xor(k, shr(k, 31))
    return k
