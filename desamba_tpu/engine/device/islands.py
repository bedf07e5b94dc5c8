"""Device islands stage: batched e-kmer existence probe.

The per-position compute (rolling e-kmers, complexity filter, two 64-bit
hashes, bit-table probes) runs on device over a (batch, positions) grid; the
cheap island segmentation walk runs on host from the hit mask using an
arithmetic per-run formulation equivalent to the reference's scan
(src/cly.c:1083-1158, see engine/gold/islands.py for the position-walk
port it is tested against).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ...constants import FORWARD, STEP_EK
from . import u64ops as u


def ekmer_probe_indices(codes, lengths, l_ek: int, single_base_max: int,
                        mask_bits: int):
    """Per-position existence-probe addresses for a padded read batch.

    codes: (B, L) uint8 2-bit reads; lengths: (B,) int32.
    Returns (byte1, bit1, byte2, bit2, valid): byte/bit addresses into the
    two existence tables plus the complexity/length validity mask, all
    (B, L - l_ek + 1). Split out so sharded probes (parallel/) reuse it.
    """
    B, L = codes.shape
    n_k = L - l_ek + 1
    c32 = codes.astype(jnp.uint32)
    # rolling e-kmer (hi, lo) pairs
    hi = jnp.zeros((B, n_k), jnp.uint32)
    lo = jnp.zeros((B, n_k), jnp.uint32)
    for j in range(l_ek):
        sh = 2 * (l_ek - 1 - j)
        w = c32[:, j : j + n_k]
        if sh >= 32:
            hi = hi | (w << (sh - 32))
        else:
            lo = lo | (w << sh)
            if sh > 32 - 2:  # 2-bit value can straddle the word boundary
                hi = hi | (w >> (32 - sh))
    # low-complexity filter: any single base >= single_base_max in window
    bad = jnp.zeros((B, n_k), bool)
    for b in range(4):
        is_b = (codes == b).astype(jnp.int32)
        cs = jnp.cumsum(is_b, axis=1)
        zero = jnp.zeros((B, 1), jnp.int32)
        cs0 = jnp.concatenate([zero, cs], axis=1)
        cnt = cs0[:, l_ek : n_k + l_ek] - cs0[:, :n_k]
        bad = bad | (cnt >= single_base_max)
    kzero = (hi == 0) & (lo == 0)
    mask64 = (1 << mask_bits) - 1
    kp = (hi, lo)
    h1 = u.and_const(u.hash64_1(kp), mask64)
    h2 = u.and_const(u.hash64_2(kp), mask64)

    def addr(h):
        hhi, hlo = h
        # bit index < 2^37: byte index fits int32 for tables <= 2^31 bytes
        byte_idx = ((hhi << 29) | (hlo >> 3)).astype(jnp.int32)
        bit = (jnp.uint8(7) - (hlo & 7).astype(jnp.uint8))
        return byte_idx, bit

    b1, s1 = addr(h1)
    b2, s2 = addr(h2)
    pos = jnp.arange(n_k)[None, :]
    valid = ~bad & ~kzero & (pos < (lengths[:, None] - l_ek + 1))
    return b1, s1, b2, s2, valid


@functools.partial(jax.jit, static_argnames=("l_ek", "single_base_max", "mask_bits"))
def bloom_hit_kernel(codes, lengths, ek0, ek1, l_ek: int,
                     single_base_max: int, mask_bits: int):
    """codes: (B, L) uint8 2-bit reads (padded); lengths: (B,) int32.

    Returns hit: (B, L - l_ek + 1) bool — e-kmer passes the complexity
    filter and both existence-table probes.
    """
    b1, s1, b2, s2, valid = ekmer_probe_indices(
        codes, lengths, l_ek, single_base_max, mask_bits)
    hit1 = ((ek0[b1] >> s1) & 1).astype(bool)
    hit2 = ((ek1[b2] >> s2) & 1).astype(bool)
    return hit1 & hit2 & valid


def segment_islands(hit_row: np.ndarray, n_kmers: int, direction: int) -> list:
    """Arithmetic per-run island walk, equivalent to the reference scan.

    Probes advance by 3 from a phase that resets to island_end + 3 after
    each island; islands expand <=2 back (bounded by the run start) and
    forward to the run end or length 61.
    """
    hv = hit_row[:n_kmers]
    d = np.diff(np.concatenate([[0], hv.view(np.int8), [0]]))
    starts = np.flatnonzero(d == 1)
    ends = np.flatnonzero(d == -1)
    seeds = []
    if direction == FORWARD:
        p = STEP_EK - 1
        for a, b in zip(starts, ends):
            while True:
                if p < a:
                    p = a + (-(a - p)) % STEP_EK
                if p >= b:
                    break
                o = max(a, p - 2)
                ln = min(61, b - o)
                seeds.append([int(o), int(ln), 0])
                p = o + ln + STEP_EK
        return seeds
    # reverse: scan right-to-left; mirror the arithmetic
    p = n_kmers - STEP_EK
    for a, b in zip(starts[::-1], ends[::-1]):
        while True:
            if p > b - 1:
                p = (b - 1) - (-(p - (b - 1))) % STEP_EK
            if p < a:
                break
            top = min(b - 1, p + 2)
            ln = min(61, top - a + 1)
            seeds.append([int(top - ln + 1), int(ln), 0])
            p = top - ln - STEP_EK  # C: i = offset - len, then i -= 3
    return seeds
