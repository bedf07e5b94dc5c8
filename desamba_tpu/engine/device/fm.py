"""Batched FM rank + backward MEM search on device.

The reference's hottest scalar loop (occ: src/bwt.c:43-65, called twice per
char per seed, SURVEY §3.4) is re-designed for batched lanes in POSITION space:
because this index keeps the full suffix array (row_pos) and its inverse
(isa), the whole backward-extension interval phase of bwt_MEM_search
(src/cly.c:1388-1447) collapses to a handful of *parallel* packed LCEs —
one per row of the initial 13-mer interval — plus closed-form stop
resolution over their order statistics. The dependent rank-query chase
(one lockstep `lax.while_loop` trip per extension char, 2 block gathers
per lane per trip, worst-lane depth ~40 on the demo) disappears for every
lane whose initial interval is <= SA_CAP rows (p100 = 8 on the demo
index; large indexes fall back per lane to the rank chase).

Equivalence: the interval after k backward extensions = the rows of the
initial 13-mer interval whose preceding k text chars match the read
(FM LF preserves relative row order among same-char extensions), so
  n(k) = #{i : lce_i >= k}
and every stop flag of the reference loop is a comparison against the
order statistics of {lce_i}. Survivor rows map to positions p_i - (k*+1).

The per-row single walks (src/cly.c:1344-1383) already run in position
space (textwalk.py): "LF-walk w rows" == "compare w chars starting at
row_pos[row]-1", ~w/16 word gathers. The reference's SP_SET row dedup
(src/cly.c:1281-1298) is kept bit-exact as a set of disjoint position
intervals carried through the ladder loops.

Parity contract (tests/test_device_engine.py): for identical probe inputs
and SP_SET state, `mem_probe` returns exactly the MemRst set of the gold
engine's bwt_mem_search (match lengths, final rows, SA samples, dedup
aborts).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ...constants import L_PRE_IDX
from . import textwalk
from .arrays import BLOCK
from .compaction import compact_rows
from .textwalk import (
    find_bit_low,
    ivset_init,
    ivset_walk,
    lce_backward,
)

U32 = jnp.uint32
I32 = jnp.int32

# Initial-interval cap for the position-space path: lanes whose 13-mer
# bucket holds more rows take the rank-chase fallback. 16 covers both
# fast (max_rst 2) and slow (max_rst 8) order statistics with room for
# denser indexes than the demo (p100 = 8 there).
SA_CAP = 16

BIG = np.int32(1 << 30)  # plain numpy: no backend init at import time


class WalkRefs(NamedTuple):
    """The subset of index arrays the position-space walk needs — any
    object with these attributes works (IndexRefs qualifies)."""
    row_pos: jnp.ndarray
    text_pk: jnp.ndarray
    sep_any: jnp.ndarray
    samp_bits: jnp.ndarray
    isa: jnp.ndarray


def _rank_from_blocks(fm_blocks, r, c):
    """occ(c, r): count of char c in rows [0, r). r, c: (N,) int32.

    Gathers the whole 9-word (36 B) block as ONE row gather instead of
    five 1-word element gathers on the ladder's hottest loop."""
    blk = r // BLOCK
    within = r - blk * BLOCK
    fb9 = fm_blocks.reshape(-1, 9)
    got = fb9[blk]                 # (N, 9)
    base = got[:, 0]
    for k in range(1, 5):          # elementwise select beats a 2nd gather
        base = jnp.where(c == k, got[:, k], base)
    words = got[:, 5:9]
    pattern = c.astype(U32) * U32(0x11111111)
    x = words ^ pattern[:, None]
    y = ~(x | (x >> 1) | (x >> 2) | (x >> 3)) & U32(0x11111111)
    nib_start = jnp.arange(4, dtype=jnp.int32)[None, :] * 8
    take = jnp.clip(within[:, None] - nib_start, 0, 8)
    mask = jnp.where(take >= 8, U32(0x11111111),
                     (U32(1) << (take.astype(U32) * 4)) - U32(1))
    y = y & mask
    y = y + (y >> 16)
    y = y + (y >> 8)
    y = y + (y >> 4)
    cnt = y & U32(0xF)
    return base + jnp.sum(cnt, axis=1, dtype=U32)


def spset_init(n, cap: int | None = None):
    """Fresh per-lane SP_SET state: (intervals, counts) — see
    textwalk.ivset_init. cap selects a hot tier (overflow -> sticky
    cnt[:, 2] bit); None = full IV_CAP (never overflows)."""
    return ivset_init(n, cap if cap is not None else textwalk.IV_CAP)


def _interval_rank_chase(ixr, fm_blocks, rank6, codes, str_idx, sp0, ep0,
                         active, max_rst: int, l_min_mth: int, col_off,
                         rows):
    """The reference's occ-chase interval loop, lane-lockstep — fallback
    for lanes whose initial 13-mer interval exceeds SA_CAP rows.
    Returns (match_len, str_i, n_sp, n_ep, fail)."""
    N = str_idx.shape[0]
    L = codes.shape[1]
    match_len = jnp.full((N,), L_PRE_IDX, jnp.int32)
    str_i = str_idx - L_PRE_IDX
    l_max = str_idx
    n_sp = jnp.zeros((N,), U32)
    n_ep = jnp.zeros((N,), U32)
    fail = jnp.zeros((N,), bool)

    def ibody(st):
        sp, ep, match_len, str_i, n_sp_o, n_ep_o, fail, running = st
        ci = jnp.clip(col_off + str_i, 0, L - 1)
        c = codes[rows, ci].astype(jnp.int32)
        offbuf = str_i < 0
        c = jnp.where(offbuf, 0, c)
        r_c = rank6[c].astype(U32)
        nsp = r_c + _rank_from_blocks(fm_blocks, sp.astype(jnp.int32), c)
        nep = r_c + _rank_from_blocks(fm_blocks, ep.astype(jnp.int32), c)
        ge_min = match_len >= l_min_mth - 1
        stop_a = ge_min & (nsp + U32(max_rst) >= nep)
        stop_b = ge_min & ~stop_a & (match_len >= l_max)
        stop_c = ~stop_a & ~stop_b & (nsp + U32(1) >= nep)
        stop = stop_a | stop_b | stop_c | offbuf
        this_fail = stop_b | offbuf | (stop & (nsp >= nep))
        upd = running & stop
        fail = jnp.where(upd, this_fail, fail)
        n_sp_o = jnp.where(upd, nsp, n_sp_o)
        n_ep_o = jnp.where(upd, nep, n_ep_o)
        cont = running & ~stop
        sp = jnp.where(cont, nsp, sp)
        ep = jnp.where(cont, nep, ep)
        match_len = jnp.where(cont, match_len + 1, match_len)
        str_i = jnp.where(running, str_i - 1, str_i)
        return sp, ep, match_len, str_i, n_sp_o, n_ep_o, fail, cont

    st = (sp0, ep0, match_len, str_i, n_sp, n_ep, fail, active)
    st = jax.lax.while_loop(lambda s: s[7].any(), ibody, st)
    _, _, match_len, str_i, n_sp, n_ep, fail, _ = st
    return match_len, str_i, n_sp, n_ep, fail


def _interval_sa(ixr, codes_pk, str_idx, sp0, n0, active,
                 max_rst: int, l_min_mth: int, col_off, rows,
                 sa_cap: int):
    """Position-space interval phase for lanes with n0 <= SA_CAP.

    Computes, per lane: the backward LCE of every initial-interval row,
    then the reference loop's first-stop iteration k* in closed form.
    Returns (match_len, str_i, fail, n_rows, w_pos, w_valid):
      w_pos   (N, SA_CAP) int32 — survivor row text positions, in FM row
              order (= initial-interval order), dense from slot 0;
      w_valid (N, SA_CAP) bool.
    """
    N = str_idx.shape[0]
    C = sa_cap
    slot = jnp.arange(C, dtype=I32)[None, :]
    rvalid = active[:, None] & (slot < n0[:, None])

    # compact the (lane, slot) pairs so the LCE runs only on real rows:
    # sum(n0) ~ 1.5x lanes on the demo vs N*SA_CAP dense. Lanes that
    # would spill past 2N were already routed to the rank chase.
    flatv = rvalid.reshape(-1)
    Wc = 2 * N
    fg, fs, fvalid = compact_rows(flatv, Wc)
    f_lane = fg // C
    f_slot = fg - f_lane * C
    rowix = (sp0[f_lane].astype(I32) + f_slot)
    n_text = ixr.isa.shape[0]
    p = ixr.row_pos[jnp.clip(rowix, 0, n_text - 1)]
    cap_l = jnp.maximum(str_idx - L_PRE_IDX + 1, 0)
    lce = lce_backward(ixr.text_pk, ixr.sep_any, codes_pk, rows[f_lane],
                       col_off[f_lane], str_idx[f_lane] - L_PRE_IDX,
                       p - 1, cap_l[f_lane], fvalid)
    # scatter back to dense (N, SA_CAP); invalid slots -> -1
    lden = jnp.full((N * C,), -1, I32).at[fs].set(
        jnp.where(fvalid, lce, -1), mode="drop").reshape(N, C)
    pden = jnp.zeros((N * C,), I32).at[fs].set(p, mode="drop").reshape(N, C)

    # order statistics (descending)
    lsort = -jnp.sort(-lden, axis=1)
    # A_{m+1}: the (max_rst+1)-th largest lce (0 when fewer rows exist:
    # n(k) <= n0 <= max_rst for all k >= 1 then)
    if max_rst + 1 <= C:
        a_m1 = jnp.maximum(lsort[:, max_rst], 0)
    else:
        a_m1 = jnp.zeros((N,), I32)
    a_2 = jnp.maximum(lsort[:, 1], 0) if C >= 2 else jnp.zeros((N,), I32)

    gmin_k = l_min_mth - 1 - L_PRE_IDX       # ge_min <=> k >= gmin_k
    l_max = str_idx
    k_a = jnp.maximum(gmin_k, a_m1)
    k_b0 = jnp.maximum(gmin_k, l_max - L_PRE_IDX)
    k_b = jnp.where(k_b0 < a_m1, k_b0, BIG)  # b needs n(k+1) > max_rst
    k_c = jnp.where(a_2 < gmin_k, a_2, BIG)  # c only before ge_min
    k_star = jnp.minimum(jnp.minimum(k_a, k_b), k_c)
    k_off = str_idx - L_PRE_IDX + 1          # first k reading str_i < 0
    fail_off = k_star >= k_off
    is_b = (k_star == k_b) & ~fail_off
    k_eff = jnp.minimum(k_star, k_off)

    surv = rvalid & (lden >= (k_eff + 1)[:, None])
    n_new = jnp.sum(surv, axis=1, dtype=I32)
    fail = fail_off | is_b | (n_new == 0)
    match_len = L_PRE_IDX + k_eff
    str_i = str_idx - L_PRE_IDX - (k_eff + 1)
    n_rows = jnp.where(active & ~fail, jnp.minimum(n_new, max_rst), 0)

    # dense-pack survivor positions in row order (order preserved by LF)
    dpos = jnp.cumsum(surv.astype(I32), axis=1) - 1
    dest = jnp.where(surv & (dpos < C), dpos, C)
    lanes2 = jnp.broadcast_to(jnp.arange(N, dtype=I32)[:, None], (N, C))
    w_pos = jnp.zeros((N, C + 1), I32).at[lanes2, dest].set(
        pden - (k_eff + 1)[:, None], mode="drop")[:, :C]
    w_valid = slot < n_rows[:, None]
    return match_len, str_i, fail, n_rows, w_pos, w_valid


@functools.partial(jax.jit,
                   static_argnames=("max_rst", "l_min_mth", "sa_cap"))
def mem_probe(ixr, fm_blocks, rank6, hash13, codes, codes_pk, str_idx,
              pre_v, active, spset, spcount, max_rst: int, l_min_mth: int,
              col_off=None, row_idx=None, sa_cap: int = SA_CAP):
    """One backward MEM probe per lane (bwt_MEM_search, src/cly.c:1388-1447).

    codes: (N, L) uint8 per-lane read codes (lane-aligned); codes_pk:
    textwalk 2-bit packing of codes; str_idx: (N,) index of the probe's
    last char; pre_v: (N,) 13-mer value; l_max_mth is str_idx per the
    reference. col_off/row_idx (N,), if given, map lanes onto a shared
    per-read F+R buffer via (row_idx, col_off + i).
    Returns per-lane results for up to max_rst rows plus updated SP_SET
    state:
      res_len:   (N, R) int32 total match length (<l_min invalid; -1000ish
                 on dedup abort, matching the reference)
      res_sp:    (N, R) uint32 final row of each walk
      res_sa:    (N, R) uint32 SA-sampled row (res_sa_ok False if none)
      res_sa_l:  (N, R) int32 negative offset from the sample
      res_valid: (N, R) bool
    """
    N = str_idx.shape[0]
    lanes = jnp.arange(N)
    if col_off is None:
        col_off = jnp.zeros((N,), jnp.int32)
    rows = lanes if row_idx is None else row_idx
    n_text = ixr.isa.shape[0]

    # ---- interval phase ----------------------------------------------------
    sp0 = hash13[pre_v].astype(U32)
    ep0 = hash13[pre_v + 1].astype(U32)
    n0 = (ep0 - sp0).astype(I32)
    big = active & (n0 > sa_cap)
    sa_act = active & ~big
    # the SA path compacts all lanes' interval rows to width 2N; lanes
    # whose rows would spill past it fall back to the rank chase too
    n_eff = jnp.where(sa_act, jnp.minimum(n0, sa_cap), 0)
    fit = jnp.cumsum(n_eff) <= 2 * N
    big = big | (sa_act & ~fit)
    sa_act = sa_act & fit

    if sa_cap > 0:
        (ml_s, si_s, fail_s, nr_s, wpos_s, wval_s) = _interval_sa(
            ixr, codes_pk, str_idx, sp0, n0, sa_act, max_rst, l_min_mth,
            col_off, rows, sa_cap)
    else:  # chase-only (test/fallback mode)
        z = jnp.zeros((N,), jnp.int32)
        ml_s, si_s, nr_s = z, z, z
        fail_s = jnp.zeros((N,), bool)
        wpos_s = jnp.zeros((N, 1), jnp.int32)
        wval_s = jnp.zeros((N, 1), bool)

    def chase(_):
        return _interval_rank_chase(ixr, fm_blocks, rank6, codes, str_idx,
                                    sp0, ep0, big, max_rst, l_min_mth,
                                    col_off, rows)

    def no_chase(_):
        z = jnp.zeros((N,), jnp.int32)
        zu = jnp.zeros((N,), U32)
        return z, z, zu, zu, jnp.zeros((N,), bool)

    ml_b, si_b, nsp_b, nep_b, fail_b = jax.lax.cond(
        big.any(), chase, no_chase, None)

    match_len = jnp.where(big, ml_b, ml_s)
    str_i = jnp.where(big, si_b, si_s)
    fail = jnp.where(big, fail_b, fail_s)
    ok = active & ~fail
    nr_b = jnp.where(big & ok, (nep_b - nsp_b).astype(I32), 0)
    n_rows = jnp.where(big, jnp.minimum(nr_b, max_rst), nr_s)

    # ---- per-row walks in position space (bwt_single_search) --------------
    R = max_rst
    res_len = jnp.zeros((N, R), jnp.int32)
    res_sp = jnp.zeros((N, R), U32)
    res_sa = jnp.zeros((N, R), U32)
    res_sa_ok = jnp.zeros((N, R), bool)
    res_sa_l = jnp.zeros((N, R), jnp.int32)
    res_valid = jnp.zeros((N, R), bool)
    wmax = jnp.maximum(0, str_idx - match_len)

    def row_body(carry):
        (k, res_len, res_sp, res_sa, res_sa_ok, res_sa_l, res_valid,
         iv, cnt) = carry
        do = ok & (k < n_rows)
        # walk-start position: survivor list (sa path) or the rank-chase
        # interval rows n_sp + k mapped through row_pos (big lanes)
        row_b = (nsp_b + k.astype(U32)).astype(I32)
        p_b = ixr.row_pos[jnp.clip(row_b, 0, n_text - 1)]
        p_s = wpos_s[:, jnp.minimum(k, wpos_s.shape[1] - 1)]
        p = jnp.where(big, p_b, p_s)
        nat = lce_backward(ixr.text_pk, ixr.sep_any, codes_pk, rows,
                           col_off, str_i, p - 1, wmax, do)
        iv, cnt, dup0, abort, wlen = ivset_walk(iv, cnt, p, nat, do)
        do_walk = do & ~dup0
        # rows sa-checked: t = 0..T (cap excludes the final row, a
        # mismatch stop does not; dup abort stops at the matched row)
        T = jnp.where(abort | (wlen < wmax), wlen, wmax - 1)
        qs, found = find_bit_low(ixr.samp_bits, p - T, p,
                                 do_walk & (T >= 0))
        sa = jnp.where(found,
                       ixr.isa[jnp.clip(qs, 0, n_text - 1)], 0).astype(U32)
        sa_l = jnp.where(found, (p - qs) - T, -(T + 1))
        end_row = ixr.isa[jnp.clip(p - wlen, 0, n_text - 1)].astype(U32)
        total = jnp.where(abort, -1000, wlen) + match_len + 1
        valid = do_walk & (total >= l_min_mth)
        res_len = res_len.at[:, k].set(jnp.where(do_walk, total, 0))
        res_sp = res_sp.at[:, k].set(jnp.where(do_walk, end_row, 0))
        res_sa = res_sa.at[:, k].set(jnp.where(do_walk & found, sa, 0))
        res_sa_ok = res_sa_ok.at[:, k].set(do_walk & found)
        res_sa_l = res_sa_l.at[:, k].set(jnp.where(do_walk, sa_l, 0))
        res_valid = res_valid.at[:, k].set(valid)
        return (k + 1, res_len, res_sp, res_sa, res_sa_ok, res_sa_l,
                res_valid, iv, cnt)

    # only walk row slots some lane actually has: rows-per-probe is
    # p90 = 1 on real corpora, so a fixed R(=max_rst)-iteration loop
    # would pay the (find_bit_high x2 + LCE + isa) walk machinery ~Rx
    # per probe for nothing
    kmax = jnp.max(jnp.where(ok, n_rows, 0))
    carry = (jnp.int32(0), res_len, res_sp, res_sa, res_sa_ok, res_sa_l,
             res_valid, spset, spcount)
    out = jax.lax.while_loop(lambda c: c[0] < kmax, row_body, carry)
    return out[1:]
