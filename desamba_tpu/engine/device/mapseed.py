"""Batched map_seed: locate + LV extend + reference fan-out on device.

Device port of engine/gold/mapseed.py (itself a faithful port of
src/cly.c:435-939). One lane = one MemRst to map; all control flow is
masked vector ops + bounded `lax.while_loop`s so thousands of lanes run
lockstep.

Integer conventions: positions/lengths int32; the reference's uint32 wrap
quirks (l_max_suf, negative uni_offset) are emulated with uint32 casts.
Reference coordinates assume < 2^31 (viral/demo scale; the sharded large
index path re-bases offsets per shard).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ...constants import (
    LV_L,
    MIN_S_1,
    MIN_S_2,
    MIN_UNI_L,
    SA_MASK,
)
from .lv import lv_batch
from .textwalk import _word16_rows, collect_backward, find_bit_high

GARBAGE = 200
I32 = jnp.int32
U32 = jnp.uint32

# anchor record field order (int32 columns)
A_FIELDS = (
    "mtch_len", "score", "left_len", "left_ed", "rigt_len", "rigt_ed",
    "direction", "global_offset", "ref_id", "ref_offset", "index_in_read",
    "seed_id",
)
A_NF = len(A_FIELDS)


class IndexRefs(NamedTuple):
    """Device index arrays used by map_seed (a subset of DeviceIndex).

    Registered as a pytree with the scalar geometry (text_len, n_uni,
    n_bases) as STATIC aux data so jit treats them as compile-time
    constants (slices/bounds depend on them).
    """
    lf: jnp.ndarray            # (n_rows,) uint32
    lfc: jnp.ndarray           # (n_rows,) uint32: (lf << 3) | char
    row_char: jnp.ndarray      # (n_rows,) uint8
    row_pos: jnp.ndarray       # (n_rows,) int32
    uni_start: jnp.ndarray     # (n_uni + 1,) int32 (text start per unitig)
    uni_len: jnp.ndarray       # (n_uni + 1,) int32
    uni_ref_list: jnp.ndarray  # (n_uni + 1,) int32 CSR into rp_*
    rp_global_off: jnp.ndarray  # (n_occ,) int32
    rp_ref_id: jnp.ndarray     # (n_occ,) int32
    ref_off: jnp.ndarray       # (n_ref,) int32
    ref_bin: jnp.ndarray       # packed 2-bit reference, uint8
    ref_pk: jnp.ndarray        # (1, ceil(n_bases/16)) uint32 packed ref
    # position-space walk tables (see arrays.DeviceIndex)
    text_pk: jnp.ndarray       # (1, ceil(L/16)) uint32 packed 2-bit text
    sep_any: jnp.ndarray       # (ceil(L/32),) uint32 bitmap: text >= 4
    sep_hash: jnp.ndarray      # (ceil(L/32),) uint32 bitmap: text == '#'
    samp_bits: jnp.ndarray     # (ceil(L/32),) uint32 bitmap: isa % 8 == 0
    isa: jnp.ndarray           # (L,) int32 text position -> row
    pos2uni: jnp.ndarray       # (L,) int32 position -> unitig
    text_len: int
    n_uni: int
    n_bases: int               # len(ref_bin) * 4


_N_ARRAYS = 18


def _ixr_flatten(ix):
    return tuple(ix[:_N_ARRAYS]), tuple(ix[_N_ARRAYS:])


def _ixr_unflatten(aux, children):
    return IndexRefs(*children, *aux)


jax.tree_util.register_pytree_node(IndexRefs, _ixr_flatten, _ixr_unflatten)


def qslice13(codes_pk, buf_len, ridx, start, step):
    """13-char read-buffer window: gold qslice (GARBAGE outside buffer).

    codes_pk: (B, ceil(2*Lmax/16)) packed F+R buffer (textwalk.pack2);
    buf_len: (B,) = 2*read_len; ridx/start: (N,); step: +1/-1.
    Returns (N, 13) uint8. Two word gathers per lane instead of 13
    char gathers."""
    W = LV_L + 1
    ar = jnp.arange(W, dtype=I32)[None, :]
    base = start if step > 0 else start - (W - 1)
    v = _word16_rows(codes_pk, ridx, base)
    sh = (ar.astype(jnp.uint32) * 2)
    ch = ((v[:, None] >> sh) & jnp.uint32(3)).astype(jnp.uint8)
    if step < 0:
        ch = ch[:, ::-1]
    idx = start[:, None] + step * ar
    ok = (idx >= 0) & (idx < buf_len[ridx][:, None])
    return jnp.where(ok, ch, jnp.uint8(GARBAGE))


def get_ref13(ix: IndexRefs, offset, length, forward: bool):
    """13-char packed-reference window (gold get_ref semantics).

    offset: (N,) int32; length: (N,) — chars beyond `length` are
    0-filled; callers only read [:length]. Two word gathers per lane
    (ref_pk) with per-position boundary clamps replicating the
    first/last reference char like the original per-index clip."""
    ref_pk, n_bases = ix.ref_pk, ix.n_bases
    off = jnp.maximum(offset, 0)
    W = LV_L + 1
    ar = jnp.arange(W, dtype=I32)[None, :]
    start = off if forward else off - (W - 1)
    v16 = _word16_rows(ref_pk, jnp.zeros_like(off), start)
    sh = (ar.astype(jnp.uint32) * 2)
    v = ((v16[:, None] >> sh) & jnp.uint32(3)).astype(jnp.uint8)
    # per-position clamp semantics (original: clip(idx, 0, n-1))
    idx = start[:, None] + ar
    first = ((ref_pk[0, 0] & jnp.uint32(3))).astype(jnp.uint8)
    last = ((ref_pk[0, (n_bases - 1) >> 4]
             >> jnp.uint32(((n_bases - 1) & 15) * 2))
            & jnp.uint32(3)).astype(jnp.uint8)
    v = jnp.where(idx < 0, first, v)
    v = jnp.where(idx >= n_bases, last, v)
    chars = v if forward else v[:, ::-1]
    return jnp.where(ar < length[:, None], chars, jnp.uint8(0))


def _leading_matches(t, q, limit):
    """Count of leading positions where t == q, capped at limit (N,)."""
    ar = jnp.arange(LV_L + 1, dtype=I32)[None, :]
    agree = (t == q) & (ar < limit[:, None])
    mask = jnp.sum(agree.astype(U32) << ar.astype(U32), axis=1)
    low = (~mask) & (mask + U32(1))  # isolate lowest zero bit
    m = low - U32(1)
    m = m - ((m >> 1) & U32(0x55555555))
    m = (m & U32(0x33333333)) + ((m >> 2) & U32(0x33333333))
    m = (m + (m >> 4)) & U32(0x0F0F0F0F)
    cnt = ((m * U32(0x01010101)) >> 24).astype(I32)
    return jnp.minimum(cnt, limit)


def get_uni(ix: IndexRefs, row, search_l, active):
    """gold Locator.get_uni: (row, search_l) -> (uni, uni_offset, g_off).

    The reference advances unitig by unitig until the target offset fits
    (src/cly.c:471-496, ~one gather per crossed unitig); with the direct
    pos2uni table the crossing collapses to one gather at the target
    text position. A target landing exactly on a '#' separator matches
    the loop's quirk: it belongs to the NEXT unitig at offset -1."""
    row = row.astype(I32)
    L = ix.text_len
    p1 = (ix.row_pos[row] - 1) % L
    q = p1 + search_l + 1
    walked = active & (search_l > 0)
    u_w = ix.pos2uni[jnp.clip(q, 0, L - 1)]
    uoff_w = q - ix.uni_start[u_w]
    bump = uoff_w == ix.uni_len[u_w]
    u_w = jnp.where(bump, u_w + 1, u_w)
    uoff_w = jnp.where(bump, -1, uoff_w)
    # search_l <= 0: no advancement; uoff < 0 takes the uint32 wrap
    # (gold's unreachable-in-C path)
    u0 = ix.pos2uni[p1]
    uoff0 = p1 - ix.uni_start[u0] + search_l + 1
    wrap = active & (search_l <= 0) & (uoff0 < 0)
    uoff0 = jnp.where(wrap, uoff0.astype(U32).astype(I32), uoff0)
    u = jnp.where(walked, u_w, u0)
    uoff = jnp.where(walked, uoff_w, uoff0)
    g = ix.rp_global_off[ix.uni_ref_list[u]] + uoff
    return u, uoff, g


def get_new_ed(ix: IndexRefs, codes_pk, buf_len, ridx, base, q_off, t_off,
               l_read, is_fwd: bool, active, q_lv):
    """gold get_new_ed: re-extension against the true reference.

    Returns (ed, length, l_mem_ext), each (N,) int32.
    """
    if is_fwd:
        q_off = jnp.maximum(q_off, 0)
        max_len = q_off
    else:
        max_len = l_read - q_off
    length = jnp.minimum(LV_L, max_len)
    l_ext = jnp.zeros_like(q_off)

    def gather_q(q_off_c, l_ext_c, length_c):
        if is_fwd:
            return qslice13(codes_pk, buf_len, ridx, base + q_off_c, -1)
        return qslice13(codes_pk, buf_len, ridx, base + q_off_c + l_ext_c, 1)

    q = gather_q(q_off, l_ext, length)
    t = get_ref13(ix, t_off, length, not is_fwd)
    enter = active & (length > 0) & (t[:, 0] == q[:, 0])

    def cond(st):
        return st[6].any()

    def body(st):
        q_off_c, t_off_c, max_len_c, length_c, l_ext_c, _q, run, _t = st
        qv = gather_q(q_off_c, l_ext_c, length_c)
        tv = get_ref13(ix, t_off_c, length_c, not is_fwd)
        mtc = _leading_matches(tv, qv, length_c)
        stop = mtc <= 0
        adv = run & ~stop
        l_ext_n = jnp.where(adv, l_ext_c + mtc, l_ext_c)
        max_len_n = jnp.where(adv, max_len_c - mtc, max_len_c)
        length_n = jnp.where(adv, jnp.minimum(LV_L, max_len_n), length_c)
        if is_fwd:
            q_off_n = jnp.where(adv, q_off_c - mtc, q_off_c)
            t_off_n = jnp.where(adv, t_off_c - mtc, t_off_c)
        else:
            q_off_n = q_off_c
            t_off_n = jnp.where(adv, t_off_c + mtc, t_off_c)
        # re-gather for the next check / final LV inputs
        qn = gather_q(q_off_n, l_ext_n, length_n)
        tn = get_ref13(ix, t_off_n, length_n, not is_fwd)
        cont = adv & (length_n > 0)
        q_out = jnp.where(adv[:, None], qn, _q)
        t_out = jnp.where(adv[:, None], tn, _t)
        return (q_off_n, t_off_n, max_len_n, length_n, l_ext_n, q_out, cont,
                t_out)

    st = (q_off, t_off, max_len, length, l_ext, q, enter, t)
    st = jax.lax.while_loop(cond, body, st)
    _, _, _, length, l_ext, q, _, t = st
    ed = lv_batch(t[:, :LV_L + 1], q[:, :LV_L + 1], jnp.clip(length, 0, LV_L))
    return ed, length, l_ext


def map_seed_lanes(ix: IndexRefs, codes_pk, buf_len, q_mem, q_lv,
                   ridx, base, read_len, direction, seed_id,
                   sp_row, l_m0, sa_ok, sa_row, sa_l, q_off, active,
                   anchors, a_cnt, a_cap: int, occ_cap: int = 1000,
                   rows=None):
    """One map_seed per lane. Mutates (anchors, a_cnt); returns them plus
    per-lane max score (gold map_seed return value).

    anchors: (M, a_cap, A_NF) int32; a_cnt: (N,) int32. When ``rows``
    (N,) is given, lane i's anchors write to anchors[rows[i]] (M = full
    lane count; out-of-range rows are dropped) — this lets the ladder
    carry the big anchor buffer in FULL lane space and skip the
    per-iteration compaction gather/scatter of it. Without rows,
    M == N."""
    N = ridx.shape[0]
    lanes = jnp.arange(N, dtype=I32)
    wlanes = lanes if rows is None else rows
    a_rows = anchors.shape[0]
    l_m = l_m0.astype(I32)

    # ---- step 1: prefix ---------------------------------------------------
    l_pre0 = jnp.minimum(q_off + 1, LV_L)
    q_pre = qslice13(codes_pk, buf_len, ridx, base + q_off, -1)

    # pre-walk for lanes without an SA sample (collect <= 12 chars):
    # position space — the chars the LF walk would read are
    # text[p0-1], text[p0-2], ...; the walk stops at the first sampled
    # row (samp_bits), the first '#' char (sep_hash; the '#' step does
    # not advance), or the l_pre cap (which the reference overshoots to
    # 1 when l_pre == 0 — the check runs after the first step).
    need_walk = active & ~sa_ok
    b_p = sp_row.astype(I32)
    hash_hit = (b_p & SA_MASK) == 0
    L_t = ix.isa.shape[0]
    p0 = ix.row_pos[jnp.clip(b_p, 0, L_t - 1)]
    do_pre = need_walk & ~hash_hit
    cap_pre = jnp.maximum(l_pre0, 1)
    qs_pre, fs_pre = find_bit_high(ix.samp_bits, p0 - cap_pre, p0 - 1,
                                   do_pre)
    k_samp = jnp.where(fs_pre, p0 - qs_pre, 1 << 30)
    qh_pre, fh_pre = find_bit_high(ix.sep_hash, p0 - cap_pre, p0 - 1,
                                   do_pre)
    t_hash = jnp.where(fh_pre, p0 - qh_pre, 1 << 30)
    s_l = jnp.where(do_pre,
                    jnp.minimum(jnp.minimum(cap_pre, k_samp), t_hash - 1),
                    0)
    wch = collect_backward(ix.text_pk, ix.sep_any, p0 - 1, LV_L + 1)
    walk_chars = jnp.where(
        do_pre[:, None] & (jnp.arange(LV_L + 1)[None, :] < s_l[:, None]),
        wch, jnp.uint8(0))
    b_p = jnp.where(do_pre, ix.isa[jnp.clip(p0 - s_l, 0, L_t - 1)], b_p)
    walk_sampled = hash_hit | (fs_pre & (s_l == k_samp))

    # locate: sampled lanes (either from sa or from the walk)
    loc_row = jnp.where(sa_ok, sa_row.astype(I32), b_p)
    loc_sl = jnp.where(sa_ok, sa_l, s_l)
    have_uni1 = active & (sa_ok | walk_sampled)
    uni, u_off, t_off = get_uni(ix, loc_row, loc_sl, have_uni1)

    dead = jnp.zeros((N,), bool)
    # MIN_UNI_L check for lanes that already have a unitig
    short_uni = have_uni1 & (ix.uni_len[jnp.minimum(uni, ix.n_uni)] < MIN_UNI_L)
    dead = dead | short_uni

    l_pre = jnp.where(have_uni1, jnp.minimum(l_pre0, u_off), s_l)
    t_pre_ref = get_ref13(ix, t_off - 1, l_pre, False)
    t_pre = jnp.where(have_uni1[:, None], t_pre_ref, walk_chars)
    d_pre = lv_batch(t_pre[:, :LV_L + 1], q_pre[:, :LV_L + 1],
                     jnp.clip(l_pre, 0, LV_L))
    s = q_mem[jnp.clip(l_m, 0, q_mem.shape[0] - 1)] + q_lv[d_pre, l_pre]
    early1 = active & (s < MIN_S_1) & (l_pre == LV_L) & ~have_uni1
    dead = dead | early1

    # ---- step 2: continue LF walk to a sample for uni-less lanes ----------
    # position space: nearest sampled position strictly below the current
    # one (LF wraps cyclically past position 0 — samples are 1/8 dense so
    # the wrap search is one word scan in the rare case it happens)
    need_walk2 = active & ~dead & ~have_uni1
    p2 = p0 - s_l
    zero = jnp.zeros((N,), I32)
    q2, f2 = find_bit_high(ix.samp_bits, zero, p2 - 1, need_walk2)
    q2w, f2w = find_bit_high(ix.samp_bits, p2, zero + L_t - 1,
                             need_walk2 & ~f2)
    steps2 = jnp.where(f2, p2 - q2, p2 + (L_t - q2w))
    qf = jnp.where(f2, q2, q2w)
    b_p = jnp.where(need_walk2,
                    ix.isa[jnp.clip(qf, 0, L_t - 1)], b_p)
    s_l = jnp.where(need_walk2, s_l + steps2, s_l)
    uni2, u_off2, t_off2 = get_uni(ix, b_p, s_l, need_walk2)
    uni = jnp.where(need_walk2, uni2, uni)
    u_off = jnp.where(need_walk2, u_off2, u_off)
    t_off = jnp.where(need_walk2, t_off2, t_off)
    short2 = need_walk2 & (ix.uni_len[jnp.minimum(uni, ix.n_uni)] < MIN_UNI_L)
    dead = dead | short2

    # ---- suffix greedy extension + LV -------------------------------------
    live = active & ~dead
    q_off_r = q_off + l_m + 1
    uml = (ix.uni_len[jnp.minimum(uni, ix.n_uni)] - u_off - l_m).astype(U32)
    rml = (read_len - q_off_r).astype(U32)
    l_max_suf = jnp.minimum(uml, rml)
    has_suf = live & (l_max_suf != U32(0))
    l_suf = jnp.minimum(l_max_suf, U32(LV_L)).astype(I32)
    l_suf = jnp.where(has_suf, l_suf, 0)
    q_suf_i = q_off_r
    t_suf = get_ref13(ix, t_off + l_m, l_suf, True)
    q_suf = qslice13(codes_pk, buf_len, ridx, base + q_suf_i, 1)
    enter = has_suf & (l_suf > 0) & (t_suf[:, 0] == q_suf[:, 0])

    def scond(st):
        return st[7].any()

    def sbody(st):
        l_m_c, s_c, lms_c, l_suf_c, q_i_c, t_c, q_c, run = st
        mtc = _leading_matches(t_c, q_c, l_suf_c)
        adv = run & (mtc > 0)
        l_m_n = jnp.where(adv, l_m_c + mtc, l_m_c)
        s_n = jnp.where(
            adv,
            q_mem[jnp.clip(l_m_n, 0, q_mem.shape[0] - 1)] + q_lv[d_pre, l_pre],
            s_c)
        lms_n = jnp.where(adv, lms_c - mtc.astype(U32), lms_c)
        l_suf_n = jnp.where(adv, jnp.minimum(lms_n, U32(LV_L)).astype(I32),
                            l_suf_c)
        q_i_n = jnp.where(adv, q_i_c + mtc, q_i_c)
        t_n = get_ref13(ix, t_off + l_m_n, l_suf_n, True)
        q_n = qslice13(codes_pk, buf_len, ridx, base + q_i_n, 1)
        t_out = jnp.where(adv[:, None], t_n, t_c)
        q_out = jnp.where(adv[:, None], q_n, q_c)
        cont = adv & (l_suf_n > 0)
        return l_m_n, s_n, lms_n, l_suf_n, q_i_n, t_out, q_out, cont

    st = (l_m, s, l_max_suf, l_suf, q_suf_i, t_suf, q_suf, enter)
    st = jax.lax.while_loop(scond, sbody, st)
    l_m, s, l_max_suf, l_suf, q_suf_i, t_suf, q_suf, _ = st

    d_suf = lv_batch(t_suf[:, :LV_L + 1], q_suf[:, :LV_L + 1],
                     jnp.clip(l_suf, 0, LV_L))
    d_suf = jnp.where(has_suf, d_suf, 0)
    l_suf = jnp.where(has_suf, l_suf, 0)
    s = jnp.where(has_suf, s + q_lv[d_suf, l_suf], s)
    early2 = live & (s <= MIN_S_2) & (l_suf == LV_L)
    dead = dead | early2

    # ---- fan out over reference occurrences -------------------------------
    live = active & ~dead & (s > 0)
    uni_c = jnp.minimum(uni, ix.n_uni)
    rl_s = ix.uni_ref_list[uni_c]
    rl_e = ix.uni_ref_list[jnp.minimum(uni_c + 1, ix.n_uni)]
    n_occ = rl_e - rl_s
    huge = live & (n_occ > 50) & (n_occ >= 1000)
    fan = live & ~huge
    ref_search_l = (l_pre < LV_L) | (d_pre == 0)
    ref_search_r = (l_suf < LV_L) | (d_suf == 0)
    any_research = ref_search_l | ref_search_r

    max_s = jnp.zeros((N,), I32)

    def fcond(st):
        return st[4].any()

    def fbody(st):
        anchors_c, a_cnt_c, max_s_c, ci, run = st
        cic = jnp.clip(ci, 0, ix.rp_global_off.shape[0] - 1)
        g_off = ix.rp_global_off[cic]
        a_ll, a_le = l_pre, d_pre
        a_rl, a_re = l_suf, d_suf
        ed_l, len_l, lx_l = get_new_ed(
            ix, codes_pk, buf_len, ridx, base, q_off, g_off + u_off - 1,
            read_len, True, run & ref_search_l, q_lv)
        lx_l = jnp.where(ref_search_l, lx_l, 0)
        a_ll = jnp.where(ref_search_l, len_l, a_ll)
        a_le = jnp.where(ref_search_l, ed_l, a_le)
        a_mtch0 = l_m + lx_l
        ed_r, len_r, lx_r = get_new_ed(
            ix, codes_pk, buf_len, ridx, base, q_off + l_m + 1,
            g_off + u_off + l_m, read_len, False, run & ref_search_r, q_lv)
        a_rl = jnp.where(ref_search_r, len_r, a_rl)
        a_re = jnp.where(ref_search_r, ed_r, a_re)
        a_mtch = jnp.where(any_research,
                           a_mtch0 + jnp.where(ref_search_r, lx_r, 0), l_m)
        a_score = jnp.where(
            any_research,
            q_mem[jnp.clip(a_mtch, 0, q_mem.shape[0] - 1)]
            + q_lv[jnp.clip(a_le, 0, q_lv.shape[0] - 1),
                   jnp.clip(a_ll, 0, q_lv.shape[1] - 1)]
            + q_lv[jnp.clip(a_re, 0, q_lv.shape[0] - 1),
                   jnp.clip(a_rl, 0, q_lv.shape[1] - 1)],
            s)
        skip = any_research & (a_score < MIN_S_2)
        emit = run & ~skip
        max_s_c = jnp.where(emit, jnp.maximum(max_s_c, a_score), max_s_c)
        ref_id = ix.rp_ref_id[cic]
        glob = g_off + u_off - jnp.where(ref_search_l, lx_l, 0)
        rec = jnp.stack([
            a_mtch, a_score, a_ll, a_le, a_rl, a_re, direction, glob, ref_id,
            glob - ix.ref_off[ref_id],
            q_off + 1 - jnp.where(ref_search_l, lx_l, 0), seed_id,
        ], axis=1)
        slot = jnp.minimum(a_cnt_c, a_cap - 1)
        write = emit & (a_cnt_c < a_cap)
        wrow = jnp.where(write, wlanes, a_rows)  # OOB row -> dropped
        anchors_c = anchors_c.at[wrow, slot].set(rec, mode="drop")
        a_cnt_c = jnp.where(emit, a_cnt_c + 1, a_cnt_c)  # counts overflow too
        ci2 = ci + 1
        run2 = run & (ci2 < rl_e)
        return anchors_c, a_cnt_c, max_s_c, ci2, run2

    occ_run = fan & (n_occ > 0)
    st = (anchors, a_cnt, max_s, rl_s, occ_run)
    anchors, a_cnt, max_s, _, _ = jax.lax.while_loop(fcond, fbody, st)
    max_s = jnp.where(huge, 50, max_s)
    return anchors, a_cnt, max_s
