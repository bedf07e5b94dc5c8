"""Fast / slow classify ladders on device (src/cly.c:1478-1611).

Lane = (read, direction, island). The data-dependent probe ladder (stride
-2/-3/-7, score-gated breaks) runs as one `lax.while_loop` over lockstep
lanes; each iteration performs one FM MEM probe and (fast mode) the
interleaved map_seed anchor mapping whose max score drives the stride.

Host-side pre/post (cheap, per-lane numpy): lane construction from island
lists, `skip_next` island dropping, per-island anchor_useless marking.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ...constants import (
    MEM_SEARCH_FAST,
    MEM_SEARCH_SLOW,
    MIN_MEM_LEN_FAST,
    MIN_MEM_LEN_SLOW,
    PRE_IDX_MASK,
)
from . import fm as dev_fm
from .compaction import compact_rows
from .mapseed import A_NF, IndexRefs, map_seed_lanes
from .textwalk import pack2

I32 = jnp.int32

# SP_SET hot-tier size: interval counts per lane are tiny in practice
# (~1 interval per row walk, p99 row_walks/read ~= 35 on the demo), so
# the ladder carries a small interval buffer and re-runs the rare
# overflowing group at full IV_CAP (512, can never overflow).
IV_HOT = 32


def pack_anchors(anchors, a_cnt, pack_cap: int):
    """Compact per-lane anchor buffers into one flat (pack_cap, A_NF+1)
    array on device, so the sparse (N, a_cap, A_NF) buffers never
    leave it. Returns
    (packed, base, overflow) with base = exclusive prefix of a_cnt.

    A 13th column holds the per-island anchor_useless mark (score below
    the island's top score, floor 35 — gold fast/slow_classify both mark
    per island == per lane here), so downstream chaining never needs the
    rows on host."""
    N, A, F = anchors.shape
    cnt = jnp.minimum(a_cnt, A)
    slot = jnp.arange(A, dtype=I32)[None, :]
    valid = slot < cnt[:, None]
    top = jnp.max(jnp.where(valid, anchors[:, :, 1], 35),
                  axis=1, initial=35)
    useless = (anchors[:, :, 1] < top[:, None]).astype(I32)
    anchors = jnp.concatenate([anchors, useless[:, :, None]], axis=2)
    base = jnp.cumsum(cnt) - cnt
    dest = base[:, None] + slot
    ok = valid & (dest < pack_cap)
    dest_safe = jnp.where(ok, dest, pack_cap)
    packed = jnp.zeros((pack_cap + 1, F + 1), I32).at[dest_safe].set(anchors)
    overflow = (base + cnt > pack_cap).any()
    return packed[:pack_cap], base, overflow

# slow-mode collected MEM record: (match_len, sp, sa_row, sa_ok, sa_l, str_idx)
M_NF = 6


def _compact(full_tree, rows_g):
    return jax.tree.map(lambda f: f[rows_g], full_tree)


def _scatter(full_tree, comp_tree, rows_s):
    # empty compact slots carry index N (out of bounds) and are dropped
    # by jax scatter semantics — see compaction.scatter_rows
    return jax.tree.map(lambda f, c: f.at[rows_s].set(c),
                        full_tree, comp_tree)


def _unpack_lanes(lane_args):
    """lane_args: either the legacy 8-tuple of (N,) arrays or ONE
    (8, N) int32 array (one upload instead of eight). Returns the 8
    per-lane vectors."""
    if not isinstance(lane_args, (tuple, list)):
        c = lane_args
        return (c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7] != 0)
    return lane_args


def pack_info(base, acnt, skip, ivovf):
    """(N, 4) int32 host-fetch row [base, acnt, skip, iv_ovf] — built
    INSIDE the kernel jit so the host needs zero extra device ops
    before its one packed fetch."""
    return jnp.stack([base.astype(I32), acnt.astype(I32),
                      skip.astype(I32), ivovf.astype(I32)], axis=1)


@functools.partial(jax.jit,
                   static_argnames=("l_ek", "a_cap", "pack_cap", "bl",
                                    "iv_cap"))
def fast_ladder(ixr: IndexRefs, fm_blocks, rank6, hash13, codes_fr, buf_len,
                pre13_fr, q_mem, q_lv, lane_args, *, l_ek: int, a_cap: int,
                pack_cap: int, bl: int | None = None,
                iv_cap: int | None = None):
    """Run the full fast ladder for every lane; returns
    (packed_anchors, info, pack_overflow) with info (N, 4) int32 =
    [a_base, a_cnt, skip_flag, iv_ovf] (pack_info) — skip_flag True
    where the island ended with max_score > 512 (drops the NEXT island,
    applied on host); iv_ovf True where the lane's SP_SET hot tier
    overflowed (results unreliable: the classifier re-dispatches such
    groups with iv_cap=None = full, which cannot overflow).

    Each iteration compacts the still-active lanes to width bl before
    the probe + map_seed work (gather/scatter of per-lane state): the
    ladder's stride/break schedule makes occupancy decay fast, and the
    probe cost is per-lane gathers, so the lockstep width is the lever.
    Lanes beyond bl capacity run on later iterations."""
    (ridx, base, read_len, direction, sid, seed_off, seed_len,
     lane_on) = _unpack_lanes(lane_args)
    N = ridx.shape[0]
    if bl is None:
        bl = max(64, N // 4)
    bl = min(bl, N)
    min_index = MIN_MEM_LEN_FAST - l_ek
    codes_pk = pack2(codes_fr)

    anchors = jnp.zeros((N, a_cap, A_NF), I32)
    a_cnt = jnp.zeros((N,), I32)
    spset, spcount = dev_fm.spset_init(N, iv_cap)
    j = seed_len - 1
    active = lane_on & (j >= min_index)
    skip_flag = jnp.zeros((N,), bool)

    def cond(st):
        return st[0].any()

    def body(st):
        active, j, spset, spcount, anchors, a_cnt, skip_flag = st
        rg, rows_s, valid = compact_rows(active, bl)
        # `anchors` (N, a_cap, A_NF) stays in FULL lane space: map_seed
        # writes rows directly via rows_s (drop-scatter). Compacting it
        # through gather/scatter each iteration would cost a full row
        # gather + scatter of the biggest buffer per trip.
        full = (active, j, spset, spcount, a_cnt, skip_flag,
                ridx, base, read_len, direction, sid, seed_off)
        (act_c, j_c, sps_c, spc_c, ac_c, skip_c, ridx_c, base_c,
         rl_c, dir_c, sid_c, soff_c) = _compact(full, rg)
        act_c = act_c & valid

        ki = soff_c + j_c
        str_idx = ki + l_ek - 1
        pre_v = pre13_fr[ridx_c,
                         jnp.clip(base_c + ki, 0, pre13_fr.shape[1] - 1)]
        pre_v = pre_v & jnp.int32(PRE_IDX_MASK)
        out = dev_fm.mem_probe.__wrapped__(
            ixr, fm_blocks, rank6, hash13, codes_fr, codes_pk,
            str_idx, pre_v, act_c, sps_c, spc_c,
            MEM_SEARCH_FAST, MIN_MEM_LEN_FAST - 1, col_off=base_c,
            row_idx=ridx_c)
        (r_len, r_sp, r_sa, r_sa_ok, r_sa_l, r_valid, sps_c, spc_c) = out
        has_mem = r_valid.any(axis=1) & act_c

        max_score = jnp.zeros((bl,), I32)

        def map_body(carry):
            k, an_f, ac_c, max_score = carry
            dx = lambda a: jax.lax.dynamic_index_in_dim(a, k, 1, False)
            mk = act_c & dx(r_valid)
            q_off = str_idx - dx(r_len)
            an_f, ac_c, ms = map_seed_lanes(
                ixr, codes_pk, buf_len, q_mem, q_lv, ridx_c, base_c, rl_c,
                dir_c, sid_c, dx(r_sp).astype(I32), dx(r_len),
                dx(r_sa_ok), dx(r_sa).astype(I32), dx(r_sa_l), q_off,
                mk, an_f, ac_c, a_cap=a_cap, rows=rows_s)
            max_score = jnp.where(mk, jnp.maximum(max_score, ms), max_score)
            return k + 1, an_f, ac_c, max_score

        # map only the row slots some lane has a valid MEM in (p90 = 1
        # valid row per probe): one map_seed_lanes sweep per occupied
        # slot instead of a fixed MEM_SEARCH_FAST of them
        occ = act_c[:, None] & r_valid
        kmap = jnp.max(jnp.where(occ, jnp.arange(r_valid.shape[1],
                                                 dtype=I32)[None, :] + 1, 0))
        _, anchors, ac_c, max_score = jax.lax.while_loop(
            lambda c: c[0] < kmap, map_body,
            (jnp.int32(0), anchors, ac_c, max_score))

        j2 = jnp.where(act_c,
                       jnp.where(has_mem,
                                 j_c - 3 - jnp.where(max_score > 35, 7, 0),
                                 j_c - 2),
                       j_c)
        brk = act_c & (max_score > 256)
        skip_c = skip_c | (act_c & (max_score > 512))
        act2_c = act_c & ~brk & (j2 >= min_index)

        mut_full = (active, j, spset, spcount, a_cnt, skip_flag)
        mut_comp = (act2_c, j2, sps_c, spc_c, ac_c, skip_c)
        out = _scatter(mut_full, mut_comp, rows_s)
        return out[:4] + (anchors,) + out[4:]

    st = (active, j, spset, spcount, anchors, a_cnt, skip_flag)
    st = jax.lax.while_loop(cond, body, st)
    _, _, _, spcount, anchors, a_cnt, skip_flag = st
    packed, a_base, p_ovf = pack_anchors(anchors, a_cnt, pack_cap)
    return (packed,
            pack_info(a_base, a_cnt, skip_flag, spcount[:, 2] > 0),
            p_ovf)


@functools.partial(jax.jit,
                   static_argnames=("l_ek", "a_cap", "m_cap", "pack_cap",
                                    "bl", "iv_cap"))
def slow_ladder(ixr: IndexRefs, fm_blocks, rank6, hash13, codes_fr, buf_len,
                pre13_fr, q_mem, q_lv, lane_args, *, l_ek: int, a_cap: int,
                m_cap: int, pack_cap: int, bl: int | None = None,
                iv_cap: int | None = None):
    """Slow-mode ladder: collect all MEMs (stride 2), sort by match_len
    desc, map the first 8. Returns (packed_anchors, info,
    pack_overflow) with info = [a_base, a_cnt, mem_overflow, iv_ovf]
    (pack_info; see fast_ladder).
    Active lanes are compacted to width bl per iteration (see
    fast_ladder)."""
    (ridx, base, read_len, direction, sid, seed_off, seed_len,
     lane_on) = _unpack_lanes(lane_args)
    N = ridx.shape[0]
    if bl is None:
        bl = max(64, N // 4)
    bl = min(bl, N)
    lanes_c = jnp.arange(bl, dtype=I32)
    min_match_len = min(MIN_MEM_LEN_SLOW - 1, l_ek + 1)
    codes_pk = pack2(codes_fr)

    spset, spcount = dev_fm.spset_init(N, iv_cap)
    mems = jnp.zeros((N, m_cap, M_NF), I32)
    m_cnt = jnp.zeros((N,), I32)
    j = seed_len - 1
    active = lane_on & (j >= 1)

    def cond(st):
        return st[0].any()

    def body(st):
        active, j, spset, spcount, mems, m_cnt = st
        rg, rows_s, valid = compact_rows(active, bl)
        # `mems` (N, m_cap, M_NF) stays in FULL lane space (drop-scatter
        # writes via rows_s) — see fast_ladder's anchors note.
        full = (active, j, spset, spcount, m_cnt,
                ridx, base, seed_off)
        (act_c, j_c, sps_c, spc_c, mc_c, ridx_c, base_c,
         soff_c) = _compact(full, rg)
        act_c = act_c & valid

        ki = soff_c + j_c
        str_idx = ki + l_ek - 1
        pre_v = pre13_fr[ridx_c,
                         jnp.clip(base_c + ki, 0, pre13_fr.shape[1] - 1)]
        pre_v = pre_v & jnp.int32(PRE_IDX_MASK)
        out = dev_fm.mem_probe.__wrapped__(
            ixr, fm_blocks, rank6, hash13, codes_fr, codes_pk,
            str_idx, pre_v, act_c, sps_c, spc_c,
            MEM_SEARCH_SLOW, min_match_len, col_off=base_c, row_idx=ridx_c)
        (r_len, r_sp, r_sa, r_sa_ok, r_sa_l, r_valid, sps_c, spc_c) = out

        def coll_body(carry):
            k, mem_f, mc_c = carry
            dx = lambda a: jax.lax.dynamic_index_in_dim(a, k, 1, False)
            take = act_c & dx(r_valid)
            rec = jnp.stack([
                dx(r_len), dx(r_sp).astype(I32), dx(r_sa).astype(I32),
                dx(r_sa_ok).astype(I32), dx(r_sa_l), str_idx], axis=1)
            slot = jnp.minimum(mc_c, m_cap - 1)
            write = take & (mc_c < m_cap)
            wrow = jnp.where(write, rows_s, N)  # OOB row -> dropped
            mem_f = mem_f.at[wrow, slot].set(rec, mode="drop")
            mc_c = jnp.where(take, mc_c + 1, mc_c)
            return k + 1, mem_f, mc_c

        occ = act_c[:, None] & r_valid
        kmax = jnp.max(jnp.where(occ, jnp.arange(r_valid.shape[1],
                                                 dtype=I32)[None, :] + 1, 0))
        _, mems, mc_c = jax.lax.while_loop(
            lambda c: c[0] < kmax, coll_body, (jnp.int32(0), mems, mc_c))
        j2 = jnp.where(act_c, j_c - 2, j_c)
        act2_c = act_c & (j2 >= 1)

        mut_full = (active, j, spset, spcount, m_cnt)
        mut_comp = (act2_c, j2, sps_c, spc_c, mc_c)
        out = _scatter(mut_full, mut_comp, rows_s)
        return out[:4] + (mems,) + out[4:]

    st = (active, j, spset, spcount, mems, m_cnt)
    st = jax.lax.while_loop(cond, body, st)
    _, _, _, spcount, mems, m_cnt = st
    lanes = jnp.arange(N, dtype=I32)
    overflow = m_cnt > m_cap

    # stable sort by match_len desc (gold _qsort_by_match_len)
    stored = jnp.minimum(m_cnt, m_cap)
    valid = jnp.arange(m_cap)[None, :] < stored[:, None]
    key = jnp.where(valid, -mems[:, :, 0], 1 << 30)
    order = jnp.argsort(key, axis=1, stable=True)

    anchors = jnp.zeros((N, a_cap, A_NF), I32)
    a_cnt = jnp.zeros((N,), I32)

    def map_body(carry):
        k, anchors, a_cnt = carry
        sel = jax.lax.dynamic_index_in_dim(order, k, 1, False)
        rec = mems[lanes, jnp.minimum(sel, m_cap - 1)]
        ok = lane_on & (k < stored)
        str_idx = rec[:, 5]
        q_off = str_idx - rec[:, 0]
        anchors, a_cnt, _ms = map_seed_lanes(
            ixr, codes_pk, buf_len, q_mem, q_lv, ridx, base, read_len,
            direction, sid, rec[:, 1], rec[:, 0], rec[:, 3].astype(bool),
            rec[:, 2], rec[:, 4], q_off, ok, anchors, a_cnt, a_cap=a_cap)
        return k + 1, anchors, a_cnt

    # the reference maps the first MEM_SEARCH_SLOW sorted MEMs; stop at
    # the deepest any lane actually stores
    kmap = jnp.minimum(jnp.max(jnp.where(lane_on, stored, 0)),
                       MEM_SEARCH_SLOW)
    _, anchors, a_cnt = jax.lax.while_loop(
        lambda c: c[0] < kmap, map_body, (jnp.int32(0), anchors, a_cnt))
    packed, a_base, p_ovf = pack_anchors(anchors, a_cnt, pack_cap)
    return (packed,
            pack_info(a_base, a_cnt, overflow, spcount[:, 2] > 0),
            p_ovf)
