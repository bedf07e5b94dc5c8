"""9-mer sparse-DP rescoring on device (src/cly.c:2335-2849).

One lane = one read. The reference walks each chain's anchor gaps and
extends both ends through 600-bp windows, appending "sms" match nodes and
chaining them with a sequential sparse DP; absorbed sibling chains
(combine_chain) restart the walk. That whole control flow runs here as a
lockstep state machine inside ONE `lax.while_loop`:

  - each outer iteration runs PROC_PER_ITER cheap node-processing /
    control micro-steps, then one heavy window-fetch step for lanes that
    need a new window (fetches are ~30x rarer than node steps);
  - the backward DP scan over previous nodes is a masked max over the
    sms buffer (the reference's `break` prunes a t-window, expressible
    as a mask);
  - 9-mer probes hit a per-(read,direction) sorted k-mer table via
    batched binary search; match runs extend in 32-char chunks.

Lanes that exceed any fixed buffer (sms nodes, candidates per probe,
window size, chains) raise a fallback flag; the host redoes those reads
with the gold engine. On the demo corpus none overflow.

Modes: 0 done, 1 next-chain, 2 middle, 3 right, 4 left, 5 combine-middle.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ...constants import MIN_SCORE_MEM, OVER_SEARCH_M2, S_A_KMER_L
from .compaction import compact_cols, compact_rows, gather_rows, scatter_rows

I32 = jnp.int32
U32 = jnp.uint32
K9 = S_A_KMER_L

C_CAP = 8        # chains per read
A_CAP = 64       # anchors per read (main batch; the M3 sub-batch runs
#                  the same kernel at chain.M3_A2 — shapes are dynamic
#                  on inp.anchors.shape[1])
S_CAP = 128      # sms nodes per extension
P_CAP = 176      # 9-mer probes per window fetch ((704-9)/4)
H_CAP = 4        # candidate read positions per probe value
CF_CAP = 96      # valid candidates per fetch (stage-1 compaction)
F_CAP = 48       # leftmost survivors per fetch (stage-2, long runs)
W_CAP = 704      # window chars incl. 50-pad

M_DONE, M_NEXT, M_MID, M_RIGHT, M_LEFT = 0, 1, 2, 3, 4

# uint32 coordinates are carried as int32 BIT PATTERNS: wrapped values
# (a match crossing the read head / reference start) are negative ints
# whose u32 reinterpretation equals the reference's uint32. int32 adds
# are bit-equivalent to uint32 adds; ORDER comparisons go through
# .astype(U32) at exactly the points the C compares unsigned. The host
# maps a chain field back to gold's u32 domain with `value & 0xFFFFFFFF`.

# chain record fields
CF = ("ref_id", "direction", "sum_score", "anchor_number", "t_st", "t_ed",
      "q_st", "q_ed", "indel", "cur_anchor")
CF_N = len(CF)
(C_REF, C_DIR, C_SUM, C_ANUM, C_TST, C_TED, C_QST, C_QED, C_INDEL,
 C_CUR) = range(CF_N)

# anchor record fields: index_in_read, ref_offset, mtch_len, pre (-1 none)
AF_N = 4


class RescoreIn(NamedTuple):
    """Per-batch device inputs (B = reads)."""
    chains: jnp.ndarray     # (B, C_CAP, CF_N) int32
    n_chains: jnp.ndarray   # (B,)
    anchors: jnp.ndarray    # (B, A_CAP, AF_N) int32
    schash: jnp.ndarray     # (B, 2*C_CAP, 3) int32 [key, ci, s_or_e]
    n_hash: jnp.ndarray     # (B,)
    codes_fr: jnp.ndarray   # (B, 2L) uint8
    buf_len: jnp.ndarray    # (B,)
    read_len: jnp.ndarray   # (B,)


REF_ROW_B = 256   # packed-ref row width in bytes for the window fetch


def _ref_as_rows(ref_bin):
    """Reshape the packed reference into (NR, REF_ROW_B) rows (padded).

    A window fetch is then 2 row-gathers, not width/4 element-gathers.
    Built once per kernel call outside the while_loop.

    Sharded tables (parallel/sharded.py) expose the same row view via
    as_rows: the row gather runs shard-locally + psum over idx."""
    if hasattr(ref_bin, "as_rows"):
        return ref_bin.as_rows(REF_ROW_B)
    n = ref_bin.shape[0]
    pad = (-n) % REF_ROW_B
    return jnp.pad(ref_bin, (0, pad)).reshape(-1, REF_ROW_B)


def _ref_chars(ref_rows, ref_bin, n_bases, offset, width):
    """(N, width) ref chars at offset..offset+width-1 (gold get_ref:
    negative start clamps to 0 first, then indices clip).

    Two REF_ROW_B row-gathers per lane cover width/4 + alignment bytes;
    the per-lane byte alignment is resolved with a log2 funnel of
    static shifts (8 stages of elementwise where), and the char-in-byte
    alignment with a 4-way select. Chars past n_bases replicate the
    last char (gold clip semantics)."""
    N = offset.shape[0]
    off0 = jnp.maximum(offset, 0)
    nb = width // 4 + 1
    assert nb + REF_ROW_B - 1 <= 2 * REF_ROW_B
    b0 = off0 >> 2
    r0 = b0 // REF_ROW_B
    NR = ref_rows.shape[0]
    pair = jnp.concatenate(
        [ref_rows[jnp.clip(r0, 0, NR - 1)],
         ref_rows[jnp.clip(r0 + 1, 0, NR - 1)]], axis=1)  # (N, 2*ROW)
    shift = b0 - r0 * REF_ROW_B  # 0..ROW-1
    x = pair
    s = REF_ROW_B >> 1
    while s >= 1:
        sel = (shift & s) != 0
        x = jnp.where(sel[:, None],
                      jnp.pad(x[:, s:], ((0, 0), (0, s))), x)
        s >>= 1
    byts = x[:, :nb]
    chars = jnp.stack([(byts >> 6) & 3, (byts >> 4) & 3,
                       (byts >> 2) & 3, byts & 3], axis=2)
    chars = chars.reshape(chars.shape[0], 4 * nb)  # chars at 4*b0 ...
    a = (off0 & 3)[:, None]
    win = chars[:, 0:width]
    for s in (1, 2, 3):
        win = jnp.where(a == s, chars[:, s : s + width], win)
    last = (ref_bin[(n_bases - 1) >> 2]
            >> jnp.uint8(6 - (((n_bases - 1) & 3) << 1))) & jnp.uint8(3)
    idx = off0[:, None] + jnp.arange(width, dtype=I32)[None, :]
    return jnp.where(idx >= n_bases, last, win)


def _probe_hits(rk_row, rk_n, pv, p_on):
    """All read positions whose 9-mer equals each probe value, by a
    full compare-scan against the lane's UNSORTED per-position 9-mer
    row (an element scan is far cheaper than a gathered element, so
    scanning the whole K-row replaces a binary-search/gather scheme and
    the per-batch argsort it needed).

    rk_row: (N, K) per-position 9-mer values for each lane's chain
    direction; rk_n: (N,) valid positions; pv: (N, P) probe values.
    Returns (qpos (N, P, H_CAP) ascending positions (K = no hit),
    cnt (N, P) full multiplicity)."""
    N, K = rk_row.shape
    kpos = jnp.arange(K, dtype=I32)
    eq = (rk_row[:, None, :] == pv[:, :, None]) \
        & (kpos[None, None, :] < rk_n[:, None, None]) & p_on[:, :, None]
    cnt = jnp.sum(eq, axis=2, dtype=I32)
    prev = jnp.full(pv.shape, -1, I32)
    qpos_h = []
    for _ in range(H_CAP):
        cand = jnp.where(eq & (kpos[None, None, :] > prev[:, :, None]),
                         kpos[None, None, :], K)
        nxt = jnp.min(cand, axis=2).astype(I32)
        qpos_h.append(nxt)
        prev = nxt
    return jnp.stack(qpos_h, axis=2), cnt


def _popc(v):
    """SWAR popcount of uint32."""
    v = v - ((v >> 1) & U32(0x55555555))
    v = (v & U32(0x33333333)) + ((v >> 2) & U32(0x33333333))
    v = (v + (v >> 4)) & U32(0x0F0F0F0F)
    return ((v * U32(0x01010101)) >> 24).astype(I32)


def _pack2(ch):
    """(N, L) uint8 chars -> (N, ceil(L/16)) uint32, char j of a word at
    bits 2j..2j+1 (little-endian char order)."""
    N, L = ch.shape
    pad = (-L) % 16
    c = jnp.pad(ch, ((0, 0), (0, pad))).astype(jnp.uint32)
    c = c.reshape(N, -1, 16)
    sh = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, None, :]
    return jnp.sum(c << sh, axis=2).astype(jnp.uint32)


def _word16(pk, rows, base):
    """16-char packed value starting at char index `base` (per element).
    Out-of-range chars are garbage (zeros for base<0) — callers bound
    the usable length so garbage never counts."""
    b = jnp.maximum(base, 0)
    w0 = b >> 4
    sh = ((b & 15) << 1).astype(U32)
    kw = pk.shape[1]
    g0 = pk[rows, jnp.clip(w0, 0, kw - 1)]
    g1 = pk[rows, jnp.clip(w0 + 1, 0, kw - 1)]
    v = jnp.where(sh == 0, g0, (g0 >> sh) | (g1 << (U32(32) - sh)))
    # negative base: place char 0 at bit 2*(-base), zeros below. base
    # <= -16 means every char of the chunk sits below index 0 (a
    # backward run whose first compared char is already q < 0): the
    # whole word is char-0s, NOT codes[0] shifted by a clamped 15 — the
    # clamp bug dropped below-buffer runs gold extends (glibc
    # chunk-header zeros, src/cly.c MEM_search over-reads).
    neg = jnp.minimum(jnp.maximum(-base, 0), 16).astype(U32)
    sh2 = jnp.minimum(neg, U32(15)) << 1
    shifted = jnp.where(neg >= 16, U32(0), v << sh2)
    return jnp.where(base < 0, shifted, v)


def _run_len2(codes_pk, buf_len, rows, qstart, win_pk, win_len, wstart,
              step, cap, active):
    """Match-run length over a (B, F) candidate grid via packed 2-bit
    LCE: q[qstart + step*k] vs win[wstart + step*k], k < cap, stopping
    at the read buffer / window bounds.

    Each 16-char chunk costs 4 word-gathers per element (vs 32 char
    gathers unpacked, the kernel's dominant term). Matching
    prefix length comes from the XOR of funnel-extracted words: trailing
    2-bit zero groups for forward runs, leading for backward.

    codes_pk/win_pk are _pack2 of the read buffers / fetched windows;
    rows (B,) maps lanes to codes_pk rows; step (B, 1) +-1 applies to
    both sides (the walk directions always agree)."""
    B, F = qstart.shape
    n = jnp.zeros((B, F), I32)
    run = active & (cap > 0)
    blen = buf_len[rows][:, None]
    wlen = win_len[:, None]
    wrows = jnp.arange(B, dtype=I32)[:, None]
    rrows = rows[:, None]

    def body(st):
        n, run = st
        qi = qstart + step * n
        wi = wstart + step * n
        fwd = step > 0
        qw = _word16(codes_pk, rrows, jnp.where(fwd, qi, qi - 15))
        ww = _word16(win_pk, wrows, jnp.where(fwd, wi, wi - 15))
        y = qw ^ ww
        y = (y | (y >> 1)) & U32(0x55555555)
        t = (y & (~y + U32(1))) - U32(1)
        m_fwd = _popc(t & U32(0x55555555))
        s = y | (y >> 2)
        s = s | (s >> 4)
        s = s | (s >> 8)
        s = s | (s >> 16)
        m_bwd = 16 - _popc(s & U32(0x55555555))
        m = jnp.where(fwd, m_fwd, m_bwd)
        # chars available from qi to the boundary. Forward past the
        # buffer end mismatches; backward runs may cross BELOW q=0 and
        # compare as char 0 (_word16 zero-fills below base 0 — the
        # reference walks into glibc chunk-header 0x00 bytes there, see
        # gold rescore._mem_q), so only the cap bounds them.
        q_remain = jnp.where(fwd, jnp.where(qi >= 0, blen - qi, 0),
                             jnp.where(qi < blen, jnp.int32(1 << 30), 0))
        w_remain = jnp.where(fwd, jnp.where(wi >= 0, wlen - wi, 0),
                             jnp.where(wi < wlen, wi + 1, 0))
        lim = jnp.maximum(
            jnp.minimum(jnp.minimum(q_remain, w_remain), cap - n), 0)
        adv = jnp.minimum(m, jnp.minimum(lim, 16))
        n2 = jnp.where(run, n + adv, n)
        run2 = run & (adv == 16) & (n2 < cap)
        return n2, run2

    n, _ = jax.lax.while_loop(lambda s: s[1].any(), body, (n, run))
    return jnp.minimum(n, jnp.maximum(cap, 0))


def _build_rk_tables(codes_fr, read_len):
    """Per-(read, direction) POSITION-ORDERED 9-mer value tables.

    Returns vals (B, 2, K), axis1 indexed by direction value (0=REVERSE
    strand at [rl:2rl], 1=FORWARD at [0:rl]); K = codes_fr.shape[1]//2;
    entry k = 9-mer value at read position k (INT32_MAX past the valid
    tail). Probes hit this with a full compare-scan (_probe_hits), so
    no sorting is needed — hits emerge in ascending position order,
    which IS the gold ReadKmerIndex tie order."""
    B, L2 = codes_fr.shape
    K = L2 // 2
    c32 = codes_fr.astype(jnp.uint32)
    n_k_full = L2 - K9 + 1
    vals_full = jnp.zeros((B, n_k_full), jnp.uint32)
    for j in range(K9):
        vals_full = vals_full | (c32[:, j : j + n_k_full]
                                 << jnp.uint32(2 * (K9 - 1 - j)))
    rl = read_len
    n_k9 = jnp.maximum(rl - K9 + 1, 0)
    ar = jnp.arange(K, dtype=I32)[None, :]
    fwd_vals = vals_full[:, :K].astype(I32)
    # rev row = vals_full shifted left by rl chars (per-lane): a log2
    # funnel of static shifts instead of a (B, K) element gather
    x = vals_full
    s = 1
    while s <= K:
        s <<= 1
    s >>= 1
    while s >= 1:
        sel = (rl & s) != 0
        x = jnp.where(sel[:, None], jnp.pad(x[:, s:], ((0, 0), (0, s))), x)
        s >>= 1
    rev_vals = x[:, :K].astype(I32)
    big = jnp.int32(np.iinfo(np.int32).max)
    valid = ar < n_k9[:, None]
    fwd_vals = jnp.where(valid, fwd_vals, big)
    rev_vals = jnp.where(valid, rev_vals, big)
    return jnp.stack([rev_vals, fwd_vals], axis=1)   # axis1: 0=REV, 1=FWD


class VMState(NamedTuple):
    mode: jnp.ndarray        # (B,)
    chain_i: jnp.ndarray
    chains: jnp.ndarray      # (B, C_CAP, CF_N) — live, mutated by combine
    # side registers
    side_total: jnp.ndarray  # total_max_score (+10000 domain)
    score_ori: jnp.ndarray
    c_t_off: jnp.ndarray
    last_search: jnp.ndarray  # bool
    # sms buffer
    sms: jnp.ndarray         # (B, S_CAP, 4) [q, t, len, score]
    n_sms: jnp.ndarray
    cur_sms: jnp.ndarray
    max_id: jnp.ndarray
    # middle walk
    mid_cur: jnp.ndarray     # anchor index (-1 none)
    mid_score: jnp.ndarray   # +10000 domain
    mid_is_combine: jnp.ndarray  # bool
    save_side: jnp.ndarray   # mode to restore after combine-middle
    save_nodemax: jnp.ndarray
    save_len: jnp.ndarray
    fallback: jnp.ndarray    # bool
    fb_reason: jnp.ndarray   # int32 bitmask (1 mid>W, 2 left-wrap,
                             # 4 probe-hits, 8 F_CAP, 16 sms, 32 overcap)
    need_fetch: jnp.ndarray  # bool — lane waits for the fetch step


def _side_complete(st: VMState, m, lanes):
    """Apply right/left break: writeback + transition. m: lanes breaking."""
    chains, sms = st.chains, st.sms
    ci = jnp.clip(st.chain_i, 0, C_CAP - 1)
    is_r = st.mode == M_RIGHT
    best = sms[lanes, jnp.clip(st.max_id, 0, S_CAP - 1)]
    # right: q_ed/t_ed = best.q/t + best.len + K9 ; left: q_st/t_st = best.q/t
    qv = jnp.where(is_r, best[:, 0] + best[:, 2] + K9, best[:, 0])
    tv = jnp.where(is_r, best[:, 1] + best[:, 2] + K9, best[:, 1])
    chains = chains.at[lanes, ci, C_QED].set(
        jnp.where(m & is_r, qv, chains[lanes, ci, C_QED]))
    chains = chains.at[lanes, ci, C_TED].set(
        jnp.where(m & is_r, tv, chains[lanes, ci, C_TED]))
    chains = chains.at[lanes, ci, C_QST].set(
        jnp.where(m & ~is_r, qv, chains[lanes, ci, C_QST]))
    chains = chains.at[lanes, ci, C_TST].set(
        jnp.where(m & ~is_r, tv, chains[lanes, ci, C_TST]))
    # right -> setup left ; left -> store sum_score, next chain
    go_left = m & is_r
    q_st = chains[lanes, ci, C_QST]
    t_st = chains[lanes, ci, C_TST]
    seed = jnp.stack([q_st, t_st, jnp.zeros_like(q_st), st.side_total], 1)
    sms = jnp.where(go_left[:, None, None],
                    sms.at[:, 0, :].set(seed), sms)
    chains = chains.at[lanes, ci, C_SUM].set(
        jnp.where(m & ~is_r, st.side_total - 10000,
                  chains[lanes, ci, C_SUM]))
    return st._replace(
        chains=chains, sms=sms,
        mode=jnp.where(go_left, M_LEFT, jnp.where(m, M_NEXT, st.mode)),
        score_ori=jnp.where(go_left, st.side_total, st.score_ori),
        side_total=st.side_total,
        c_t_off=jnp.where(go_left, t_st + 3, st.c_t_off),
        last_search=jnp.where(m, False, st.last_search),
        n_sms=jnp.where(go_left, 1, st.n_sms),
        cur_sms=jnp.where(go_left, 1, st.cur_sms),
        max_id=jnp.where(go_left, 0, st.max_id),
        need_fetch=jnp.where(m, go_left, st.need_fetch))


def _proc_micro(st: VMState, inp: RescoreIn, rows=None):
    """One cheap micro-step: control transitions + one sms node per lane.

    `rows` maps (compacted) lanes to rows of the batch-wide inp tables;
    identity when None."""
    B = st.mode.shape[0]
    lanes = jnp.arange(B, dtype=I32)
    if rows is None:
        rows = lanes
    n_chains = inp.n_chains[rows]
    n_hash = inp.n_hash[rows]
    chains, sms = st.chains, st.sms

    # ---- M_NEXT: advance to the next unscored chain -----------------------
    m_next = (st.mode == M_NEXT) & ~st.need_fetch
    nci = st.chain_i + 1
    # first slot >= nci with sum_score != 0 (vectorized over C_CAP)
    slots_c = jnp.arange(C_CAP, dtype=I32)[None, :]
    cand_ok = ((slots_c >= nci[:, None]) & (slots_c < n_chains[:, None])
               & (chains[:, :, C_SUM] != 0))
    pick = jnp.where(cand_ok.any(axis=1),
                     jnp.argmax(cand_ok, axis=1).astype(I32), C_CAP)
    done = m_next & (pick >= n_chains)
    start = m_next & ~done
    ci2 = jnp.where(m_next, pick, st.chain_i)
    cur_anchor = chains[lanes, jnp.clip(ci2, 0, C_CAP - 1), C_CUR]
    st = st._replace(
        mode=jnp.where(done, M_DONE, jnp.where(start, M_MID, st.mode)),
        chain_i=ci2,
        mid_cur=jnp.where(start, cur_anchor, st.mid_cur),
        mid_score=jnp.where(start, 10000, st.mid_score),
        mid_is_combine=jnp.where(start, False, st.mid_is_combine),
        n_sms=jnp.where(start, 0, st.n_sms),
        cur_sms=jnp.where(start, 0, st.cur_sms))
    chains = st.chains

    # ---- M_MID control: gap advance / completion --------------------------
    m_mid = (st.mode == M_MID) & ~st.need_fetch & (st.cur_sms >= st.n_sms)
    a_cap = inp.anchors.shape[1]   # 64 main batch / 512 M3 sub-batch
    pre = inp.anchors[rows, jnp.clip(st.mid_cur, 0, a_cap - 1), 3]
    cur_m = inp.anchors[rows, jnp.clip(st.mid_cur, 0, a_cap - 1), 2]
    terminal = m_mid & (pre < 0)
    mid_score2 = jnp.where(terminal, st.mid_score + cur_m - K9 + 1,
                           st.mid_score)
    st = st._replace(mid_score=mid_score2,
                     need_fetch=st.need_fetch | (m_mid & (pre >= 0)))

    # middle completion: own -> setup right; combine -> restore side
    own_done = terminal & ~st.mid_is_combine
    ci = jnp.clip(st.chain_i, 0, C_CAP - 1)
    q_ed = chains[lanes, ci, C_QED]
    t_ed = chains[lanes, ci, C_TED]
    seed_r = jnp.stack([q_ed, t_ed, jnp.full((B,), 1 - K9, I32),
                        st.mid_score], 1)
    sms = jnp.where(own_done[:, None, None], sms.at[:, 0, :].set(seed_r), sms)
    st = st._replace(
        sms=sms,
        mode=jnp.where(own_done, M_RIGHT, st.mode),
        score_ori=jnp.where(own_done, st.mid_score, st.score_ori),
        side_total=jnp.where(own_done, st.mid_score, st.side_total),
        c_t_off=jnp.where(own_done, t_ed - 3, st.c_t_off),
        last_search=jnp.where(own_done, False, st.last_search),
        n_sms=jnp.where(own_done, 1, st.n_sms),
        cur_sms=jnp.where(own_done, 1, st.cur_sms),
        max_id=jnp.where(own_done, 0, st.max_id),
        need_fetch=jnp.where(own_done, True, st.need_fetch))

    comb_done = terminal & st.mid_is_combine
    total_c = (jnp.maximum(st.score_ori, st.save_nodemax) - st.save_len
               + st.mid_score - 10000)
    is_r = st.save_side == M_RIGHT
    q_anchor = jnp.where(is_r, st.chains[lanes, ci, C_QED],
                         st.chains[lanes, ci, C_QST])
    t_anchor = jnp.where(is_r, st.chains[lanes, ci, C_TED],
                         st.chains[lanes, ci, C_TST])
    seed_c = jnp.stack([q_anchor, t_anchor,
                        jnp.where(is_r, -K9, 0), total_c], 1)
    sms2 = jnp.where(comb_done[:, None, None],
                     st.sms.at[:, 0, :].set(seed_c), st.sms)
    st = st._replace(
        sms=sms2,
        mode=jnp.where(comb_done, st.save_side, st.mode),
        score_ori=jnp.where(comb_done, total_c, st.score_ori),
        side_total=jnp.where(comb_done, total_c, st.side_total),
        c_t_off=jnp.where(comb_done, t_anchor, st.c_t_off),
        mid_is_combine=jnp.where(comb_done, False, st.mid_is_combine),
        n_sms=jnp.where(comb_done, 1, st.n_sms),
        cur_sms=jnp.where(comb_done, 1, st.cur_sms),
        max_id=jnp.where(comb_done, 0, st.max_id),
        need_fetch=jnp.where(comb_done, True, st.need_fetch))

    # ---- side loops needing a window --------------------------------------
    m_side = ((st.mode == M_RIGHT) | (st.mode == M_LEFT)) & ~st.need_fetch
    st = st._replace(need_fetch=st.need_fetch
                     | (m_side & (st.cur_sms >= st.n_sms)))

    # ---- node processing ---------------------------------------------------
    proc = (((st.mode == M_RIGHT) | (st.mode == M_LEFT) | (st.mode == M_MID))
            & ~st.need_fetch & (st.cur_sms < st.n_sms))
    sms = st.sms
    cs = jnp.clip(st.cur_sms, 0, S_CAP - 1)
    c = sms[lanes, cs]  # (B, 4)
    is_left = st.mode == M_LEFT
    is_mid = st.mode == M_MID
    slots = jnp.arange(S_CAP, dtype=I32)[None, :]
    prior = slots < st.cur_sms[:, None]
    pq, pt, plen, pscore = (sms[:, :, 0], sms[:, :, 1], sms[:, :, 2],
                            sms[:, :, 3])
    # right/mid formulas. Adds wrap like the C's uint32 (int32 bit
    # equivalence); ORDER comparisons are unsigned (see module header) —
    # a wrapped node's bounds wrap back SMALL so predecessors still chain
    u = lambda x: x.astype(U32)
    max_q = (c[:, 0] + 6)[:, None]
    max_t = (c[:, 1] + 6)[:, None]
    pre_q_ed = pq + plen + K9 - 1
    pre_t_ed = pt + plen + K9 - 1
    okA = (u(pre_q_ed) <= u(max_q)) & (u(pre_t_ed) <= u(max_t))
    brkA = u(pt + 600) < u(max_t)     # right only
    indelA = pq - pt - (max_q - max_t)
    ovA = jnp.maximum(pre_q_ed - c[:, 0][:, None], pre_t_ed - c[:, 1][:, None])
    newA = pscore + c[:, 2][:, None] - (jnp.abs(indelA) >> 3)
    newA = newA - jnp.where((u(pre_q_ed) > u(c[:, 0][:, None]))
                            | (u(pre_t_ed) > u(c[:, 1][:, None])),
                            ovA, 0)
    # left formulas
    min_q = (c[:, 0] + c[:, 2] - 6 + K9 - 1)[:, None]
    min_t = (c[:, 1] + c[:, 2] - 6 + K9 - 1)[:, None]
    okB = (u(pq) >= u(min_q)) & (u(pt) >= u(min_t))
    brkB = u(min_t + 600) < u(pt)
    indelB = pq - pt - (min_q - min_t)
    ovB = jnp.maximum(min_q + 6 - pq, min_t + 6 - pt)
    newB = pscore + c[:, 2][:, None] - (jnp.abs(indelB) >> 3)
    newB = newB - jnp.where((u(min_q + 6) > u(pq))
                            | (u(min_t + 6) > u(pt)), ovB, 0)

    ok = jnp.where(is_left[:, None], okB, okA)
    brk = jnp.where(is_left[:, None], brkB, brkA) & ~is_mid[:, None]
    indel_ok = jnp.abs(jnp.where(is_left[:, None], indelB, indelA)) <= 200
    new = jnp.where(is_left[:, None], newB, newA)
    # emulate the descending break: exclude slots <= the largest slot where
    # brk holds
    brk_slot = jnp.max(jnp.where(brk & prior, slots, -1), axis=1)
    consider = prior & ok & indel_ok & (slots > brk_slot[:, None])
    node_max = jnp.maximum(
        c[:, 2], jnp.max(jnp.where(consider, new, -(1 << 30)), axis=1))
    sms = sms.at[lanes, cs, 3].set(jnp.where(proc, node_max, c[:, 3]))
    st = st._replace(sms=sms, cur_sms=jnp.where(proc, st.cur_sms + 1,
                                                st.cur_sms))

    # mid: score = max(score, node_max)
    st = st._replace(mid_score=jnp.where(
        proc & is_mid, jnp.maximum(st.mid_score, node_max), st.mid_score))

    # side: combine check then total/break
    side_proc = proc & ~is_mid
    do_comb = side_proc & (c[:, 2] >= 8)
    dis = c[:, 1] - c[:, 0]
    c_q_pos = jnp.where(is_left, c[:, 0] + c[:, 2], c[:, 0])
    ch = st.chains
    ci = jnp.clip(st.chain_i, 0, C_CAP - 1)
    # vectorized over the 2*C_CAP hash entries; the original sequential
    # `~found` chain == taking the FIRST matching entry (conditions are
    # found-independent), so argmax over the match mask reproduces it
    ents = inp.schash[rows]                       # (B, 2C, 3)
    eci_a = jnp.clip(ents[:, :, 1], 0, C_CAP - 1)  # (B, 2C)
    l2 = lanes[:, None]
    dis_con = jnp.where(is_left[:, None],
                        ch[l2, eci_a, C_TED] - ch[l2, eci_a, C_QED],
                        ch[l2, eci_a, C_TST] - ch[l2, eci_a, C_QST])
    q_pos_con = jnp.where(is_left[:, None], ch[l2, eci_a, C_QED] - K9,
                          ch[l2, eci_a, C_QST])
    e_ar = jnp.arange(2 * C_CAP, dtype=I32)[None, :]
    okc = (do_comb[:, None] & (e_ar < n_hash[:, None])
           & (ents[:, :, 0] == (dis & 0xFF)[:, None])
           & (dis[:, None] == dis_con)
           & (ents[:, :, 1] != st.chain_i[:, None])
           & (jnp.where(is_left, 1, 0)[:, None] != ents[:, :, 2])
           & (jnp.abs(c_q_pos[:, None] - q_pos_con) < 8)
           & (ch[l2, eci_a, C_REF] == ch[lanes, ci, C_REF][:, None])
           & (ch[l2, eci_a, C_DIR] == ch[lanes, ci, C_DIR][:, None])
           & (ch[l2, eci_a, C_SUM] != 0)
           & (ents[:, :, 1] > st.chain_i[:, None]))
    found = okc.any(axis=1)
    first_e = jnp.argmax(okc, axis=1)
    found_ci = jnp.where(found, ents[lanes, first_e, 1], 0)
    # absorb
    aci = jnp.clip(found_ci, 0, C_CAP - 1)
    for fld, red in ((C_SUM, "add"), (C_ANUM, "add"), (C_INDEL, "add"),
                     (C_QST, "min"), (C_TST, "min"), (C_QED, "max"),
                     (C_TED, "max")):
        v_h = ch[lanes, ci, fld]
        v_a = ch[lanes, aci, fld]
        nv = (v_h + v_a if red == "add"
              else jnp.minimum(v_h, v_a) if red == "min"
              else jnp.maximum(v_h, v_a))
        ch = ch.at[lanes, ci, fld].set(jnp.where(found, nv, v_h))
    for fld in (C_SUM, C_TST, C_TED, C_QST, C_QED):
        ch = ch.at[lanes, aci, fld].set(
            jnp.where(found, 0, ch[lanes, aci, fld]))
    absorbed_cur = ch[lanes, aci, C_CUR]
    st = st._replace(
        chains=ch,
        mode=jnp.where(found, M_MID, st.mode),
        mid_cur=jnp.where(found, absorbed_cur, st.mid_cur),
        mid_score=jnp.where(found, 10000, st.mid_score),
        mid_is_combine=jnp.where(found, True, st.mid_is_combine),
        save_side=jnp.where(found, st.mode, st.save_side),
        save_nodemax=jnp.where(found, node_max, st.save_nodemax),
        save_len=jnp.where(found, c[:, 2], st.save_len),
        n_sms=jnp.where(found, 0, st.n_sms),
        cur_sms=jnp.where(found, 0, st.cur_sms))

    # total update + post-node break (non-combined side lanes)
    rest = side_proc & ~found
    upd = rest & (st.side_total < node_max)
    st = st._replace(
        side_total=jnp.where(upd, node_max, st.side_total),
        max_id=jnp.where(upd, st.cur_sms - 1, st.max_id))
    best_t = st.sms[lanes, jnp.clip(st.max_id, 0, S_CAP - 1), 1]
    brk_now = rest & jnp.where(
        is_left, (c[:, 1] + 1000).astype(U32) < best_t.astype(U32),
        c[:, 1].astype(U32) > (best_t + 1000).astype(U32))
    st = _side_complete(st, brk_now, lanes)
    return st


def _fetch_step(st: VMState, inp: RescoreIn, rk_tables, codes_pk, ref_rows,
                ref_bin, ref_off, ref_len_arr, n_bases: int, bf: int):
    """Heavy step, lane-compacted: gather the (<= bf) lanes that need a
    window fetch into a compact buffer, run the per-mode window logic at
    width bf, scatter the state back. Lanes beyond bf capacity keep
    need_fetch set and are served on a later iteration (they stall in
    the micro-steps meanwhile — correctness is unaffected).

    Fetch occupancy is low after the first iterations (most lanes are
    node-processing or done), so running the gather-heavy window work at
    bf << B is the main throughput lever of this kernel."""
    B = st.mode.shape[0]
    bf = min(bf, B)
    act_full = st.need_fetch & ~st.fallback & (st.mode >= M_MID)
    rows_g, rows_s, valid = compact_rows(act_full, bf)
    st_c = gather_rows(st, rows_g)
    # make invalid compact slots inert inside the body
    st_c = st_c._replace(need_fetch=st_c.need_fetch & valid,
                         fallback=st_c.fallback | ~valid)
    out_c = _fetch_body(st_c, rows_g, inp, rk_tables, codes_pk, ref_rows,
                        ref_bin, ref_off, ref_len_arr, n_bases)
    return scatter_rows(st, out_c, rows_s)


def _fetch_body(st: VMState, rows, inp: RescoreIn, rk_tables, codes_pk,
                ref_rows, ref_bin, ref_off, ref_len_arr, n_bases: int):
    """Window-fetch logic at compact width N: pre-checks, packed ref
    gather, 9-mer probe + match building, sms append, post-checks.
    `rows` maps compact lanes to rows of the batch-wide inp/rk tables;
    st is the compacted per-lane state."""
    B = st.mode.shape[0]
    lanes = jnp.arange(B, dtype=I32)
    ci = jnp.clip(st.chain_i, 0, C_CAP - 1)
    ch = st.chains
    is_mid = st.mode == M_MID
    is_r = st.mode == M_RIGHT
    is_l = st.mode == M_LEFT
    act = st.need_fetch & ~st.fallback & (is_mid | is_r | is_l)

    chain_ref = ch[lanes, ci, C_REF]
    chain_dir = ch[lanes, ci, C_DIR]
    t_glob = ref_off[jnp.clip(chain_ref, 0, ref_off.shape[0] - 1)]
    t_length = ref_len_arr[jnp.clip(chain_ref, 0, ref_off.shape[0] - 1)]
    q_st_c = ch[lanes, ci, C_QST]
    q_ed_c = ch[lanes, ci, C_QED]
    l_read = inp.read_len[rows]

    # ---- RIGHT pre-checks --------------------------------------------------
    next_step = (t_length - st.c_t_off).astype(U32)
    brk_r = act & is_r & (next_step < U32(MIN_SCORE_MEM))
    near_end_r = (l_read - q_ed_c) < 600
    brk_r = brk_r | (act & is_r & ~brk_r & near_end_r & st.last_search)
    # ---- LEFT pre-checks ---------------------------------------------------
    brk_l = act & is_l & (st.c_t_off.astype(U32) < U32(MIN_SCORE_MEM))
    near_end_l = q_st_c.astype(U32) < U32(600)
    brk_l = brk_l | (act & is_l & ~brk_l & near_end_l & st.last_search)
    st = _side_complete(st, brk_r | brk_l, lanes)
    act = act & ~(brk_r | brk_l)
    new_last = st.last_search | (act & ((is_r & near_end_r)
                                       | (is_l & near_end_l)))
    st = st._replace(last_search=jnp.where(act, new_last, st.last_search))

    msr_r = jnp.where(near_end_r, l_read - q_ed_c + 60, t_length - st.c_t_off)
    msr_l = jnp.where(near_end_l, q_st_c + 60, st.c_t_off)
    # MIN(600, uint32): wrapped-huge values cap at 600
    msr = jnp.minimum(U32(600),
                      jnp.where(is_r, msr_r, msr_l).astype(U32)).astype(I32)
    # a window whose cursor wrapped below the ref start reads unowned
    # memory in the reference (u64 address arithmetic) — punt to host
    fwrap = act & ~is_mid & (st.c_t_off < 0)
    st = st._replace(fallback=st.fallback | fwrap,
                     fb_reason=st.fb_reason | jnp.where(fwrap, 2, 0))
    act = act & ~fwrap

    # ---- MID gap geometry --------------------------------------------------
    a_cap = inp.anchors.shape[1]
    mc = jnp.clip(st.mid_cur, 0, a_cap - 1)
    cur_a = inp.anchors[rows, mc]          # current c_a
    pre_i = jnp.clip(cur_a[:, 3], 0, a_cap - 1)
    pre_a = inp.anchors[rows, pre_i]
    pre_roff3 = pre_a[:, 1] - 3
    trl = cur_a[:, 1] - (pre_roff3 + pre_a[:, 2]) + 3
    mid_has_win = is_mid & (trl > 12)
    f1 = act & is_mid & (trl > 12) & (trl > W_CAP)
    st = st._replace(fallback=st.fallback | f1,
                     fb_reason=st.fb_reason | jnp.where(f1, 1, 0))
    # advance the middle cursor now; the gap's nodes are self-contained
    st = st._replace(mid_cur=jnp.where(act & is_mid, cur_a[:, 3], st.mid_cur))

    # ---- window gather -----------------------------------------------------
    t_len = jnp.where(is_mid, trl, msr)                 # probe region chars
    win_len = jnp.where(is_mid, trl, msr + OVER_SEARCH_M2)
    t0 = jnp.where(is_l, OVER_SEARCH_M2, 0)
    bug_l = is_l & (t_glob == 0) & (st.c_t_off < OVER_SEARCH_M2 + msr)
    goff = jnp.where(
        is_mid, pre_roff3 + t_glob + pre_a[:, 2],
        jnp.where(is_r, st.c_t_off + t_glob,
                  jnp.where(bug_l, st.c_t_off + t_glob - msr,
                            st.c_t_off + t_glob - msr - OVER_SEARCH_M2)))
    win = _ref_chars(ref_rows, ref_bin, n_bases, goff, W_CAP)
    # bug branch: window chars sit at [0:msr], zero-filled to msr+50
    wpos = jnp.arange(W_CAP, dtype=I32)[None, :]
    win = jnp.where(bug_l[:, None] & (wpos >= msr[:, None]), 0, win)
    win_pk = _pack2(win)
    # left normal branch: probes start at t0=50; bug branch keeps t0=50 so
    # matching is offset by +50 into the zero region (reference bug kept)
    t_st = jnp.where(is_mid, pre_roff3 + pre_a[:, 2],
                     jnp.where(is_r, st.c_t_off, st.c_t_off - msr))

    # ---- q bounds ----------------------------------------------------------
    best_q = st.sms[lanes, jnp.clip(st.max_id, 0, S_CAP - 1), 0]
    sqe_r = jnp.minimum(best_q + 1000, l_read)
    a_u = (sqe_r - 2000).astype(U32)
    b_u = (q_st_c - 8).astype(U32)
    qbg_r = jnp.maximum(a_u, b_u)
    qed_r = sqe_r.astype(U32)
    sqs_l = jnp.maximum(best_q - 1000, 0)
    qbg_l = sqs_l.astype(U32)
    qed_l = jnp.minimum((sqs_l + 2000).astype(U32), (q_st_c - 1).astype(U32))
    q_bg = jnp.where(is_mid, (pre_a[:, 0] + pre_a[:, 2] - 8).astype(U32),
                     jnp.where(is_r, qbg_r, qbg_l))
    q_ed = jnp.where(is_mid, (cur_a[:, 0] - 1).astype(U32),
                     jnp.where(is_r, qed_r, qed_l))

    # ---- probes ------------------------------------------------------------
    t_kmer_num = t_len - K9 + 1
    probe_ok = act & (t_kmer_num > 4) & ~(is_mid & (trl <= 12))
    ivals = (jnp.arange(P_CAP, dtype=I32)[None, :] + 1) * 4   # i = 4,8,...
    p_on = probe_ok[:, None] & (ivals < t_kmer_num[:, None])
    tpos = jnp.where(is_l[:, None], t_kmer_num[:, None] - 1 - ivals, ivals)
    # rolling 9-mer values over the whole window (elementwise shifts)
    wk = jnp.zeros((B, W_CAP), I32)
    w32 = win.astype(I32)
    for k in range(K9):
        wk = (wk << 2) | jnp.pad(w32[:, k:], ((0, 0), (0, k)))
    # probe values via masked max (scan) instead of a (B, P) gather
    wsel = jnp.clip(t0[:, None] + tpos, 0, W_CAP - 1)
    wcols = jnp.arange(W_CAP, dtype=I32)
    pv = jnp.max(jnp.where(wcols[None, None, :] == wsel[:, :, None],
                           wk[:, None, :], jnp.int32(-1)), axis=2)
    dslot = jnp.clip(chain_dir, 0, 1)
    rkv = rk_tables
    K_rk = rkv.shape[2]
    rkn = jnp.where(l_read >= K9, l_read - K9 + 1, 0)
    # flat leading-axis row gather
    rk_row = rkv.reshape(-1, K_rk)[rows * 2 + dslot]    # (B, K)
    qpos, cnt = _probe_hits(rk_row, rkn, pv, p_on)
    f3 = (p_on & (cnt > H_CAP)).any(axis=1)
    st = st._replace(fallback=st.fallback | f3,
                     fb_reason=st.fb_reason | jnp.where(f3, 4, 0))

    # candidates: (B, P_CAP, H_CAP) -> flat (B, P_CAP*H_CAP) in gold order
    # (probe order, then ascending read position). Compact TWICE (by
    # validity, then by the leftmost filter) before any match-run work.
    hidx = jnp.arange(H_CAP, dtype=I32)[None, None, :]
    cand_ok = p_on[:, :, None] & (hidx < jnp.minimum(cnt, H_CAP)[:, :, None])
    qpos_u = qpos.astype(U32)
    # filter 2 (src/cly.c:2251,2306): the reference compares q_bg, not
    # q_pos, to q_ed — q_ed only gates the window as a whole
    cand_ok = cand_ok & (qpos_u >= q_bg[:, None, None].astype(U32)) \
        & (q_bg.astype(U32) <= q_ed.astype(U32))[:, None, None]
    NC = P_CAP * H_CAP
    cand_ok = cand_ok.reshape(B, NC)
    qpos = qpos.reshape(B, NC)
    c_tpos = jnp.repeat(tpos, H_CAP, axis=1)
    c_i = jnp.repeat(ivals, H_CAP, axis=1)

    qbase = jnp.where(chain_dir == 1, 0, l_read)[:, None]

    # stage 1: compact valid candidates to CF_CAP slots (slot order kept)
    idxc, c_on = compact_cols(cand_ok, CF_CAP)
    f4a = jnp.sum(cand_ok, axis=1) > CF_CAP
    g1 = lambda x: jnp.take_along_axis(x, idxc, axis=1)
    c_qpos = g1(qpos)
    c_tp = g1(c_tpos)
    c_iv = g1(c_i)

    # short side check (4-char): fwd for left, back for right/mid
    sstep = jnp.where(is_l, 1, -1)[:, None]
    sq = jnp.where(is_l[:, None], qbase + c_qpos + K9, qbase + c_qpos - 1)
    sw = jnp.where(is_l[:, None], t0[:, None] + c_tp + K9,
                   t0[:, None] + c_tp - 1)
    short = _run_len2(codes_pk, inp.buf_len, rows, sq, win_pk, win_len,
                      sw, sstep, jnp.full((B, CF_CAP), 4, I32), c_on)
    lead_ok = c_on & ((short < 4) | (c_iv == 4))

    # stage 2: compact leftmost survivors to F_CAP for the long run
    idxl, f_ok = compact_cols(lead_ok, F_CAP)
    f4 = f4a | (jnp.sum(lead_ok, axis=1) > F_CAP)
    st = st._replace(fallback=st.fallback | f4,
                     fb_reason=st.fb_reason | jnp.where(f4, 8, 0))
    g2 = lambda x: jnp.take_along_axis(x, idxl, axis=1)
    f_qpos = g2(c_qpos)
    f_tpos = g2(c_tp)
    f_short = g2(short)

    ms_u = (q_ed[:, None].astype(U32) - f_qpos.astype(U32) - U32(1))
    long_cap_r = (jnp.minimum(ms_u, (t_len[:, None] - f_tpos - 1).astype(U32))
                  .astype(I32) + OVER_SEARCH_M2)
    long_cap_l = jnp.minimum(f_qpos, f_tpos) + OVER_SEARCH_M2
    long_cap = jnp.where(is_l[:, None], long_cap_l, long_cap_r)
    lstep = jnp.where(is_l, -1, 1)[:, None]
    lq = jnp.where(is_l[:, None], qbase + f_qpos - 1, qbase + f_qpos + K9)
    lw = jnp.where(is_l[:, None], t0[:, None] + f_tpos - 1,
                   t0[:, None] + f_tpos + K9)
    longr = _run_len2(codes_pk, inp.buf_len, rows, lq, win_pk, win_len,
                      lw, lstep, long_cap, f_ok)
    back = jnp.where(is_l[:, None], longr, f_short)
    fwd = jnp.where(is_l[:, None], f_short, longr)
    total = back + fwd + 1
    emit = f_ok & (total >= 4)
    # gold appends (q - back) & U32 and (tpos - back + t_st) & U32; raw
    # int32 bit patterns carry exactly those uint32 values
    node_q = f_qpos - back
    node_t = f_tpos - back + t_st[:, None]

    # append to sms in order (gold clears sms per middle gap: matches
    # start at slot 1 there, after node0)
    base_slot = jnp.where(is_mid, 1, st.n_sms)
    dest = base_slot[:, None] + jnp.cumsum(emit.astype(I32), axis=1) - 1
    n_new = jnp.sum(emit, axis=1)
    f5 = act & (base_slot + n_new + 1 > S_CAP)
    st = st._replace(fallback=st.fallback | f5,
                     fb_reason=st.fb_reason | jnp.where(f5, 16, 0))
    # scatter via a dump slot: non-emitted candidates write to slot S_CAP
    smsp = jnp.concatenate(
        [st.sms, jnp.zeros((B, 1, 4), I32)], axis=1)
    upd = emit & (dest < S_CAP)
    dest_safe = jnp.where(upd, dest, S_CAP)
    vals = jnp.stack([node_q, node_t, total, jnp.zeros_like(total)], axis=2)
    smsp = smsp.at[lanes[:, None], dest_safe].set(vals)
    sms = smsp[:, :S_CAP]

    # MID: slot0 = pre node (score=mid_score), last slot = cur node
    mid_act = act & is_mid
    node0 = jnp.stack([pre_a[:, 0], pre_a[:, 1], pre_a[:, 2] - K9 + 1,
                       st.mid_score], 1)
    sms = jnp.where(mid_act[:, None, None], sms.at[:, 0, :].set(node0), sms)
    last = jnp.clip(jnp.where(is_mid, 1 + n_new, st.n_sms + n_new), 0,
                    S_CAP - 1)
    nodeC = jnp.stack([cur_a[:, 0], cur_a[:, 1], cur_a[:, 2] - K9 + 1,
                       jnp.zeros((B,), I32)], 1)
    sms = sms.at[lanes, last].set(
        jnp.where(mid_act[:, None], nodeC, sms[lanes, last]))

    new_n = jnp.where(is_mid, 2 + n_new, st.n_sms + n_new)
    new_n = jnp.minimum(new_n, S_CAP)
    new_cur = jnp.where(is_mid, 1, st.cur_sms)
    st = st._replace(
        sms=sms,
        n_sms=jnp.where(act, new_n, st.n_sms),
        cur_sms=jnp.where(act, new_cur, st.cur_sms))

    # advance window cursor (left may wrap below 0: surrogate bias)
    ct2 = jnp.where(is_r, st.c_t_off + msr - K9 - 3, st.c_t_off - msr + K9 + 3)
    st = st._replace(c_t_off=jnp.where(act & ~is_mid, ct2, st.c_t_off))

    # side post-fetch checks
    side_act = act & ~is_mid
    no_new = side_act & (n_new == 0)
    first_new = sms[lanes, jnp.clip(st.cur_sms, 0, S_CAP - 1)]
    best_t = sms[lanes, jnp.clip(st.max_id, 0, S_CAP - 1), 1]
    far = side_act & ~no_new & jnp.where(
        is_l, (first_new[:, 1] + 1000).astype(U32) < best_t.astype(U32),
        first_new[:, 1].astype(U32) > (best_t + 1000).astype(U32))
    st = _side_complete(st, no_new | far, lanes)
    # lanes that fetched and continue clear the flag; lanes that broke got
    # their flag from _side_complete (True when entering the left side)
    cleared = act & ~(no_new | far)
    st = st._replace(need_fetch=jnp.where(cleared, False, st.need_fetch))
    return st


PROC_PER_ITER = 16
MAX_ITERS = 4096  # safety: lanes still live at the cap fall back to host


@functools.partial(jax.jit, static_argnames=("n_bases", "bf", "bp", "pp"))
def rescore_kernel(inp: RescoreIn, ref_bin, ref_off, ref_len_arr,
                   n_bases: int, bf: int | None = None,
                   bp: int | None = None, pp: int = PROC_PER_ITER):
    """Run get_score_m2 for every read lane. Returns (chains, fallback).

    bf/bp: static compact widths for the window-fetch / node-processing
    working sets (lanes beyond capacity wait an iteration). Measured
    demo occupancy: fetch 37%, micro 7-9% of B — hence the defaults."""
    B = inp.n_chains.shape[0]
    if bf is None:
        bf = max(64, B // 4)
    if bp is None:
        bp = max(64, B // 4)
    bp = min(bp, B)
    z = jnp.zeros((B,), I32)
    st = VMState(
        mode=jnp.where(inp.n_chains > 0, M_NEXT, M_DONE), chain_i=z - 1,
        chains=inp.chains, side_total=z, score_ori=z, c_t_off=z,
        last_search=jnp.zeros((B,), bool), sms=jnp.zeros((B, S_CAP, 4), I32),
        n_sms=z, cur_sms=z, max_id=z, mid_cur=z - 1, mid_score=z,
        mid_is_combine=jnp.zeros((B,), bool), save_side=z, save_nodemax=z,
        save_len=z, fallback=jnp.zeros((B,), bool), fb_reason=z,
        need_fetch=jnp.zeros((B,), bool))

    def cond(c_st):
        it, st = c_st
        return (it < MAX_ITERS) & ((st.mode != M_DONE) & ~st.fallback).any()

    rk_tables = _build_rk_tables(inp.codes_fr, inp.read_len)
    codes_pk = _pack2(inp.codes_fr)
    ref_rows = _ref_as_rows(ref_bin)

    def body(c_st):
        it, st = c_st
        # compact the node-processing working set once per iteration:
        # lanes that can work without a window (ready) run PROC_PER_ITER
        # micro-steps at width bp; the rest are untouched by micro-steps
        # (fetch-waiting lanes idle, unselected ready lanes run later)
        ready = (st.mode != M_DONE) & ~st.fallback & ~st.need_fetch
        prows_g, prows_s, pvalid = compact_rows(ready, bp)
        st_c = gather_rows(st, prows_g)
        st_c = st_c._replace(fallback=st_c.fallback | ~pvalid)
        st_c = jax.lax.fori_loop(
            0, pp, lambda _k, s: _proc_micro(s, inp, prows_g), st_c)
        st = scatter_rows(st, st_c, prows_s)
        st = _fetch_step(st, inp, rk_tables, codes_pk, ref_rows, ref_bin,
                         ref_off, ref_len_arr, n_bases, bf)
        return it + 1, st

    it, st = jax.lax.while_loop(cond, body, (jnp.int32(0), st))
    overcap = (st.mode != M_DONE) & ~st.fallback
    reason = st.fb_reason | jnp.where(overcap, 32, 0)
    return st.chains, st.fallback | overcap, reason, it
