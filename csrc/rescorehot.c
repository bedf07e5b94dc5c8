/* Native back half of the host classify engine: 9-mer SDP rescore,
 * chain combining, merge/filter, primary detection.
 *
 * Port of desamba_tpu/engine/gold/rescore.py delete_small_score_rst ->
 * detect_primary (the bit-parity oracles for src/cly.c:1691-3058).
 * Python keeps resolve_tree and hands over chain rows + per-chain
 * anchor (mtch, ref_offset, index_in_read) triples in cur->pre order;
 * this returns the final chain rows in output order.
 *
 * uint32-wrap semantics are mirrored exactly: values that the C
 * reference stores in uint32 fields live here as int64 masked with
 * 0xFFFFFFFF at the same points the python oracle masks them.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

extern int64_t sdp_match(uint64_t q_bg, uint64_t q_ed,
                         const uint8_t *qbuf, int64_t lq, int64_t qbase,
                         const uint64_t *rkvals, const int64_t *rkpos,
                         int64_t nrk,
                         const uint8_t *t_arr, int64_t lt, int64_t t0,
                         int64_t t_len, uint64_t t_st, int forward,
                         int64_t over_search, int64_t k9,
                         int64_t *out, int64_t out_cap);
extern void get_ref_bases(const uint8_t *ref_bin, int64_t n_bases,
                          int64_t offset, int64_t length, int forward,
                          uint8_t *out);

#define U32M 0xFFFFFFFFll

/* the reference's SDP node loops run in uint32 (q/t positions wrap
 * negative when a match over-reads the buffer head; derived bounds
 * wrap back SMALL so predecessors still chain) — these mirror the
 * gold oracle's _i32 / & U32 points exactly */
static inline int64_t rf_u32v(int64_t x) { return x & U32M; }
static inline int64_t rf_i32v(int64_t x) {
    x &= U32M;
    return x >= 0x80000000ll ? x - 0x100000000ll : x;
}
#define SMS_CAP 8192
#define RF_NC_CAP 512

typedef struct {
    int64_t ref_id, sum_score, anchor_number, direction, with_top;
    int64_t t_st, t_ed, q_st, q_ed, indel;
    int64_t anc_off, anc_cnt;
    int64_t primary, pri_index;
} RChain;

typedef struct {
    const uint8_t *ref_bin; int64_t n_bases;
    const int64_t *ref_off; const int64_t *ref_len;
    const uint8_t *buf; int64_t buf_len;
    int64_t read_len, forward_code, eff_max_read_l;
    int64_t filter_lv3, filter_min_length, filter_min_score;
    int64_t k9, over_search, min_score_mem, f2g, f3g_short;
    const int64_t *anc3;          /* (n,3) triples */
    /* per-direction read 9-mer tables (built lazily) */
    uint64_t *rkvals[2]; int64_t *rkpos[2]; int64_t nrk[2];
    /* sms scratch */
    int64_t sms[SMS_CAP * 4];
    int64_t n_sms;
    int overflow;
} RfCtx;

static int64_t rf_qbase(const RfCtx *c, int64_t direction) {
    return direction == c->forward_code ? 0 : c->read_len;
}

/* ReadKmerIndex: stable value-ascending sort of the strand's 9-mers
 * (== numpy stable argsort: positions ascending within a value).
 * Two-pass LSD radix (9+9 bits) — stable, so the pos-ascending input
 * order carries through; ~5x faster than qsort at read scale. */
static void rf_build_rk(RfCtx *c, int64_t direction) {
    int d = direction == c->forward_code ? 1 : 0;
    if (c->rkvals[d]) return;
    int64_t qbase = rf_qbase(c, direction);
    const uint8_t *s = c->buf + qbase;
    int64_t nk = c->read_len - c->k9 + 1;
    if (nk < 0) nk = 0;
    uint64_t *vals = (uint64_t *)malloc((size_t)(nk ? nk : 1) * 8);
    int64_t *pos = (int64_t *)malloc((size_t)(nk ? nk : 1) * 8);
    uint32_t *va = (uint32_t *)malloc((size_t)(nk ? nk : 1) * 4);
    uint32_t *pa = (uint32_t *)malloc((size_t)(nk ? nk : 1) * 4);
    uint32_t *vb = (uint32_t *)malloc((size_t)(nk ? nk : 1) * 4);
    uint32_t *pb = (uint32_t *)malloc((size_t)(nk ? nk : 1) * 4);
    uint64_t kv = 0;
    const uint64_t mask = (1ull << (2 * c->k9)) - 1;
    for (int64_t i = 0; i < c->k9 - 1 && i < c->read_len; i++)
        kv = (kv << 2) | s[i];
    int64_t hist[512];
    memset(hist, 0, sizeof(hist));
    for (int64_t i = 0; i < nk; i++) {
        kv = ((kv << 2) | s[i + c->k9 - 1]) & mask;
        va[i] = (uint32_t)kv;
        pa[i] = (uint32_t)i;
        hist[kv & 511]++;
    }
    int64_t acc = 0;
    for (int64_t b = 0; b < 512; b++) {
        int64_t t = hist[b];
        hist[b] = acc;
        acc += t;
    }
    for (int64_t i = 0; i < nk; i++) {
        int64_t at = hist[va[i] & 511]++;
        vb[at] = va[i];
        pb[at] = pa[i];
    }
    memset(hist, 0, sizeof(hist));
    for (int64_t i = 0; i < nk; i++) hist[vb[i] >> 9]++;
    acc = 0;
    for (int64_t b = 0; b < 512; b++) {
        int64_t t = hist[b];
        hist[b] = acc;
        acc += t;
    }
    for (int64_t i = 0; i < nk; i++) {
        int64_t at = hist[vb[i] >> 9]++;
        vals[at] = vb[i];
        pos[at] = pb[i];
    }
    free(va); free(pa); free(vb); free(pb);
    c->rkvals[d] = vals;
    c->rkpos[d] = pos;
    c->nrk[d] = nk;
}

static void rf_sdp_match(RfCtx *c, int64_t direction, int64_t q_bg,
                         int64_t q_ed, const uint8_t *t_arr, int64_t lt,
                         int64_t t0, int64_t t_len, int64_t t_st,
                         int forward) {
    int d = direction == c->forward_code ? 1 : 0;
    int64_t got = sdp_match((uint64_t)(q_bg & U32M),
                            (uint64_t)(q_ed & U32M),
                            c->buf, c->buf_len, rf_qbase(c, direction),
                            c->rkvals[d], c->rkpos[d], c->nrk[d],
                            t_arr, lt, t0, t_len,
                            (uint64_t)(t_st & U32M), forward,
                            c->over_search, c->k9,
                            c->sms + 4 * c->n_sms, SMS_CAP - c->n_sms);
    if (got < 0) { c->overflow = 1; return; }
    c->n_sms += got;
}

/* sdp_middle (rescore.py; src/cly.c:2444-2530) over one anchor list */
static int64_t rf_sdp_middle(RfCtx *c, const RChain *ch) {
    int64_t score = 10000;
    int64_t t_offset = c->ref_off[ch->ref_id];
    const int64_t *anc = c->anc3 + 3 * ch->anc_off;
    for (int64_t k = 0; k < ch->anc_cnt && !c->overflow; k++) {
        const int64_t *c_a = anc + 3 * k;        /* (mtch, refoff, idx) */
        if (k + 1 < ch->anc_cnt) {
            const int64_t *pre_a = anc + 3 * (k + 1);
            int64_t pre_mch = pre_a[0];
            int64_t pre_refoffset = pre_a[1] - 3;
            int64_t total_ref_len = c_a[1] - (pre_refoffset + pre_mch) + 3;
            c->n_sms = 0;
            int64_t *r0 = c->sms;
            r0[0] = pre_a[2]; r0[1] = pre_a[1];
            r0[2] = pre_a[0] - c->k9 + 1; r0[3] = score;
            c->n_sms = 1;
            if (total_ref_len > 12) {
                if (total_ref_len >= 2000) { c->overflow = 1; return 0; }
                uint8_t ref[2064];
                int64_t ref_offset = pre_refoffset + t_offset + pre_mch;
                get_ref_bases(c->ref_bin, c->n_bases, ref_offset,
                              total_ref_len, 1, ref);
                rf_sdp_match(c, ch->direction,
                             pre_a[2] + pre_mch - 8, c_a[2] - 1,
                             ref, total_ref_len, 0, total_ref_len,
                             pre_refoffset + pre_mch, 1);
                if (c->overflow) return 0;
            }
            if (c->n_sms >= SMS_CAP) { c->overflow = 1; return 0; }
            int64_t *rl = c->sms + 4 * c->n_sms;
            rl[0] = c_a[2]; rl[1] = c_a[1];
            rl[2] = c_a[0] - c->k9 + 1; rl[3] = 0;
            c->n_sms += 1;
            for (int64_t si = 1; si < c->n_sms; si++) {
                int64_t *cs = c->sms + 4 * si;
                int64_t max_score = cs[2];
                int64_t max_q = rf_u32v(cs[0] + 6);
                int64_t max_t = rf_u32v(cs[1] + 6);
                for (int64_t pi = si - 1; pi >= 0; pi--) {
                    const int64_t *pre = c->sms + 4 * pi;
                    int64_t pre_q_ed = rf_u32v(pre[0] + pre[2] + c->k9 - 1);
                    int64_t pre_t_ed = rf_u32v(pre[1] + pre[2] + c->k9 - 1);
                    if (pre_q_ed > max_q) continue;
                    if (pre_t_ed > max_t) continue;
                    int64_t indel = rf_i32v(pre[0] - pre[1] - (max_q - max_t));
                    int64_t ai = indel < 0 ? -indel : indel;
                    if (ai > 200) continue;
                    int64_t ns = pre[3] + cs[2] - (ai >> 3);
                    if (pre_q_ed > cs[0] || pre_t_ed > cs[1]) {
                        int64_t o1 = rf_i32v(pre_q_ed - cs[0]);
                        int64_t o2 = rf_i32v(pre_t_ed - cs[1]);
                        ns -= o1 > o2 ? o1 : o2;
                    }
                    if (ns > max_score) max_score = ns;
                }
                score = max_score > score ? max_score : score;
                cs[3] = max_score;
            }
        } else {
            score += c_a[0] - c->k9 + 1;
        }
    }
    return score - 10000;
}

/* combine_chain (src/cly.c:1763-1808) */
static int64_t rf_combine(RfCtx *c, RChain *chains, int64_t chain_id,
                          const int64_t *sch_ci, const int64_t *sch_se,
                          const int64_t *sch_off, int64_t dis, int isleft,
                          int64_t c_q_pos) {
    RChain *c_h = chains + chain_id;
    int64_t key = dis & 0xFF;
    for (int64_t e = sch_off[key]; e < sch_off[key + 1]; e++) {
        int64_t ci = sch_ci[e];
        RChain *ch = chains + ci;
        int64_t dis_con = rf_i32v(isleft ? ch->t_ed - ch->q_ed
                                         : ch->t_st - ch->q_st);
        int64_t q_pos_con = rf_i32v(isleft ? ch->q_ed - c->k9 : ch->q_st);
        int64_t dq = c_q_pos - q_pos_con;
        if (dq < 0) dq = -dq;
        if (dis == dis_con && ci != chain_id
                && (int64_t)(isleft ? 1 : 0) != sch_se[e]
                && dq < 8 && c_h->ref_id == ch->ref_id
                && c_h->direction == ch->direction && ch->sum_score != 0
                && ci > chain_id) {
            c_h->sum_score += ch->sum_score;
            c_h->anchor_number += ch->anchor_number;
            c_h->indel += ch->indel;
            if (ch->q_st < c_h->q_st) c_h->q_st = ch->q_st;
            if (ch->t_st < c_h->t_st) c_h->t_st = ch->t_st;
            if (ch->q_ed > c_h->q_ed) c_h->q_ed = ch->q_ed;
            if (ch->t_ed > c_h->t_ed) c_h->t_ed = ch->t_ed;
            ch->sum_score = 0;
            ch->t_st = ch->t_ed = ch->q_st = ch->q_ed = 0;
            return ci;
        }
    }
    return -1;
}

/* sdp_right (src/cly.c:2532-2677) */
static int64_t rf_sdp_right(RfCtx *c, RChain *chains, int64_t nc,
                            int64_t chain_id, const int64_t *sch_ci,
                            const int64_t *sch_se, const int64_t *sch_off,
                            int64_t score_ori) {
    (void)nc;
    RChain *c_h = chains + chain_id;
    score_ori += 10000;
    int64_t total_max_score = score_ori;
    int64_t max_sms_id = 0;
    c->n_sms = 0;
    int64_t *r0 = c->sms;
    r0[0] = c_h->q_ed; r0[1] = c_h->t_ed; r0[2] = 1 - c->k9;
    r0[3] = score_ori;
    c->n_sms = 1;
    int64_t current_sms = 1;
    int64_t t_offset_global = c->ref_off[c_h->ref_id];
    int64_t t_length = c->ref_len[c_h->ref_id];
    int64_t c_t_offset = (c_h->t_ed - 3) & U32M;
    int last_search = 0;
    uint8_t ref[704];
    for (;;) {
        if (c->n_sms == current_sms) {
            uint64_t next_step = (uint64_t)(t_length - c_t_offset);
            if (next_step < (uint64_t)c->min_score_mem) break;
            int64_t max_search_ref;
            if (c->read_len - c_h->q_ed < 600) {
                if (last_search) break;
                last_search = 1;
                max_search_ref = c->read_len - c_h->q_ed + 60;
            } else {
                max_search_ref = t_length - c_t_offset;
            }
            if (max_search_ref > 600) max_search_ref = 600;
            get_ref_bases(c->ref_bin, c->n_bases,
                          c_t_offset + t_offset_global,
                          max_search_ref + c->over_search, 1, ref);
            int64_t s_q_ed = c->sms[4 * max_sms_id] + 1000;
            if (s_q_ed > c->read_len) s_q_ed = c->read_len;
            /* MAX(int, uint32) quirk (rescore.py sdp_right) */
            int64_t a = s_q_ed - 2000;
            int64_t b = (c_h->q_st - 8) & U32M;
            int64_t s_q_st = ((uint64_t)(a & U32M) > (uint64_t)b) ? a : b;
            rf_sdp_match(c, c_h->direction, s_q_st, s_q_ed, ref,
                         max_search_ref + c->over_search, 0,
                         max_search_ref, c_t_offset, 1);
            if (c->overflow) return 0;
            c_t_offset = (c_t_offset + max_search_ref - c->k9 - 3) & U32M;
            if (c->n_sms == current_sms) break;
            if (c->sms[4 * current_sms + 1]
                    > rf_u32v(c->sms[4 * max_sms_id + 1] + 1000))
                break;
        }
        int64_t *cs = c->sms + 4 * current_sms;
        current_sms += 1;
        int64_t max_score = cs[2];
        int64_t max_pre_q = rf_u32v(cs[0] + 6);
        int64_t max_pre_t = rf_u32v(cs[1] + 6);
        for (int64_t pi = current_sms - 2; pi >= 0; pi--) {
            const int64_t *pre = c->sms + 4 * pi;
            int64_t pre_q_ed = rf_u32v(pre[0] + pre[2] + c->k9 - 1);
            int64_t pre_t_ed = rf_u32v(pre[1] + pre[2] + c->k9 - 1);
            if (pre_q_ed > max_pre_q) continue;
            if (pre_t_ed > max_pre_t) continue;
            if (rf_u32v(pre[1] + 600) < max_pre_t) break;
            int64_t indel = rf_i32v(pre[0] - pre[1]
                                    - (max_pre_q - max_pre_t));
            int64_t ai = indel < 0 ? -indel : indel;
            if (ai > 200) continue;
            int64_t ns = pre[3] + cs[2] - (ai >> 3);
            if (pre_q_ed > cs[0] || pre_t_ed > cs[1]) {
                int64_t o1 = rf_i32v(pre_q_ed - cs[0]);
                int64_t o2 = rf_i32v(pre_t_ed - cs[1]);
                ns -= o1 > o2 ? o1 : o2;
            }
            if (ns > max_score) max_score = ns;
        }
        cs[3] = max_score;
        if (cs[2] >= 8) {
            /* snapshot the row: the inner sdp_middle reuses the sms
               scratch (python's c_sms survives sms.clear() because the
               row list object stays referenced) */
            int64_t cs2 = cs[2];
            int64_t comb = rf_combine(c, chains, chain_id, sch_ci, sch_se,
                                      sch_off, rf_i32v(cs[1] - cs[0]), 0,
                                      rf_i32v(cs[0]));
            if (comb >= 0) {
                int64_t base = score_ori > max_score ? score_ori
                                                     : max_score;
                int64_t mid = rf_sdp_middle(c, chains + comb);
                if (c->overflow) return 0;
                total_max_score = base - cs2 + mid;
                score_ori = total_max_score;
                max_sms_id = 0;
                c->n_sms = 0;
                int64_t *rr = c->sms;
                rr[0] = c_h->q_ed; rr[1] = c_h->t_ed; rr[2] = -c->k9;
                rr[3] = total_max_score;
                c->n_sms = 1;
                current_sms = 1;
                c_t_offset = c_h->t_ed & U32M;
                continue;
            }
        }
        if (total_max_score < max_score) {
            total_max_score = max_score;
            max_sms_id = current_sms - 1;
        }
        if (cs[1] > rf_u32v(c->sms[4 * max_sms_id + 1] + 1000)) break;
    }
    c_h->q_ed = (c->sms[4 * max_sms_id] + c->sms[4 * max_sms_id + 2]
                 + c->k9) & U32M;
    c_h->t_ed = (c->sms[4 * max_sms_id + 1] + c->sms[4 * max_sms_id + 2]
                 + c->k9) & U32M;
    return total_max_score - 10000;
}

/* sdp_left (src/cly.c:2679-2819) */
static int64_t rf_sdp_left(RfCtx *c, RChain *chains, int64_t nc,
                           int64_t chain_id, const int64_t *sch_ci,
                           const int64_t *sch_se, const int64_t *sch_off,
                           int64_t score_ori) {
    (void)nc;
    RChain *c_h = chains + chain_id;
    score_ori += 10000;
    int64_t total_max_score = score_ori;
    int64_t max_sms_id = 0;
    c->n_sms = 0;
    int64_t *r0 = c->sms;
    r0[0] = c_h->q_st; r0[1] = c_h->t_st; r0[2] = 0; r0[3] = score_ori;
    c->n_sms = 1;
    int64_t current_sms = 1;
    int64_t t_offset_global = c->ref_off[c_h->ref_id];
    int64_t c_t_offset = (c_h->t_st + 3) & U32M;
    int last_search = 0;
    uint8_t ref[704];
    for (;;) {
        if (c->n_sms == current_sms) {
            if (c_t_offset < c->min_score_mem) break;
            int64_t max_search_ref;
            if (c_h->q_st < 600) {
                if (last_search) break;
                last_search = 1;
                max_search_ref = c_h->q_st + 60;
            } else {
                max_search_ref = c_t_offset;
            }
            if (max_search_ref > 600) max_search_ref = 600;
            if (t_offset_global == 0
                    && c_t_offset < c->over_search + max_search_ref) {
                /* reference's own "//bug" branch (src/cly.c:2724) */
                memset(ref, 0, (size_t)(max_search_ref + c->over_search));
                get_ref_bases(c->ref_bin, c->n_bases,
                              c_t_offset + t_offset_global - max_search_ref,
                              max_search_ref, 1, ref);
            } else {
                get_ref_bases(c->ref_bin, c->n_bases,
                              c_t_offset + t_offset_global - max_search_ref
                              - c->over_search,
                              max_search_ref + c->over_search, 1, ref);
            }
            int64_t s_q_st = c->sms[4 * max_sms_id] - 1000;
            if (s_q_st < 0) s_q_st = 0;
            int64_t s_q_ed = s_q_st + 2000;
            int64_t lim = (c_h->q_st - 1) & U32M;
            if (s_q_ed > lim) s_q_ed = lim;
            rf_sdp_match(c, c_h->direction, s_q_st, s_q_ed, ref,
                         max_search_ref + c->over_search, c->over_search,
                         max_search_ref,
                         (c_t_offset - max_search_ref) & U32M, 0);
            if (c->overflow) return 0;
            c_t_offset = (c_t_offset - max_search_ref + c->k9 + 3) & U32M;
            if (c->n_sms == current_sms) break;
            if (rf_u32v(c->sms[4 * current_sms + 1] + 1000)
                    < c->sms[4 * max_sms_id + 1])
                break;
        }
        int64_t *cs = c->sms + 4 * current_sms;
        current_sms += 1;
        int64_t max_score = cs[2];
        int64_t min_pre_q = rf_u32v(cs[0] + cs[2] - 6 + c->k9 - 1);
        int64_t min_pre_t = rf_u32v(cs[1] + cs[2] - 6 + c->k9 - 1);
        for (int64_t pi = current_sms - 2; pi >= 0; pi--) {
            const int64_t *pre = c->sms + 4 * pi;
            if (pre[0] < min_pre_q) continue;
            if (pre[1] < min_pre_t) continue;
            if (rf_u32v(min_pre_t + 600) < pre[1]) break;
            int64_t indel = rf_i32v(pre[0] - pre[1]
                                    - (min_pre_q - min_pre_t));
            int64_t ai = indel < 0 ? -indel : indel;
            if (ai > 200) continue;
            int64_t ns = pre[3] + cs[2] - (ai >> 3);
            if (rf_u32v(min_pre_q + 6) > pre[0]
                    || rf_u32v(min_pre_t + 6) > pre[1]) {
                int64_t o1 = rf_i32v(min_pre_q + 6 - pre[0]);
                int64_t o2 = rf_i32v(min_pre_t + 6 - pre[1]);
                ns -= o1 > o2 ? o1 : o2;
            }
            if (ns > max_score) max_score = ns;
        }
        cs[3] = max_score;
        if (cs[2] >= 8) {
            int64_t cs2 = cs[2];
            int64_t comb = rf_combine(c, chains, chain_id, sch_ci, sch_se,
                                      sch_off, rf_i32v(cs[1] - cs[0]), 1,
                                      rf_i32v(cs[0] + cs[2]));
            if (comb >= 0) {
                int64_t base = score_ori > max_score ? score_ori
                                                     : max_score;
                int64_t mid = rf_sdp_middle(c, chains + comb);
                if (c->overflow) return 0;
                total_max_score = base - cs2 + mid;
                score_ori = total_max_score;
                max_sms_id = 0;
                c->n_sms = 0;
                int64_t *rr = c->sms;
                rr[0] = c_h->q_st; rr[1] = c_h->t_st; rr[2] = 0;
                rr[3] = total_max_score;
                c->n_sms = 1;
                current_sms = 1;
                c_t_offset = c_h->t_st & U32M;
                continue;
            }
        }
        if (total_max_score < max_score) {
            total_max_score = max_score;
            max_sms_id = current_sms - 1;
        }
        if (rf_u32v(cs[1] + 1000) < c->sms[4 * max_sms_id + 1]) break;
    }
    c_h->q_st = c->sms[4 * max_sms_id] & U32M;
    c_h->t_st = c->sms[4 * max_sms_id + 1] & U32M;
    return total_max_score - 10000;
}

/* rescore_finish: truncate -> sc_hash -> get_score_m2 ->
 * post_rescore_finish -> detect_primary.
 * chains_io: (nc, 14) int64 rows [ref_id, sum_score, anchor_number,
 * direction, with_top, t_st, t_ed, q_st, q_ed, indel, anc_off, anc_cnt,
 * primary, pri_index]; rewritten in final order. Returns the final
 * chain count, or -1 when the caller must fall back (sms overflow /
 * middle gap >= 2000 / cap). params: see RfCtx loading below. */
int64_t rescore_finish(const int64_t *params, int64_t *chains_io,
                       int64_t nc, const int64_t *anc3) {
    if (nc <= 0) return 0;
    if (nc > RF_NC_CAP) return -1;
    RfCtx C;
    memset(&C, 0, sizeof(C));
    C.ref_bin = (const uint8_t *)params[0];
    C.n_bases = params[1];
    C.ref_off = (const int64_t *)params[2];
    C.ref_len = (const int64_t *)params[3];
    C.buf = (const uint8_t *)params[4];
    C.buf_len = params[5];
    C.read_len = params[6];
    C.forward_code = params[7];
    C.eff_max_read_l = params[8];
    C.filter_lv3 = params[9];
    C.filter_min_length = params[10];
    C.filter_min_score = params[11];
    C.k9 = params[12];
    C.over_search = params[13];
    C.min_score_mem = params[14];
    C.f2g = params[15];
    C.f3g_short = params[16];
    C.anc3 = anc3;

    RChain ch[RF_NC_CAP];
    for (int64_t i = 0; i < nc; i++) {
        int64_t *r = chains_io + 14 * i;
        ch[i] = (RChain){r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7],
                         r[8], r[9], r[10], r[11], 0, 0};
    }
    /* mode 1 (params[17]): post_rescore_finish + detect_primary only —
       the device engine computes sum_score on the device and needs just
       the merge/filter/primary host finish */
    int post_only = params[17] == 1;
    if (post_only) goto post;
    /* truncate_chains (src/cly.c:2891-2897) */
    if (nc > 200) {
        int64_t rst = 200;
        while (rst < nc && ch[rst].sum_score > 50) rst++;
        nc = rst;
    }
    if (nc > 400) nc = 400;
    /* sc_hash (src/cly.c:1691-1710): per-key (ci, s_or_e) insertion
       order; s_or_e 1 = start key, 0 = end key */
    int64_t sch_ci[2 * RF_NC_CAP], sch_se[2 * RF_NC_CAP];
    int64_t sch_off[257];
    {
        int64_t cnt[256];
        memset(cnt, 0, sizeof(cnt));
        for (int64_t i = 0; i < nc; i++) {
            cnt[(ch[i].t_st - ch[i].q_st) & 0xFF]++;
            cnt[(ch[i].t_ed - ch[i].q_ed) & 0xFF]++;
        }
        sch_off[0] = 0;
        for (int64_t k = 0; k < 256; k++)
            sch_off[k + 1] = sch_off[k] + cnt[k];
        int64_t fill[256];
        memcpy(fill, sch_off, sizeof(fill));
        for (int64_t i = 0; i < nc; i++) {
            int64_t k1 = (ch[i].t_st - ch[i].q_st) & 0xFF;
            int64_t at = fill[k1]++;
            sch_ci[at] = i; sch_se[at] = 1;
            int64_t k0 = (ch[i].t_ed - ch[i].q_ed) & 0xFF;
            at = fill[k0]++;
            sch_ci[at] = i; sch_se[at] = 0;
        }
    }
    /* get_score_m2 (src/cly.c:2821-2849) */
    for (int64_t i = 0; i < nc; i++) {
        if (ch[i].sum_score == 0) continue;
        rf_build_rk(&C, ch[i].direction);
        int64_t score = rf_sdp_middle(&C, &ch[i]);
        if (C.overflow) goto fail;
        score = rf_sdp_right(&C, ch, nc, i, sch_ci, sch_se, sch_off,
                             score);
        if (C.overflow) goto fail;
        score = rf_sdp_left(&C, ch, nc, i, sch_ci, sch_se, sch_off,
                            score);
        if (C.overflow) goto fail;
        ch[i].sum_score = score;
    }
post:
    /* post_rescore_finish: stable position sort (ref asc, t_st asc,
       score desc) — insertion sort keeps ties stable */
    for (int64_t i = 1; i < nc; i++) {
        RChain key = ch[i];
        int64_t p = i - 1;
        while (p >= 0 && (ch[p].ref_id > key.ref_id
                || (ch[p].ref_id == key.ref_id
                    && (ch[p].t_st > key.t_st
                        || (ch[p].t_st == key.t_st
                            && ch[p].sum_score < key.sum_score))))) {
            ch[p + 1] = ch[p];
            p--;
        }
        ch[p + 1] = key;
    }
    for (int64_t ci = 0; ci + 1 < nc; ci++) {
        RChain *cc = &ch[ci];
        if (cc->sum_score == 0) continue;
        for (int64_t ni = ci + 1; ni < nc; ni++) {
            RChain *nx = &ch[ni];
            if (cc->ref_id == nx->ref_id) {
                if (cc->direction != nx->direction) continue;
                if (nx->sum_score == 0) continue;
                if (nx->t_st < rf_u32v(cc->t_st + 5)
                        && nx->q_st < rf_u32v(cc->q_st + 5)
                        && nx->sum_score < cc->sum_score + 5) {
                    nx->sum_score = 0;
                    nx->q_ed = nx->q_st;
                    nx->t_ed = nx->t_st;
                    continue;
                }
                int64_t dis_t = rf_i32v(nx->t_st - cc->t_ed);
                int64_t dis_q = rf_i32v(nx->q_st - cc->q_ed);
                int64_t dd = dis_t - dis_q;
                if (dd < 0) dd = -dd;
                if (-20 < dis_t && dis_t < 1000 && -20 < dis_q
                        && dis_q < 1000 && dd < 200) {
                    if (nx->t_ed > cc->t_ed) cc->t_ed = nx->t_ed;
                    if (nx->q_ed > cc->q_ed) cc->q_ed = nx->q_ed;
                    cc->sum_score += nx->sum_score;
                    nx->sum_score = 0;
                    nx->q_ed = nx->q_st;
                    nx->t_ed = nx->t_st;
                }
            } else {
                break;
            }
        }
    }
    /* adaptive filters (src/cly.c:2874-2986) */
    if (C.eff_max_read_l < 510) {
        for (int64_t i = 0; i < nc; i++)
            if (ch[i].sum_score + (rf_u32v(ch[i].q_ed - ch[i].q_st) >> 5) < C.f2g)
                ch[i].sum_score = 0;
    } else if (C.read_len < 310) {
        for (int64_t i = 0; i < nc; i++)
            if (ch[i].sum_score + (rf_u32v(ch[i].q_ed - ch[i].q_st) >> 5)
                    < C.f3g_short)
                ch[i].sum_score = 0;
    } else {
        for (int64_t i = 0; i < nc; i++) {
            int64_t sc = ch[i].sum_score
                         + (rf_u32v(ch[i].q_ed - ch[i].q_st) >> 5);
            if (sc < C.filter_lv3
                    && (rf_u32v(ch[i].q_ed - ch[i].q_st) < C.filter_min_length
                        || sc < C.filter_min_score))
                ch[i].sum_score = 0;
        }
    }
    /* chain_cmp_by_MEM_score: desc, odd-score tie groups reversed
       (the glibc msort %2 hack, src/cly.c:63). Stable insertion sort
       descending, then reverse odd tie groups. */
    {
        int64_t ord[RF_NC_CAP];
        for (int64_t i = 0; i < nc; i++) ord[i] = i;
        for (int64_t i = 1; i < nc; i++) {
            int64_t key = ord[i];
            int64_t ks = ch[key].sum_score;
            int64_t p = i - 1;
            while (p >= 0 && ch[ord[p]].sum_score < ks) {
                ord[p + 1] = ord[p];
                p--;
            }
            ord[p + 1] = key;
        }
        RChain tmp[RF_NC_CAP];
        int64_t i = 0;
        int64_t w = 0;
        while (i < nc) {
            int64_t j = i;
            int64_t s = ch[ord[i]].sum_score;
            while (j < nc && ch[ord[j]].sum_score == s) j++;
            if (s % 2 == 1 || s % 2 == -1) {
                for (int64_t k = j - 1; k >= i; k--) tmp[w++] = ch[ord[k]];
            } else {
                for (int64_t k = i; k < j; k++) tmp[w++] = ch[ord[k]];
            }
            i = j;
        }
        memcpy(ch, tmp, (size_t)nc * sizeof(RChain));
    }
    for (int64_t i = 0; i < nc; i++) {
        if (ch[i].sum_score == 0) { nc = i; break; }
    }
    /* detect_primary (src/cly.c:2995-3058) */
    if (nc > 0) {
        int64_t primary_v[800], primary_v_idx[800];
        int64_t n_primary_v = 1;
        primary_v[0] = 0;
        primary_v_idx[0] = 0;
        ch[0].pri_index = 0;
        ch[0].primary = 1;
        for (int64_t i = 0; i < nc; i++)
            if (ch[i].q_st > 4294960000ll) ch[i].q_st = 0;
        for (int64_t hi = 1; hi < nc; hi++) {
            RChain *c_hit = &ch[hi];
            int overlap = 0;
            for (int64_t i = 0; i < n_primary_v; i++) {
                RChain *p = &ch[primary_v[i]];
                int64_t pst, ped;
                if (p->direction == c_hit->direction) {
                    pst = p->q_st; ped = p->q_ed;
                } else {
                    pst = C.read_len - p->q_ed;
                    ped = C.read_len - p->q_st;
                }
                int64_t ost = c_hit->q_st > pst ? c_hit->q_st : pst;
                int64_t oed = c_hit->q_ed < ped ? c_hit->q_ed : ped;
                if (ost < oed
                        && ((oed - ost) << 1) >= (c_hit->q_ed - c_hit->q_st))
                    overlap = 1;
                if (overlap) {
                    c_hit->primary = 2;
                    primary_v_idx[i] += 1;
                    c_hit->pri_index = primary_v_idx[i];
                    int64_t mg = p->sum_score >> 6;
                    if (mg < 5) mg = 5;
                    if (c_hit->sum_score + mg > p->sum_score)
                        c_hit->pri_index = 1;
                    if (primary_v_idx[i] == 255) primary_v_idx[i] = 254;
                    break;
                }
            }
            if (!overlap) {
                c_hit->primary = 3;
                c_hit->pri_index = 0;
                primary_v_idx[n_primary_v] = 0;
                primary_v[n_primary_v] = hi;
                n_primary_v += 1;
                if (n_primary_v > 750) n_primary_v = 750;
            }
        }
    }
    for (int64_t i = 0; i < nc; i++) {
        int64_t *r = chains_io + 14 * i;
        r[0] = ch[i].ref_id; r[1] = ch[i].sum_score;
        r[2] = ch[i].anchor_number; r[3] = ch[i].direction;
        r[4] = ch[i].with_top; r[5] = ch[i].t_st; r[6] = ch[i].t_ed;
        r[7] = ch[i].q_st; r[8] = ch[i].q_ed; r[9] = ch[i].indel;
        r[10] = ch[i].anc_off; r[11] = ch[i].anc_cnt;
        r[12] = ch[i].primary; r[13] = ch[i].pri_index;
    }
    for (int d = 0; d < 2; d++) {
        free(C.rkvals[d]);
        free(C.rkpos[d]);
    }
    return nc;
fail:
    for (int d = 0; d < 2; d++) {
        free(C.rkvals[d]);
        free(C.rkpos[d]);
    }
    return -1;
}
