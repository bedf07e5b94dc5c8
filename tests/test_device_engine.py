"""Device kernel parity vs the gold engine, on the CPU backend (the GPU
run of the same path is chip_smoke.py)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from desamba_tpu.constants import (  # noqa: E402
    FORWARD,
    MEM_SEARCH_FAST,
    MIN_MEM_LEN_FAST,
    PRE_IDX_MASK,
    REVERSE,
    SP_SET_CAP,
)


def test_u64_hash_matches_numpy():
    from desamba_tpu.engine.device import u64ops as u
    from desamba_tpu.index.kmers import hash64_1, hash64_2

    k = np.array([0, 1, 12345, (1 << 62) + 3, 0xDEADBEEFCAFEBABE,
                  (1 << 40) - 1], dtype=np.uint64)
    hi, lo = u.from_u64_np(k)
    for dev_fn, np_fn in ((u.hash64_1, hash64_1), (u.hash64_2, hash64_2)):
        dh = dev_fn((jnp.asarray(hi), jnp.asarray(lo)))
        got = u.to_u64_np(np.asarray(dh[0]), np.asarray(dh[1]))
        assert np.array_equal(got, np_fn(k))


@pytest.fixture(scope="module")
def device_setup(small_my_index):
    from desamba_tpu.engine.device.arrays import DeviceIndex
    from desamba_tpu.engine.gold.fm import FM

    return small_my_index, DeviceIndex.build(small_my_index), FM(small_my_index)


def _random_reads(idx, n, rng):
    """Reads sampled from the reference with noise (so probes hit)."""
    from desamba_tpu.engine.gold.mapseed import get_ref

    reads = []
    total = int(idx.ref_off[-1] + idx.ref_len[-1])
    for _ in range(n):
        ln = int(rng.integers(200, 1200))
        st = int(rng.integers(0, total - ln))
        seq = get_ref(idx.ref_bin, st, ln, True).copy()
        nerr = int(ln * 0.1)
        pos = rng.integers(0, ln, size=nerr)
        seq[pos] = (seq[pos] + rng.integers(1, 4, size=nerr)) % 4
        reads.append(seq.astype(np.uint8))
    return reads


def test_bloom_and_islands_parity(device_setup):
    from desamba_tpu.engine.device.islands import bloom_hit_kernel, segment_islands
    from desamba_tpu.engine.gold.islands import (
        exist_mask,
        search_islands,
        store_kmers_mask,
    )

    idx, dix, _ = device_setup
    rng = np.random.default_rng(3)
    reads = _random_reads(idx, 16, rng)
    L = max(len(r) for r in reads)
    codes = np.zeros((len(reads), L), dtype=np.uint8)
    lens = np.array([len(r) for r in reads], dtype=np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = r
    hit = np.asarray(bloom_hit_kernel(
        jnp.asarray(codes), jnp.asarray(lens), dix.ekmer0, dix.ekmer1,
        idx.len_e_kmer, idx.single_base_max, dix.mask_bits))
    for i, r in enumerate(reads):
        n_k = len(r) - idx.len_e_kmer + 1
        km = store_kmers_mask(r, n_k, idx.len_e_kmer, idx.single_base_max)
        gold_hit = exist_mask(km, idx.ekmer0, idx.ekmer1, idx.e_hash_mask)
        assert np.array_equal(hit[i, :n_k], gold_hit)
        for d in (FORWARD, REVERSE):
            gold_seeds = search_islands(gold_hit, d)
            dev_seeds = segment_islands(hit[i], n_k, d)
            assert [s[:2] for s in dev_seeds] == [s[:2] for s in gold_seeds]


def test_lv_batch_parity():
    import jax
    import jax.numpy as jnp

    from desamba_tpu.engine.device.lv import lv_batch
    from desamba_tpu.engine.gold.mapseed import lv_extd

    rng = np.random.default_rng(0)
    N = 800
    lens = rng.integers(0, 13, size=N)
    ref = rng.integers(0, 4, size=(N, 13)).astype(np.uint8)
    qry = np.where(rng.random((N, 13)) < 0.7, ref,
                   rng.integers(0, 4, size=(N, 13))).astype(np.uint8)
    qry[rng.random((N, 13)) < 0.05] = 200  # out-of-buffer GARBAGE bytes
    ref[rng.random((N, 13)) < 0.02] = 200
    got = np.asarray(jax.jit(lv_batch)(
        jnp.asarray(ref), jnp.asarray(qry), jnp.asarray(lens.astype(np.int32))))
    for i in range(N):
        assert got[i] == lv_extd(ref[i], int(lens[i]), qry[i], int(lens[i])), i


def test_map_seed_lanes_parity(device_setup):
    """Replay every gold map_seed call from classifying noisy reads."""
    import jax
    import jax.numpy as jnp

    import desamba_tpu.engine.gold.fastslow as FS
    import desamba_tpu.engine.gold.mapseed as MS
    from desamba_tpu.engine.device.arrays import DeviceIndex
    from desamba_tpu.engine.device.mapseed import A_NF, map_seed_lanes
    from desamba_tpu.engine.gold.classify import ClassifyEngine
    from desamba_tpu.engine.gold.fm import MAX_U64

    idx, dix, _ = device_setup
    eng = ClassifyEngine(idx)
    rng = np.random.default_rng(9)
    reads = _random_reads(idx, 12, rng)
    calls, bufs = [], []
    orig = MS.map_seed
    rid = [0]

    def wrap(idx_, fm, loc, q_mem, q_lv, m_r, buf, base, read_len, seed_id,
             direction, anchors, smc):
        n0 = len(anchors)
        r = orig(idx_, fm, loc, q_mem, q_lv, m_r, buf, base, read_len,
                 seed_id, direction, anchors, smc)
        calls.append(dict(
            rid=rid[0], sp=m_r.sp, ml=m_r.match_len, sa=m_r.sa_sp,
            sal=m_r.sa_sp_l, qoff=m_r.read_offset, base=base, rl=read_len,
            sid=seed_id, dir=direction, ret=r,
            anchors=[(a.mtch_len, a.score, a.left_len, a.left_ed, a.rigt_len,
                      a.rigt_ed, a.direction, a.global_offset, a.ref_id,
                      a.ref_offset, a.index_in_read, a.seed_id)
                     for a in anchors[n0:]]))
        return r

    MS.map_seed = wrap
    FS.map_seed = wrap
    # force the instrumentable python oracle end to end (the native
    # row path bypasses fastslow.map_seed entirely)
    import desamba_tpu.io.native as _nv
    _real_avail = _nv.available
    _nv.available = lambda: False
    try:
        for r in reads:
            seq = "".join("ACGT"[c] for c in r)
            eng.classify_read("x", seq, None)
            bf = r.copy()
            bufs.append(np.concatenate([bf, (3 - bf)[::-1]]))
            rid[0] += 1
    finally:
        MS.map_seed = orig
        FS.map_seed = orig
        _nv.available = _real_avail
    assert calls, "no map_seed calls recorded"

    N = len(calls)
    Lmax = max(len(b) for b in bufs)
    codes_fr = np.zeros((len(bufs), Lmax), np.uint8)
    buf_len = np.zeros(len(bufs), np.int32)
    for i, b in enumerate(bufs):
        codes_fr[i, : len(b)] = b
        buf_len[i] = len(b)
    ixr = dix.index_refs()

    def arr(k):
        return jnp.asarray(np.array([c[k] for c in calls], dtype=np.int32))

    A_CAP = 64
    sa_ok = np.array([c["sa"] != MAX_U64 for c in calls])
    sa_row = np.array([c["sa"] & 0xFFFFFFFF if c["sa"] != MAX_U64 else 0
                       for c in calls], dtype=np.int64)
    from desamba_tpu.engine.device.textwalk import pack2
    fn = jax.jit(map_seed_lanes, static_argnames=("a_cap", "occ_cap"))
    out = fn(ixr, pack2(jnp.asarray(codes_fr)), jnp.asarray(buf_len), dix.q_mem,
             dix.q_lv, arr("rid"), arr("base"), arr("rl"), arr("dir"),
             arr("sid"), arr("sp"), arr("ml"), jnp.asarray(sa_ok),
             jnp.asarray(sa_row.astype(np.int32)), arr("sal"), arr("qoff"),
             jnp.ones((N,), bool), jnp.zeros((N, A_CAP, A_NF), jnp.int32),
             jnp.zeros((N,), jnp.int32), a_cap=A_CAP)
    anchors_h, acnt_h, maxs_h = [np.asarray(x) for x in out]
    for i, c in enumerate(calls):
        got = [tuple(int(x) for x in anchors_h[i, k])
               for k in range(min(int(acnt_h[i]), A_CAP))]
        assert got == c["anchors"], f"call {i}"
        assert int(maxs_h[i]) == c["ret"], f"call {i} ret"


def test_device_classifier_end_to_end(device_setup):
    """Full device pipeline (ladders + rescore) == gold on noisy reads."""
    from desamba_tpu.engine.device.classifier import DeviceClassifier
    from desamba_tpu.engine.gold.classify import ClassifyEngine, Options
    from desamba_tpu.io.sam import format_result

    idx, _dix, _ = device_setup
    rng = np.random.default_rng(21)
    reads = _random_reads(idx, 10, rng)

    class Rec:
        def __init__(self, i, seq):
            self.name = f"r{i}"
            self.seq = "".join("ACGT"[c] for c in seq)
            self.qual = None

    recs = [Rec(i, r) for i, r in enumerate(reads)]
    opts = Options()
    gold = ClassifyEngine(idx, Options())
    exp = [format_result(gold.classify_read(r.name, r.seq, r.qual),
                         idx.ref_name, opts) for r in recs]
    dev = DeviceClassifier(idx, Options())
    got = [format_result(res, idx.ref_name, opts)
           for res in dev.classify_reads(recs)]
    assert got == exp


def test_ladder_iv_hot_tier_overflow_redispatch(demo_my_index, demo_files):
    """iv_cap=1 forces SP_SET hot-tier overflow on every multi-walk
    lane; the classifier must re-dispatch those groups at full IV_CAP
    and stay bit-equal (ladder.IV_HOT safety net). Demo reads: the
    small synthetic genome has no repeats, so no lane ever inserts two
    walks there."""
    from desamba_tpu.engine.device.classifier import DeviceClassifier
    from desamba_tpu.engine.gold.classify import Options
    from desamba_tpu.io.fastx import read_fastx
    from desamba_tpu.io.sam import format_result

    idx = demo_my_index
    recs = list(read_fastx(demo_files[1]))[:120]
    opts = Options()
    ref_eng = DeviceClassifier(idx, Options())
    exp = [format_result(r, idx.ref_name, opts)
           for r in ref_eng.classify_reads(recs)]

    orig = DeviceClassifier._dispatch_ladder_group
    n_redo = [0]

    def tiny_cap(self, kind, ls, g, codes_fr, buf_len, pre13, iv_cap=1):
        if iv_cap is None:
            n_redo[0] += 1
        return orig(self, kind, ls, g, codes_fr, buf_len, pre13,
                    iv_cap=iv_cap)

    DeviceClassifier._dispatch_ladder_group = tiny_cap
    try:
        eng = DeviceClassifier(idx, Options())
        got = [format_result(r, idx.ref_name, opts)
               for r in eng.classify_reads(recs)]
    finally:
        DeviceClassifier._dispatch_ladder_group = orig
    assert n_redo[0] > 0, "hot cap 1 should have overflowed"
    assert got == exp


def test_mem_probe_parity(device_setup):
    """Batched MEM probes == gold bwt_mem_search incl. SP_SET dedup
    (default path: position-space interval resolution)."""
    _mem_probe_parity(device_setup, None)


def test_mem_probe_parity_rank_chase(device_setup):
    """sa_cap=0 forces every lane onto the rank-chase fallback — the
    path large-index 13-mer buckets take (fm._interval_rank_chase)."""
    _mem_probe_parity(device_setup, 0)


def test_mem_probe_parity_mixed_cap(device_setup):
    """sa_cap=2 routes lanes with tiny intervals through the SA path
    and the rest through the chase, in the same batch."""
    _mem_probe_parity(device_setup, 2)


def _mem_probe_parity(device_setup, sa_cap):
    from desamba_tpu.engine.device.fm import mem_probe
    from desamba_tpu.engine.gold.fm import MAX_U64, SpSet, bwt_mem_search
    from desamba_tpu.engine.gold.islands import (
        exist_mask,
        search_islands,
        store_kmers_mask,
    )

    idx, dix, fm = device_setup
    rng = np.random.default_rng(5)
    reads = _random_reads(idx, 5, rng)
    l_ek = idx.len_e_kmer
    lanes = []  # (codes_row, kmer values, seed)
    for r in reads:
        n_k = len(r) - l_ek + 1
        km = store_kmers_mask(r, n_k, l_ek, idx.single_base_max)
        gold_hit = exist_mask(km, idx.ekmer0, idx.ekmer1, idx.e_hash_mask)
        for s in search_islands(gold_hit, FORWARD):
            lanes.append((r, km, s))
    assert lanes, "fixture produced no islands"
    N = len(lanes)
    L = max(len(r) for r, _, _ in lanes)
    codes = np.zeros((N, L), dtype=np.uint8)
    for i, (r, _, _) in enumerate(lanes):
        codes[i, : len(r)] = r
    codes_d = jnp.asarray(codes)
    from desamba_tpu.engine.device.textwalk import pack2
    codes_pk = pack2(codes_d)
    ixr = dix.index_refs()
    isa_h = np.asarray(dix.isa)
    min_index = MIN_MEM_LEN_FAST - l_ek
    j_state = np.array([s[1] - 1 for _, _, s in lanes])
    gold_sets = [SpSet() for _ in range(N)]
    from desamba_tpu.engine.device.fm import spset_init
    spset, spcount = spset_init(N)
    nprobes = 0
    rounds = 0
    while rounds < 6:
        rounds += 1
        act_i = np.flatnonzero(j_state >= min_index)
        if len(act_i) == 0:
            break
        str_idx = np.zeros(N, dtype=np.int32)
        pre_v = np.zeros(N, dtype=np.int32)
        act = np.zeros(N, dtype=bool)
        for i in act_i:
            _, km, s = lanes[i]
            ki = s[0] + j_state[i]
            pre_v[i] = int(km[ki]) & PRE_IDX_MASK
            str_idx[i] = ki + l_ek - 1
            act[i] = True
        kw = {} if sa_cap is None else {"sa_cap": sa_cap}
        out = mem_probe(ixr, dix.fm_blocks, dix.rank,
                        dix.hash13, codes_d, codes_pk, jnp.asarray(str_idx),
                        jnp.asarray(pre_v), jnp.asarray(act), spset, spcount,
                        MEM_SEARCH_FAST, MIN_MEM_LEN_FAST - 1, **kw)
        (res_len, res_sp, res_sa, res_sa_ok, res_sa_l, res_valid,
         spset, spcount) = out
        host = [np.asarray(x) for x in
                (res_len, res_sp, res_sa, res_sa_ok, res_sa_l, res_valid)]
        spset_h = np.asarray(spset)
        spcount_h = np.asarray(spcount)
        for i in act_i:
            nprobes += 1
            m_r = []
            bwt_mem_search(fm, lanes[i][0], int(str_idx[i]), int(pre_v[i]),
                           MEM_SEARCH_FAST, MIN_MEM_LEN_FAST - 1,
                           int(str_idx[i]), gold_sets[i], m_r)
            got = [(int(host[0][i, k]), int(host[1][i, k]),
                    int(host[2][i, k]) if host[3][i, k] else MAX_U64,
                    int(host[4][i, k]))
                   for k in range(MEM_SEARCH_FAST) if host[5][i, k]]
            exp = [(r.match_len, r.sp, r.sa_sp, r.sa_sp_l) for r in m_r]
            assert got == exp, f"lane {i} j {j_state[i]}"
            gold_rows = {x & 0xFFFFFFFF for x in gold_sets[i].contents()}
            # device set = disjoint position intervals; expand + map to
            # rows via the inverse SA
            dev_rows = set()
            for s_lo, s_hi in spset_h[i][: int(spcount_h[i, 0])]:
                dev_rows.update(
                    int(r) for r in isa_h[int(s_lo) : int(s_hi) + 1])
            assert gold_rows == dev_rows, f"spset lane {i}"
            j_state[i] -= 2 if not m_r else 3
    assert nprobes > 30


def test_run_len2_below_buffer_parity():
    """Fuzz the rescore VM's packed LCE (_run_len2) against the gold
    _mem_q oracle, INCLUDING backward runs whose start q is already
    below the read buffer (q < 0 compares as char 0 — the reference
    walks into glibc chunk-header zeros, src/cly.c MEM_search).

    Regression: _word16's zero-fill shift was clamped at 15 chars, so a
    chunk whose base was <= -16 (first compared char at q = -1) read
    codes[0] instead of 0 and the run died at the buffer edge — one
    read in the multihost corpus lost a 2-char head extension (POS
    11632 vs 11630, AS 278 vs 280)."""
    from desamba_tpu.engine.device import rescore as dr
    from desamba_tpu.engine.gold.rescore import _mem_q

    rng = np.random.default_rng(99)
    B, F, L, W = 8, 16, 200, 256
    codes = rng.integers(0, 4, (B, 2 * L)).astype(np.uint8)
    win = rng.integers(0, 4, (B, W)).astype(np.uint8)
    # plant zero runs at window starts and read heads so below-buffer
    # matches actually extend
    win[:, :24] = 0
    codes[:, :6] = 0
    codes_pk = np.asarray(dr._pack2(jnp.asarray(codes)))
    win_pk = np.asarray(dr._pack2(jnp.asarray(win)))
    buf_len = np.full((B,), 2 * L, np.int32)
    for step in (1, -1):
        # forward runs never start below the buffer (gold _mem_q leaves
        # that undefined); backward runs may (the regression case)
        qlo = 0 if step > 0 else -20
        qstart = rng.integers(qlo, 2 * L, (B, F)).astype(np.int32)
        wstart = rng.integers(0, W, (B, F)).astype(np.int32)
        cap = rng.integers(0, 64, (B, F)).astype(np.int32)
        got = np.asarray(dr._run_len2(
            jnp.asarray(codes_pk), jnp.asarray(buf_len),
            jnp.arange(B, dtype=jnp.int32), jnp.asarray(qstart),
            jnp.asarray(win_pk), jnp.full((B,), W, jnp.int32),
            jnp.asarray(wstart), jnp.full((B, 1), step, jnp.int32),
            jnp.asarray(cap), jnp.ones((B, F), bool)))
        for b in range(B):
            for f in range(F):
                exp = _mem_q(codes[b], int(qstart[b, f]), win[b],
                             int(wstart[b, f]), step > 0, int(cap[b, f]))
                assert got[b, f] == exp, (step, b, f, qstart[b, f],
                                          wstart[b, f], cap[b, f])


def test_rescore_kernel_parity(device_setup):
    """Device rescore == gold get_score_m2 on noisy reads (chains built by
    the gold pipeline; kernel rescored on device; exact field compare)."""
    import copy

    import jax
    import jax.numpy as jnp

    from desamba_tpu.engine.device import rescore as dr
    from desamba_tpu.engine.gold.chain import resolve_tree
    from desamba_tpu.engine.gold.classify import ClassifyEngine
    from desamba_tpu.engine.gold.fastslow import fast_classify, slow_classify
    from desamba_tpu.engine.gold.islands import get_islands
    from desamba_tpu.engine.gold.rescore import (
        get_score_m2,
        sc_hash_idx,
        truncate_chains,
    )
    from desamba_tpu.engine.device.arrays import DeviceIndex
    from desamba_tpu.index.kmers import rolling_kmers

    idx, dix, _ = device_setup
    eng = ClassifyEngine(idx)
    rng = np.random.default_rng(33)
    reads = _random_reads(idx, 14, rng)
    work = []
    for r in reads:
        seq = "".join("ACGT"[c] for c in r)
        dirs, both = get_islands(seq, idx)
        anchors, chains = [], []
        rl = len(seq)
        fast_classify(idx, eng.fm, eng.loc, eng.q_mem, eng.q_lv, dirs[0],
                      rl, anchors)
        if both:
            fast_classify(idx, eng.fm, eng.loc, eng.q_mem, eng.q_lv,
                          dirs[1], rl, anchors)
        resolve_tree(anchors, chains)
        if not chains or chains[0].anchor_number < 5:
            anchors = []
            slow_classify(idx, eng.fm, eng.loc, eng.q_mem, eng.q_lv,
                          dirs[0], rl, anchors)
            resolve_tree(anchors, chains)
            slow_classify(idx, eng.fm, eng.loc, eng.q_mem, eng.q_lv,
                          dirs[1], rl, anchors)
            resolve_tree(anchors, chains)
        if not chains or len(chains) > dr.C_CAP:
            continue
        truncate_chains(chains)
        work.append((seq, dirs, chains))
    assert work, "no chained reads"

    exp = []
    for seq, dirs, chains in work:
        cc = copy.deepcopy(chains)
        get_score_m2(idx, cc, dirs, len(seq), sc_hash_idx(cc), {})
        exp.append([(c.sum_score, c.q_st, c.q_ed, c.t_st, c.t_ed,
                     c.anchor_number, c.indel) for c in cc])

    B = len(work)
    chains_a = np.zeros((B, dr.C_CAP, dr.CF_N), np.int32)
    n_chains = np.zeros((B,), np.int32)
    anchors_a = np.zeros((B, dr.A_CAP, dr.AF_N), np.int32)
    schash = np.zeros((B, 2 * dr.C_CAP, 3), np.int32)
    n_hash = np.zeros((B,), np.int32)
    Lm = max(len(s) for s, _, _ in work)
    L2 = ((2 * Lm + 1023) // 1024) * 1024
    codes2 = np.zeros((B, L2), np.uint8)
    blen2 = np.zeros((B,), np.int32)
    rlen2 = np.zeros((B,), np.int32)
    for b, (seq, dirs, chains) in enumerate(work):
        rl = len(seq)
        n_chains[b] = len(chains)
        amap = {}
        for c in chains:
            a = c.chain_anchor_cur
            while a is not None and id(a) not in amap:
                amap[id(a)] = (len(amap), a)
                a = a.chain_anchor_pre
        for ai, a in amap.values():
            pre = (amap[id(a.chain_anchor_pre)][0]
                   if a.chain_anchor_pre is not None else -1)
            anchors_a[b, ai] = (a.index_in_read, a.ref_offset, a.mtch_len,
                                pre)
        for ci, c in enumerate(chains):
            cur = (amap[id(c.chain_anchor_cur)][0]
                   if c.chain_anchor_cur is not None else -1)
            chains_a[b, ci] = (c.ref_id, c.direction, c.sum_score,
                               c.anchor_number, c.t_st, c.t_ed, c.q_st,
                               c.q_ed, c.indel, cur)
        e = 0
        for ci, c in enumerate(chains):
            for s_or_e in (1, 0):
                key = ((c.t_st - c.q_st) if s_or_e == 1
                       else (c.t_ed - c.q_ed)) & 0xFF
                schash[b, e] = (key, ci, s_or_e)
                e += 1
        n_hash[b] = e
        buf = dirs[0].buf
        codes2[b, : 2 * rl] = buf
        blen2[b] = 2 * rl
        rlen2[b] = rl

    inp = dr.RescoreIn(
        chains=jnp.asarray(chains_a), n_chains=jnp.asarray(n_chains),
        anchors=jnp.asarray(anchors_a), schash=jnp.asarray(schash),
        n_hash=jnp.asarray(n_hash),
        codes_fr=jnp.asarray(codes2), buf_len=jnp.asarray(blen2),
        read_len=jnp.asarray(rlen2))
    chains_out, fb, _reason, _it = jax.block_until_ready(dr.rescore_kernel(
        inp, dix.ref_bin, dix.ref_off, dix.ref_len_arr, n_bases=dix.n_bases))
    chains_out = np.asarray(chains_out)
    fb = np.asarray(fb)

    def coord(v):
        # kernel coordinates are uint32 bit patterns in int32
        return int(v) & 0xFFFFFFFF

    for b, (seq, dirs, chains) in enumerate(work):
        assert not fb[b], f"read {b} fell back"
        got = [(int(chains_out[b, ci, dr.C_SUM]),
                coord(chains_out[b, ci, dr.C_QST]),
                coord(chains_out[b, ci, dr.C_QED]),
                coord(chains_out[b, ci, dr.C_TST]),
                coord(chains_out[b, ci, dr.C_TED]),
                int(chains_out[b, ci, dr.C_ANUM]),
                int(chains_out[b, ci, dr.C_INDEL]))
               for ci in range(len(chains))]
        assert got == exp[b], f"read {b}"


@pytest.mark.slow
def test_device_classifier_full_demo(demo_my_index, demo_files):
    """Full demo corpus through the device engine == frozen golden SAM."""
    from pathlib import Path

    from desamba_tpu.engine.device.classifier import DeviceClassifier
    from desamba_tpu.engine.gold.classify import Options
    from desamba_tpu.io.fastx import read_fastx
    from desamba_tpu.io.sam import format_result

    idx = demo_my_index
    opts = Options()
    eng = DeviceClassifier(idx, opts)
    reads = list(read_fastx(str(demo_files[1])))
    out = "".join(format_result(r, idx.ref_name, opts)
                  for r in eng.classify_reads(reads))
    golden = (Path(__file__).parent / "golden" / "demo_viral.sam").read_text()
    assert out == golden


def test_classify_file_pipeline(device_setup, tmp_path):
    """classify_file's overlapped reader pipeline == classify_reads."""
    from desamba_tpu.engine.device.classifier import DeviceClassifier
    from desamba_tpu.engine.gold.classify import Options
    from desamba_tpu.io.fastx import read_fastx
    from desamba_tpu.io.sam import format_result

    idx, _dix, _ = device_setup
    rng = np.random.default_rng(44)
    reads = _random_reads(idx, 6, rng)
    fq = tmp_path / "r.fastq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            seq = "".join("ACGT"[c] for c in r)
            f.write(f"@p{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    opts = Options()
    eng = DeviceClassifier(idx, opts, batch_size=3)
    got = [format_result(r, idx.ref_name, opts)
           for r in eng.classify_file(str(fq))]
    eng2 = DeviceClassifier(idx, opts, batch_size=3)
    exp = [format_result(r, idx.ref_name, opts)
           for r in eng2.classify_reads(list(read_fastx(str(fq))))]
    assert got == exp
