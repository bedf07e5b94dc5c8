"""DeviceClassifier: batched classify with a device-resident pipeline.

Stage split (v3):
  device — existence-filter probe, fast/slow ladders, M2 chaining,
           9-mer SDP rescore. Anchor rows and chain records stay in
           device memory between stages; the host sees only small
           per-lane vectors (counts/flags/decision scalars) until the
           final rescored chain rows come back.
  host   — island segmentation (native C batch call), lane/gather-map
           construction as vectorized numpy over flat seed arrays (the
           round-2 engine built per-read python lists here — the cost
           scaled with reads and dominated saturation batches),
           run_slow decisions, merge/filter/primary, SAM.
Host stages preserve input order so stream state (max_read_l) and
output order match the reference exactly. Reads whose device buffers
overflow (or that hit the M3 >=50-anchor chain path, src/cly.c:238-323)
fall back to the gold engine wholesale.
"""
from __future__ import annotations

import functools
import os

import numpy as np

import jax
import jax.numpy as jnp

from ...compile_cache import enable_compile_cache
from ...constants import (FORWARD, M3_ANCHOR_THRESHOLD, MIN_READ_LEN,
                           REVERSE, SEED_RANGE, STEP_EK)
from ...index.kmers import CLY_BIT
from ...io import native
from ..gold.classify import ClassifyEngine, Options, ReadResult, StreamState
from ..gold.islands import mark_top
from ..gold.chain import Chain
from ..gold.rescore import detect_primary, post_rescore_finish
from .arrays import DeviceIndex
from .islands import bloom_hit_kernel, segment_islands
from .ladder import IV_HOT, fast_ladder, slow_ladder
from .pipeline import pre13_values
from . import chain as dc
from . import rescore as dr

A_CAP = 96
M_CAP = 128


def _bucket(n: int, lo: int = 256) -> int:
    """Round lane counts up to power-of-two buckets so jit shapes repeat."""
    b = lo
    while b < n:
        b *= 2
    return b


def _csr_expand(offs, cnts):
    """Concatenate ranges [offs[i], offs[i]+cnts[i]) as one index array."""
    total = int(cnts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(cnts)[:-1]]), cnts)
    return np.repeat(np.asarray(offs, np.int64), cnts) + within


@functools.partial(
    jax.jit, static_argnames=("l_ek", "single_base_max", "mask_bits"))
def _bloom_packed(strands, lens, ek0, ek1, l_ek, single_base_max, mask_bits):
    """Returns the packed hit bits FLATTENED (row-major (Bpad, Wb)):
    the flatten lives inside the jit so the host's cross-bucket concat
    is the only extra device op before its one fetch."""
    hit = bloom_hit_kernel.__wrapped__(strands, lens, ek0, ek1, l_ek,
                                       single_base_max, mask_bits)
    pad = (-hit.shape[1]) % 8
    hitp = jnp.pad(hit, ((0, 0), (0, pad)))
    return jnp.packbits(hitp, axis=1).reshape(-1)


class LaneSet:
    """Flat per-lane arrays, ordered by (read row, part, seed id)."""

    __slots__ = ("ridx", "base", "rl", "dir", "sid", "soff", "slen", "n")

    def __init__(self, ridx, base, rl, dirs, sid, soff, slen):
        self.ridx = ridx
        self.base = base
        self.rl = rl
        self.dir = dirs
        self.sid = sid
        self.soff = soff
        self.slen = slen
        self.n = len(ridx)


class DeviceClassifier:
    def __init__(self, idx, opts: Options | None = None, batch_size: int = 2048):
        enable_compile_cache()
        self.idx = idx
        self.opts = opts or Options()
        self.dix = DeviceIndex.build(idx)
        self.ixr = self.dix.index_refs()
        self.gold = ClassifyEngine(idx, self.opts)  # fallback + host tables
        self.state = StreamState()
        self.batch_size = batch_size
        self.n_fallback = 0     # reads rescued by the gold oracle
        self.n_classified = 0

    def fallback_stats(self):
        return {"fallback_reads": self.n_fallback,
                "total_reads": self.n_classified}

    # ---- island stage ------------------------------------------------------
    def _islands(self, seqs):
        """Existence probe (device, batched) + island segmentation
        (native C batch call). Returns (bufs, seeds, s_off, s_cnt,
        totals): seeds (n, 3) int32 rows (offset, len, top) concatenated
        per strand; strand 2i = forward, 2i+1 = reverse of read i."""
        idx = self.idx
        l_ek = idx.len_e_kmer
        B = len(seqs)
        if B and native.available():
            # one C call encodes every read's F+R codes (fastx.c lays the
            # reverse complement contiguously after the forward strand,
            # exactly the bufs[i] layout) — the per-read python encode
            # loop was a prep-thread hot spot
            lens_np = np.array([len(s) for s in seqs], np.int64)
            mat = native.encode_batch("".join(seqs).encode(), lens_np,
                                      int(lens_np.max()))
            bufs = [mat[i, : 2 * lens_np[i]] for i in range(B)]
        else:
            bufs = []
            for seq in seqs:
                bin_f = CLY_BIT[np.frombuffer(seq.encode(), np.uint8)]
                bufs.append(np.concatenate([bin_f, (3 - bin_f)[::-1]]))
        if not B:
            z = np.zeros(0, np.int64)
            return bufs, np.zeros((0, 3), np.int32), z, z, z
        # bucket strands by read length: padding to the batch max cost
        # ~2.6x probe work on mixed-length corpora (probe gathers scale
        # with padded area). Pow-2 width buckets keep jit shapes reused.
        Lmax_all = max(len(b) // 2 for b in bufs)
        n_k_max = Lmax_all - l_ek + 1
        hits = np.zeros((2 * B, n_k_max), bool)
        order = sorted(range(B), key=lambda i: len(bufs[i]))
        pos = 0
        pending = []
        while pos < B:
            Lc = 1024
            while len(bufs[order[pos]]) // 2 > Lc:
                Lc *= 2
            grp = []
            while pos < B and len(bufs[order[pos]]) // 2 <= Lc:
                grp.append(order[pos])
                pos += 1
            Bpad = _bucket(2 * len(grp), 64)
            strands = np.zeros((Bpad, Lc), np.uint8)
            lens = np.zeros((Bpad,), np.int32)
            for k, i in enumerate(grp):
                b = bufs[i]
                rl = len(b) // 2
                strands[2 * k, :rl] = b[:rl]
                strands[2 * k + 1, :rl] = b[rl:]
                lens[2 * k] = lens[2 * k + 1] = rl
            # bit-pack on device (8x fewer bytes to fetch); dispatch
            # every bucket before draining any — async dispatch overlaps
            # the buckets' device compute and downloads
            Wb = (Lc - l_ek + 1 + 7) // 8
            pending.append((grp, self._k_bloom(jnp.asarray(strands),
                                               jnp.asarray(lens)),
                            Bpad, Wb))
        # ONE host fetch for all buckets (each fetch is a host-device
        # sync); the per-bucket flatten happens inside the bloom jit
        flat = (pending[0][1] if len(pending) == 1 else
                jnp.concatenate([pd for _, pd, _, _ in pending]))
        flat_h = np.asarray(flat)
        at = 0
        for grp, _pd, Bpad, Wb in pending:
            got = np.unpackbits(
                flat_h[at : at + Bpad * Wb].reshape(Bpad, Wb),
                axis=1).astype(bool)
            at += Bpad * Wb
            for k, i in enumerate(grp):
                nk = len(bufs[i]) // 2 - l_ek + 1
                hits[2 * i, :nk] = got[2 * k, :nk]
                hits[2 * i + 1, :nk] = got[2 * k + 1, :nk]

        n_k_a = np.zeros((2 * B,), np.int32)
        dirs_a = np.zeros((2 * B,), np.int32)
        n_k_a[0::2] = n_k_a[1::2] = [len(s) - l_ek + 1 for s in seqs]
        dirs_a[0::2] = FORWARD
        dirs_a[1::2] = REVERSE
        if native.available():
            # one C call segments + top-marks every strand (the serial
            # phase-chained walk was the last per-read host hot loop)
            seeds, s_off, s_cnt, totals = native.islands_batch(
                hits.view(np.uint8), n_k_a, dirs_a, STEP_EK, SEED_RANGE)
            return bufs, seeds, s_off, s_cnt, totals
        # python fallback: run-based walk == gold search_islands
        rows, offs, cnts, tots = [], [], [], []
        at = 0
        for s in range(2 * B):
            nk = int(n_k_a[s])
            sl = segment_islands(hits[s, :nk], nk, int(dirs_a[s]))
            tots.append(mark_top(sl, nk, int(dirs_a[s])))
            offs.append(at)
            cnts.append(len(sl))
            at += len(sl)
            rows.extend(sl)
        seeds = (np.array(rows, np.int32).reshape(-1, 3)
                 if rows else np.zeros((0, 3), np.int32))
        return (bufs, seeds, np.array(offs, np.int64),
                np.array(cnts, np.int64), np.array(tots, np.int64))

    # ---- ladder helpers ----------------------------------------------------
    # Island-length partition thresholds: ladder trip counts follow the
    # longest island in the batch, and lengths are heavily skewed
    # (p50=5, max 61), so grouping by length cuts lockstep waste.
    _LEN_SPLITS = (7, 17, 1 << 30)
    # ladder lockstep width (lanes worked per while-loop trip); it sets
    # trip counts, not results
    _BL = 128

    def _run_ladder(self, kind, ls: LaneSet, codes_fr, buf_len, pre13):
        if ls.n == 0:
            return None
        order = np.argsort(ls.slen, kind="stable")
        slen_o = ls.slen[order]
        bounds = np.searchsorted(slen_o, np.array(self._LEN_SPLITS), "right")
        groups = []
        start = 0
        for b in bounds:
            if b > start:
                groups.append(order[start:b])
            start = b
        base_all = np.zeros((ls.n,), np.int64)
        acnt_all = np.zeros((ls.n,), np.int32)
        skip_all = np.zeros((ls.n,), bool)
        bad_all = np.zeros((ls.n,), bool)
        packed_all = []
        offset = 0
        # dispatch every length group before draining any (async jax
        # dispatch overlaps the groups' device compute)
        outs = [self._dispatch_ladder_group(kind, ls, g, codes_fr, buf_len,
                                            pre13) for g in groups]
        # ONE host fetch for all groups: every synchronous value fetch
        # is a host-device sync. The small per-lane vectors are packed
        # into a single (sum NB, 4) array on device; anchor rows stay in
        # device memory.
        info_h = self._fetch_ladder_info(outs)
        # SP_SET hot-tier overflow (info col 3): re-dispatch those
        # groups at full IV_CAP (cannot overflow) and use their results
        # wholesale. Rare (big-repeat corpora), so the full-cap variant
        # only ever compiles when first needed.
        at = 0
        redo = []
        for gi, (g, (out, NB)) in enumerate(zip(groups, outs)):
            if info_h[at : at + len(g), 3].any():
                redo.append(gi)
            at += NB
        if redo:
            info_h = np.array(info_h)  # device fetch can be read-only
            for gi in redo:
                outs[gi] = self._dispatch_ladder_group(
                    kind, ls, groups[gi], codes_fr, buf_len, pre13,
                    iv_cap=None)
            redo_info = self._fetch_ladder_info([outs[gi] for gi in redo])
            at = 0
            starts = []
            for (out, NB) in outs:
                starts.append(at)
                at += NB
            r_at = 0
            for gi in redo:
                NB = outs[gi][1]
                info_h[starts[gi] : starts[gi] + NB] = \
                    redo_info[r_at : r_at + NB]
                r_at += NB
        at = 0
        for g, (out, NB) in zip(groups, outs):
            info = info_h[at : at + NB]
            at += NB
            base = info[:, 0].astype(np.int64)
            acnt = info[:, 1]
            skip = info[:, 2].astype(bool)
            # per-LANE pack overflow only (the packed povf scalar is the
            # .any() of this — OR-ing it in would regress to per-batch
            # fallback)
            bad = base + np.minimum(acnt, A_CAP) > self._pack_cap_local(NB)
            base = self._globalize_base(base, NB)
            base_all[g] = offset + base[: len(g)]
            acnt_all[g] = acnt[: len(g)]
            skip_all[g] = skip[: len(g)]
            bad_all[g] = bad[: len(g)]
            packed_all.append(out[0])
            offset += out[0].shape[0]
        packed_dev = (packed_all[0] if len(packed_all) == 1
                      else jnp.concatenate(packed_all, axis=0))
        return [packed_dev, base_all, acnt_all, skip_all, bad_all]

    def _fetch_ladder_info(self, outs):
        """One packed host fetch of the per-lane scalars
        [base, acnt, skip/flag, iv_ovf] for a list of ladder outs. The
        (N, 4) info rows are built inside the ladder jit (pack_info);
        here there is one concat and one fetch. The pack
        overflow scalar is recomputed per lane below, not fetched."""
        info_parts = [out[1] for (out, NB) in outs]
        return np.asarray(jnp.concatenate(info_parts, axis=0)
                          if len(info_parts) > 1 else info_parts[0])

    def _dispatch_ladder_group(self, kind, ls: LaneSet, g, codes_fr,
                               buf_len, pre13, iv_cap=IV_HOT):
        N = len(g)
        NB = _bucket(N)
        # ONE (8, NB) upload per group instead of eight: each
        # host->device asarray is its own transfer
        cols = np.zeros((8, NB), np.int32)
        cols[0, :N] = ls.ridx[g]
        cols[1, :N] = ls.base[g]
        cols[2, :N] = ls.rl[g]
        cols[3, :N] = ls.dir[g]
        cols[4, :N] = ls.sid[g]
        cols[5, :N] = ls.soff[g]
        cols[6, :N] = ls.slen[g]
        cols[7, :N] = 1  # lane_on
        return (self._k_ladder(kind, codes_fr, buf_len, pre13,
                               jnp.asarray(cols), NB, iv_cap=iv_cap), NB)

    def _pack_cap_local(self, NB):
        # single device: the ladder pack spans the whole group
        return 2 * NB

    # ---- kernel indirection (overridden by parallel.MeshClassifier) ------
    def _k_bloom(self, strands, lens):
        return _bloom_packed(strands, lens, self.dix.ekmer0,
                             self.dix.ekmer1, self.idx.len_e_kmer,
                             self.idx.single_base_max, self.dix.mask_bits)

    def _k_ladder(self, kind, codes_fr, buf_len, pre13, lane_args, NB,
                  iv_cap=IV_HOT):
        dix = self.dix
        args = (self.ixr, dix.fm_blocks, dix.rank, dix.hash13, codes_fr,
                buf_len, pre13, dix.q_mem, dix.q_lv, lane_args)
        bl = min(self._BL, NB)
        if kind == "fast":
            return fast_ladder(*args, l_ek=self.idx.len_e_kmer, a_cap=A_CAP,
                               pack_cap=2 * NB, bl=bl, iv_cap=iv_cap)
        return slow_ladder(*args, l_ek=self.idx.len_e_kmer, a_cap=A_CAP,
                           m_cap=M_CAP, pack_cap=2 * NB, bl=bl,
                           iv_cap=iv_cap)

    def _globalize_base(self, base, NB):
        # single device: ladder pack offsets are already global
        return base

    def _k_chain(self, packed, gidx, nanc):
        return dc.chain_step(packed, jnp.asarray(gidx), jnp.asarray(nanc))

    def _k_chain_m3(self, packed, gidx, nanc):
        # the M3 sub-batch is small (m3 reads are rare); it runs
        # replicated even on a mesh (GSPMD gathers the dp-sharded pack)
        return dc.m3_chain_step(packed, jnp.asarray(gidx),
                                jnp.asarray(nanc))

    def _k_prep(self, sel, chs3, ns3, pre3, anc3):
        return dc.prep_rescore(jnp.asarray(sel), chs3, ns3, pre3, anc3)

    def _k_rescore(self, inp):
        dix = self.dix
        B_pad = inp.n_chains.shape[0]
        return dr.rescore_kernel(
            inp, dix.ref_bin, dix.ref_off, dix.ref_len_arr,
            n_bases=dix.n_bases, bf=max(64, B_pad // 13 // 32 * 32),
            bp=max(64, B_pad // 10 // 32 * 32), pp=8)

    # ---- gather-map construction (vectorized) -----------------------------
    @staticmethod
    def _keep_with_skip(ls: LaneSet, flag):
        """The reference's skip_next rule (src/cly.c:1494-1534 via the
        ladder's >512 flag) over fast lanes: a flagged island skips the
        NEXT SEED of its read and direction (gold fast_classify `si +=
        1`). That seed has a lane only if it is a top seed, so a lane is
        dropped when the previous kept lane carried the flag and holds
        the seed just before it. Within a maximal run of such lanes
        inclusion alternates, so keep = (distance to the last lane that
        is not a skip candidate) is even."""
        n = ls.n
        if n == 0:
            return np.zeros(0, bool)
        h = np.zeros(n, bool)
        h[1:] = (flag[:-1] & (ls.ridx[1:] == ls.ridx[:-1])
                 & (ls.dir[1:] == ls.dir[:-1])
                 & (ls.sid[1:] == ls.sid[:-1] + 1))
        idxs = np.arange(n)
        last_anchor = np.maximum.accumulate(np.where(~h, idxs, -1))
        return ((idxs - last_anchor) % 2) == 0

    def _build_gidx(self, B_pad, A2, lane_read, base, cnt, flag,
                    keep, fallback_rows):
        """Per-read packed-row id lists -> (gidx, nanc); flags reads
        whose rows exceed A2 or whose lanes overflowed in
        fallback_rows (bool (B_pad,), mutated). keep is the fast pass's
        skip_next mask; None for slow passes, whose flag marks an
        overflow. Only the small base/cnt/flag vectors are touched —
        anchor rows stay on device."""
        gidx = np.full((B_pad, A2), -1, np.int32)
        nanc = np.zeros((B_pad,), np.int32)
        if len(lane_read) == 0:
            return gidx, nanc
        if keep is not None:
            bad = keep & (cnt > A_CAP)
        else:
            keep = np.ones(len(lane_read), bool)
            bad = (cnt > A_CAP) | flag
        np.logical_or.at(fallback_rows, lane_read[bad], True)
        kcnt = np.where(keep & ~fallback_rows[lane_read], cnt, 0)
        tot = np.bincount(lane_read, weights=kcnt,
                          minlength=B_pad).astype(np.int64)
        # (A2, M3_A2] anchors -> the device M3 sub-batch; beyond -> host
        wide = tot > A2
        fallback_rows |= tot > dc.M3_A2
        if wide.any():
            kcnt = np.where(wide[lane_read] | fallback_rows[lane_read],
                            0, kcnt)
            tot[wide] = 0
        # flat destination: read_row * A2 + prefix within read
        pre = np.cumsum(kcnt) - kcnt
        read_start = np.zeros(B_pad, np.int64)
        first = np.ones(len(lane_read), bool)
        first[1:] = lane_read[1:] != lane_read[:-1]
        read_start[lane_read[first]] = pre[first]
        within = pre - read_start[lane_read]
        rowids = _csr_expand(base, kcnt)
        dest = _csr_expand(lane_read.astype(np.int64) * A2 + within, kcnt)
        gidx.reshape(-1)[dest] = rowids
        nanc[: len(tot)] = tot
        return gidx, nanc, wide & ~fallback_rows

    def _gidx_wide(self, rows, lane_read, base, cnt, keep, fallback_rows):
        """(len(rows), M3_A2) gather map for the M3 sub-batch reads; keep
        as in _build_gidx."""
        A2w = dc.M3_A2
        Bm = len(rows)
        sub = np.zeros(int(lane_read.max(initial=-1)) + 2, np.int64) - 1
        sub[rows] = np.arange(Bm)
        gidx = np.full((Bm, A2w), -1, np.int32)
        nanc = np.zeros((Bm,), np.int32)
        if len(lane_read) == 0 or Bm == 0:
            return gidx, nanc
        if keep is None:
            keep = np.ones(len(lane_read), bool)
        m = (sub[lane_read] >= 0) & keep & ~fallback_rows[lane_read]
        lr = sub[lane_read[m]]
        kcnt = np.minimum(cnt[m], A_CAP)
        bs = base[m]
        tot = np.bincount(lr, weights=kcnt, minlength=Bm).astype(np.int64)
        pre = np.cumsum(kcnt) - kcnt
        read_start = np.zeros(Bm, np.int64)
        first = np.ones(len(lr), bool)
        first[1:] = lr[1:] != lr[:-1]
        read_start[lr[first]] = pre[first]
        within = pre - read_start[lr]
        rowids = _csr_expand(bs, kcnt)
        dest = _csr_expand(lr.astype(np.int64) * A2w + within, kcnt)
        gidx.reshape(-1)[dest] = rowids
        nanc[:] = np.minimum(tot, A2w)
        return gidx, nanc

    # ---- main entry --------------------------------------------------------
    def classify_reads(self, recs):
        """Batched classify, pipelined (the kt_pipeline contract,
        reference src/lib/kthread.c:157-197): batch N+1's island prep
        runs in a prep thread, its DEVICE phase (dispatches + fetch
        waits) runs in a device worker thread overlapping batch N's
        device phase and host finish, and finishes run on the calling
        thread strictly in input order — StreamState
        (prefix-max max_read_l) updates stay serialized, so output is
        bit-identical to the serial schedule."""
        from concurrent.futures import ThreadPoolExecutor

        batches = [recs[i : i + self.batch_size]
                   for i in range(0, len(recs), self.batch_size)]
        if len(batches) <= 1:
            for b in batches:
                yield from self._classify_batch(b)
            return
        # DEPTH device phases in flight: their host-side stages and
        # fetch waits overlap each other (threads), while the device
        # serializes the executions.
        DEPTH = int(os.environ.get("DESAMBA_PIPE_DEPTH", "3"))
        PREP_W = int(os.environ.get("DESAMBA_PREP_WORKERS", "2"))
        with ThreadPoolExecutor(max_workers=PREP_W) as prep_ex, \
                ThreadPoolExecutor(max_workers=DEPTH) as dev_ex:
            prep_futs = [prep_ex.submit(self._prep_batch, b)
                         for b in batches[: DEPTH + 1]]

            def take_prep(k):
                # the device phase holds batch k's prep from here on
                prep = prep_futs[k].result()
                prep_futs[k] = None
                return prep

            dev_futs = []
            for k in range(min(DEPTH, len(batches))):
                dev_futs.append(dev_ex.submit(self._device_phase,
                                              batches[k], take_prep(k)))
            for bi in range(len(batches)):
                nxt = bi + DEPTH
                if nxt < len(batches):
                    dev_futs.append(dev_ex.submit(
                        self._device_phase, batches[nxt], take_prep(nxt)))
                    if nxt + 1 < len(batches):
                        prep_futs.append(prep_ex.submit(
                            self._prep_batch, batches[nxt + 1]))
                finish = dev_futs.pop(0).result()
                yield from finish()

    def _classify_batch(self, recs, prep=None):
        return self._device_phase(recs, prep)()

    def _prep_batch(self, recs):
        todo = [i for i, r in enumerate(recs) if len(r.seq) >= MIN_READ_LEN]
        islands = self._islands([recs[i].seq for i in todo])
        return todo, islands

    def _device_phase(self, recs, prep=None):
        idx = self.idx
        l_ek = idx.len_e_kmer
        results = [ReadResult(r.name, r.seq, r.qual, len(r.seq))
                   for r in recs]
        if prep is None:
            prep = self._prep_batch(recs)
        todo, (bufs, seeds, s_off, s_cnt, s_tot) = prep
        if not todo:
            def _finish_empty():
                # counters update in the (serial) finish, not the
                # concurrent device phases
                self.n_classified += len(recs)
                return results
            return _finish_empty
        B = len(todo)
        rl_arr = np.array([len(recs[i].seq) for i in todo], np.int32)

        # pad buffer dims to buckets so ladder jit shapes repeat across
        # batches (B to pow2, width to a 2048 multiple)
        Lmax = max(len(b) for b in bufs)
        Lmax = ((Lmax + 2047) // 2048) * 2048
        B_pad = _bucket(B, 64)
        codes_np = np.zeros((B_pad, Lmax), np.uint8)
        blen_np = np.zeros((B_pad,), np.int32)
        for k in range(B):
            codes_np[k, : len(bufs[k])] = bufs[k]
            blen_np[k] = len(bufs[k])
        codes_fr = jnp.asarray(codes_np)
        buf_len = jnp.asarray(blen_np)
        pre13 = pre13_values(codes_fr, l_ek)
        rlen_np = np.zeros((B_pad,), np.int32)
        rlen_np[:B] = rl_arr

        # ---- strand metadata (read row k <-> strands 2k, 2k+1) ------------
        s_tot = s_tot.astype(np.int64)
        d0 = (s_tot[0::2] < s_tot[1::2]).astype(np.int64)  # best dir first
        t_hi = np.where(d0 == 1, s_tot[1::2], s_tot[0::2])
        t_lo = np.where(d0 == 1, s_tot[0::2], s_tot[1::2])
        both = (t_hi - t_lo) <= (t_hi >> 3)
        ar2 = np.arange(B, dtype=np.int64)
        strand_dir = np.tile(np.array([FORWARD, REVERSE], np.int32), B)
        strand_base = np.zeros(2 * B, np.int32)
        strand_base[1::2] = rl_arr
        # strands in (read, dpos) order; dpos 0 = best direction
        ord_strands = np.empty(2 * B, np.int64)
        ord_strands[0::2] = 2 * ar2 + d0
        ord_strands[1::2] = 2 * ar2 + 1 - d0
        first_top = np.zeros(2 * B, bool)
        has = s_cnt > 0
        first_top[has] = seeds[s_off[has], 2] > 0

        def lanes_for(strands, seed_mask_fn):
            """LaneSet for the given strand list (ordered by read),
            filtering seeds by seed_mask_fn(global seed idx array,
            strand array per seed)."""
            cnts = s_cnt[strands]
            sidx = _csr_expand(s_off[strands], cnts)
            sstr = np.repeat(strands, cnts)
            sid = (sidx - s_off[sstr]).astype(np.int32)
            m = seed_mask_fn(sidx, sstr)
            sidx, sstr, sid = sidx[m], sstr[m], sid[m]
            ridx = (sstr // 2).astype(np.int32)
            return LaneSet(ridx, strand_base[sstr], rl_arr[ridx],
                           strand_dir[sstr], sid,
                           seeds[sidx, 0], seeds[sidx, 1])

        # ---- fast pass (dir0 + dir1-if-both) ------------------------------
        inc_strand = np.zeros(2 * B, bool)
        inc_strand[ord_strands[0::2]] = True
        inc_strand[ord_strands[1::2]] |= both
        fast_ls = lanes_for(ord_strands,
                            lambda sidx, sstr: (seeds[sidx, 2] > 0)
                            & inc_strand[sstr])
        fast_out = self._run_ladder("fast", fast_ls, codes_fr, buf_len,
                                    pre13)

        fallback = np.zeros(B_pad, bool)
        if fast_out is not None and fast_out[4].any():
            np.logical_or.at(fallback, fast_ls.ridx[fast_out[4]], True)

        A2 = dr.A_CAP

        zero_set = None

        def chain_stage(packed, gidx, nanc):
            nonlocal zero_set
            if packed is None:
                if zero_set is None:
                    z = jnp.zeros
                    zero_set = (z((B_pad, dc.C2, dc.CH_NF), jnp.int32),
                                jnp.zeros((B_pad,), jnp.int32),
                                jnp.full((B_pad, A2), -1, jnp.int32),
                                jnp.zeros((B_pad,), bool),
                                z((B_pad, A2, 3), jnp.int32))
                return zero_set, np.zeros((B_pad,), np.int32), \
                    np.zeros((B_pad, 2), np.int32), \
                    np.zeros((B_pad,), bool)
            out = self._k_chain(packed, gidx, nanc)
            # ONE packed fetch (n, dec0, dec1, ovf) per stage, built
            # inside the chain jit: separate np.asarray calls (and even
            # a host-side jnp.stack) would each be a host-device sync
            info = np.array(out[5])
            n_h = info[:, 0]
            dec = info[:, 1:3]      # writable: the M3 stage scatters in
            ovf_h = info[:, 3].astype(bool)
            return out[:5], n_h, dec, ovf_h

        m3_sets = [None, None, None]   # per chain stage

        def m3_stage(stage, packed, wide_mask, nanc_main, ovf_h, n_h, dec,
                     lane_read, base_a, cnt_a, keep):
            """Route >=50-anchor reads (kernel M3-threshold flag or the
            gidx wide mask) through the device M3 kernel; residual
            chain-slot overflows still go to the host oracle."""
            cand = ((ovf_h & (nanc_main >= M3_ANCHOR_THRESHOLD))
                    | wide_mask) & ~fallback
            resid = ovf_h & ~cand
            fallback[:] |= resid
            rows = np.flatnonzero(cand)
            if len(rows) == 0 or packed is None:
                return
            gw, nw = self._gidx_wide(rows, lane_read, base_a, cnt_a, keep,
                                     fallback)
            Bm = _bucket(len(rows), 8)
            gpad = np.full((Bm, dc.M3_A2), -1, np.int32)
            gpad[: len(rows)] = gw
            npad = np.zeros((Bm,), np.int32)
            npad[: len(rows)] = nw
            chm, nm, prem, ovfm, anc3m, im = self._k_chain_m3(packed, gpad,
                                                             npad)
            infom = np.asarray(im)
            nm_h = infom[:, 0]
            ovfm_h = infom[:, 3].astype(bool)
            decm = infom[:, 1:3]
            ok = ~ovfm_h[: len(rows)]
            fallback[rows[~ok]] = True
            n_h[rows[ok]] = nm_h[: len(rows)][ok]
            dec[rows[ok]] = decm[: len(rows)][ok]
            m3_sets[stage] = dict(
                map={int(k): i for i, k in enumerate(rows)},
                ok={int(k) for k in rows[ok]},
                ch=chm, n=nm_h, pre=prem, anc3=anc3m, nanc=npad)

        # ---- fast chains (device) -----------------------------------------
        if fast_out is not None:
            fast_keep = self._keep_with_skip(fast_ls, fast_out[3])
            gidx_f, nanc_f, wide_f = self._build_gidx(
                B_pad, A2, fast_ls.ridx, fast_out[1], fast_out[2],
                fast_out[3], fast_keep, fallback)
        else:
            gidx_f, nanc_f = None, np.zeros((B_pad,), np.int32)
            wide_f = np.zeros((B_pad,), bool)
        set_f, n_f, dec_f, ovf_f = chain_stage(
            fast_out[0] if fast_out is not None else None, gidx_f, nanc_f)
        if fast_out is not None:
            m3_stage(0, fast_out[0], wide_f, nanc_f, ovf_f, n_f, dec_f,
                     fast_ls.ridx, fast_out[1], fast_out[2], fast_keep)

        # ---- run_slow decisions + slow dir0 -------------------------------
        n0 = n_f[:B]
        run_slow = ((n0 == 0)
                    | ((dec_f[:B, 0] < 5)
                       & ~((rl_arr <= 300) & (dec_f[:B, 1] > 200))))
        run_slow &= ~fallback[:B]
        for k in np.flatnonzero(run_slow):
            results[todo[k]].fast = False
        slow_reads0 = np.flatnonzero(run_slow)
        str0 = (2 * slow_reads0 + d0[slow_reads0]).astype(np.int64)
        slow0_ls = lanes_for(
            str0, lambda sidx, sstr: (seeds[sidx, 1] >= 3)
            | first_top[sstr])
        slow0_out = self._run_ladder("slow", slow0_ls, codes_fr, buf_len,
                                     pre13)
        if slow0_out is not None and slow0_out[4].any():
            np.logical_or.at(fallback, slow0_ls.ridx[slow0_out[4]], True)
        if slow0_out is not None:
            gidx_s0, nanc_s0, wide_s0 = self._build_gidx(
                B_pad, A2, slow0_ls.ridx, slow0_out[1], slow0_out[2],
                slow0_out[3], None, fallback)
        else:
            gidx_s0, nanc_s0 = None, np.zeros((B_pad,), np.int32)
            wide_s0 = np.zeros((B_pad,), bool)
        set_s0, n_s0, dec_s0, ovf_s0 = chain_stage(
            slow0_out[0] if slow0_out is not None else None, gidx_s0,
            nanc_s0)
        if slow0_out is not None:
            m3_stage(1, slow0_out[0], wide_s0, nanc_s0, ovf_s0, n_s0,
                     dec_s0, slow0_ls.ridx, slow0_out[1], slow0_out[2], None)

        # ---- decide + run slow dir1 ---------------------------------------
        in_slow0 = np.zeros(B, bool)
        in_slow0[slow_reads0] = True
        want1 = in_slow0 & ~fallback[:B] & (
            both | (n_s0[:B] == 0) | (dec_s0[:B, 0] < 5))
        slow_reads1 = np.flatnonzero(want1)
        str1 = (2 * slow_reads1 + 1 - d0[slow_reads1]).astype(np.int64)
        slow1_ls = lanes_for(
            str1, lambda sidx, sstr: (seeds[sidx, 1] >= 3)
            | first_top[sstr])
        slow1_out = self._run_ladder("slow", slow1_ls, codes_fr, buf_len,
                                     pre13)
        if slow1_out is not None and slow1_out[4].any():
            np.logical_or.at(fallback, slow1_ls.ridx[slow1_out[4]], True)
        # sel falls back to the slow0 set when no dir1 lanes ran at all
        # (matching the round-2 engine's `slow1_out is not None` gate)
        in_slow1 = np.zeros(B, bool)
        if slow1_out is not None:
            in_slow1[slow_reads1] = True
        if slow1_out is not None:
            # chain call 3 consumes slow0 + slow1 anchors per read: order
            # the combined lanes by (read, part) and offset dir1 row ids
            # past the dir0 pack
            off01 = slow0_out[0].shape[0]
            m0 = in_slow1[slow0_ls.ridx]
            lr = np.concatenate([slow0_ls.ridx[m0], slow1_ls.ridx])
            part = np.concatenate([np.zeros(int(m0.sum()), np.int8),
                                   np.ones(slow1_ls.n, np.int8)])
            bs = np.concatenate([slow0_out[1][m0], slow1_out[1] + off01])
            ct = np.concatenate([slow0_out[2][m0], slow1_out[2]])
            fl = np.concatenate([slow0_out[3][m0], slow1_out[3]])
            o = np.lexsort((part, lr))
            gidx_s1, nanc_s1, wide_s1 = self._build_gidx(
                B_pad, A2, lr[o], bs[o], ct[o], fl[o], None, fallback)
            packed01 = jnp.concatenate([slow0_out[0], slow1_out[0]], axis=0)
        else:
            gidx_s1, nanc_s1 = None, np.zeros((B_pad,), np.int32)
            wide_s1 = np.zeros((B_pad,), bool)
            packed01 = None
        set_s1, n_s1, dec_s1, ovf_s1 = chain_stage(packed01, gidx_s1,
                                                   nanc_s1)
        if packed01 is not None:
            m3_stage(2, packed01, wide_s1, nanc_s1, ovf_s1, n_s1, dec_s1,
                     lr[o], bs[o], ct[o], None)

        # ---- device rescore over the whole batch --------------------------
        sel_np = np.zeros((B_pad,), np.int32)
        sel_np[:B] = np.where(in_slow1, 2, np.where(in_slow0, 1, 0))
        nanc_final = np.where(sel_np == 2, nanc_s1,
                              np.where(sel_np == 1, nanc_s0, nanc_f))
        live_np = np.zeros((B_pad,), bool)
        live_np[:B] = ~fallback[:B]
        # reads whose SELECTED stage ran the M3 kernel take the M3
        # sub-batch prep/rescore path (wide anchors)
        m3_final = []
        for k in range(B):
            st = m3_sets[sel_np[k]]
            if (not fallback[k]) and st is not None and k in st["ok"]:
                m3_final.append((k, int(sel_np[k]), st["map"][k]))
        m3_row = {k: u for u, (k, _, _) in enumerate(m3_final)}
        for k in m3_row:
            live_np[k] = False
        chs3 = jnp.stack([set_f[0], set_s0[0], set_s1[0]])
        ns3 = jnp.stack([set_f[1], set_s0[1], set_s1[1]])
        pre3 = jnp.stack([set_f[2], set_s0[2], set_s1[2]])
        anc3 = jnp.stack([set_f[4], set_s0[4], set_s1[4]])
        chains_rc, n_rc, anchors4, schash, n_hash, over = self._k_prep(
            sel_np, chs3, ns3, pre3, anc3)
        n_rc = jnp.where(jnp.asarray(live_np), n_rc, 0)
        inp = dr.RescoreIn(
            chains=chains_rc, n_chains=n_rc, anchors=anchors4,
            schash=schash, n_hash=n_hash, codes_fr=codes_fr,
            buf_len=buf_len, read_len=jnp.asarray(rlen_np))
        chains_out, fb, _reason, _iters = self._k_rescore(inp)
        # ONE packed fetch: append (fb, n_rc, over) as an extra chain row
        # instead of three separate host-device syncs
        Bq, Cq, Fq = chains_out.shape
        extra = jnp.zeros((Bq, 1, Fq), jnp.int32)
        extra = extra.at[:, 0, 0].set(fb.astype(jnp.int32))
        extra = extra.at[:, 0, 1].set(n_rc)
        extra = extra.at[:, 0, 2].set(over.astype(jnp.int32))
        allq = np.asarray(jnp.concatenate([chains_out, extra], axis=1))
        chains_h = allq[:, :Cq]
        fb_h = allq[:, Cq, 0].astype(bool)
        n_h = allq[:, Cq, 1]
        over_h = allq[:, Cq, 2].astype(bool)

        # ---- M3 sub-batch prep + rescore (M3_A2-wide anchors) --------------
        if m3_final:
            dix = self.dix
            Bmu = _bucket(len(m3_final), 8)
            chU = jnp.zeros((Bmu, dc.C2, dc.CH_NF), jnp.int32)
            preU = jnp.full((Bmu, dc.M3_A2), -1, jnp.int32)
            ancU = jnp.zeros((Bmu, dc.M3_A2, 3), jnp.int32)
            nU = np.zeros((Bmu,), np.int32)
            nancU = np.zeros((Bmu,), np.int32)
            rowsU = np.zeros((Bmu,), np.int32)
            rowsU[: len(m3_final)] = [k for k, _, _ in m3_final]
            for s in (0, 1, 2):
                us = [u for u, (_, ss, _) in enumerate(m3_final) if ss == s]
                if not us:
                    continue
                js = np.array([m3_final[u][2] for u in us], np.int32)
                ua = np.array(us, np.int32)
                st = m3_sets[s]
                chU = chU.at[ua].set(st["ch"][js])
                preU = preU.at[ua].set(st["pre"][js])
                ancU = ancU.at[ua].set(st["anc3"][js])
                nU[ua] = st["n"][js]
                nancU[ua] = st["nanc"][js]
            three = lambda x: jnp.stack([x, x, x])
            selU = jnp.zeros((Bmu,), jnp.int32)
            (chains_rcU, n_rcU, anchors4U, schashU, n_hashU,
             overU) = dc.prep_rescore(selU, three(chU),
                                      three(jnp.asarray(nU)), three(preU),
                                      three(ancU))
            liveU = np.zeros((Bmu,), bool)
            liveU[: len(m3_final)] = True
            n_rcU = jnp.where(jnp.asarray(liveU), n_rcU, 0)
            ru = jnp.asarray(rowsU)
            inpU = dr.RescoreIn(
                chains=chains_rcU, n_chains=n_rcU, anchors=anchors4U,
                schash=schashU, n_hash=n_hashU, codes_fr=codes_fr[ru],
                buf_len=buf_len[ru],
                read_len=jnp.asarray(rlen_np[rowsU]))
            chains_oU, fbU, _rU, _iU = dr.rescore_kernel(
                inpU, dix.ref_bin, dix.ref_off, dix.ref_len_arr,
                n_bases=dix.n_bases, bf=max(8, Bmu // 4),
                bp=max(8, Bmu // 4), pp=8)
            BqU, CqU, FqU = chains_oU.shape
            extraU = jnp.zeros((BqU, 1, FqU), jnp.int32)
            extraU = extraU.at[:, 0, 0].set(fbU.astype(jnp.int32))
            extraU = extraU.at[:, 0, 1].set(n_rcU)
            extraU = extraU.at[:, 0, 2].set(overU.astype(jnp.int32))
            allU = np.asarray(jnp.concatenate([chains_oU, extraU], axis=1))
            chains_hU = allU[:, :CqU]
            fb_hU = allU[:, CqU, 0].astype(bool)
            n_hU = allU[:, CqU, 1]
            over_hU = allU[:, CqU, 2].astype(bool)

        # ---- host finish, in input order (closure: run on the
        # main thread so StreamState updates stay serialized when
        # device phases of later batches run concurrently) ----
        def _finish():
            self.n_classified += len(recs)

            def coord(v):
                # kernel coordinates are uint32 bit patterns in int32; gold's
                # finish code works in the masked-u32 domain
                return int(v) & 0xFFFFFFFF

            from ..gold.rescore import post_finish_native
            for k, i in enumerate(todo):
                res = results[i]
                if k in m3_row:   # M3 sub-batch outputs for this read
                    u = m3_row[k]
                    ch_k, n_k = chains_hU[u], n_hU[u]
                    fb_k, ov_k = fb_hU[u], over_hU[u]
                    na_k = nancU[u]
                else:
                    ch_k, n_k = chains_h[k], n_h[k]
                    fb_k, ov_k = fb_h[k], over_h[k]
                    na_k = nanc_final[k]
                if (fallback[k] or ov_k or (n_k > 0 and fb_k)):
                    g = self.gold
                    g.state = self.state
                    results[i] = g.classify_read(recs[i].name, recs[i].seq,
                                                 recs[i].qual)
                    self.n_fallback += 1
                    continue
                res.anchors = [None] * int(na_k)
                chains = []
                for ci in range(int(n_k)):
                    row = ch_k[ci]
                    chains.append(Chain(
                        ref_id=int(row[dr.C_REF]), q_t_dis=0,
                        sum_score=int(row[dr.C_SUM]),
                        anchor_number=int(row[dr.C_ANUM]),
                        direction=int(row[dr.C_DIR]), with_top_anchor=False,
                        primary=0, pri_index=0, t_st=coord(row[dr.C_TST]),
                        t_ed=coord(row[dr.C_TED]), q_st=coord(row[dr.C_QST]),
                        q_ed=coord(row[dr.C_QED]), indel=int(row[dr.C_INDEL]),
                        chain_id=ci, chain_anchor_cur=None))
                res.chains = chains
                rl = int(rl_arr[k])
                if res.chains and post_finish_native(self.idx, res.chains,
                                                     rl, self.state,
                                                     self.opts):
                    continue
                if res.chains:
                    post_rescore_finish(res.chains, rl, self.state, self.opts)
                detect_primary(res.chains, rl)
            return results

        return _finish

    def classify_file(self, path):
        """Ordered read -> classify -> emit pipeline (the analogue of the
        reference's 3-stage kt_pipeline, src/lib/kthread.c:157-197): a
        reader thread parses/encodes batch N+1 while batch N classifies;
        results drain in input order."""
        import queue
        import threading

        from ...io.fastx import read_fastx_fast as read_fastx

        q: "queue.Queue" = queue.Queue(maxsize=2)

        def reader():
            batch = []
            try:
                for rec in read_fastx(path):
                    batch.append(rec)
                    if len(batch) >= self.batch_size:
                        q.put(batch)
                        batch = []
                if batch:
                    q.put(batch)
                q.put(None)
            except BaseException as e:  # surface parse errors in order
                q.put(e)

        from concurrent.futures import ThreadPoolExecutor

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        with ThreadPoolExecutor(max_workers=1) as ex:
            prev = None          # (batch, prep future) one batch ahead
            while True:
                item = q.get()
                if isinstance(item, BaseException):
                    raise item
                nxt = None
                if item is not None:
                    nxt = (item, ex.submit(self._prep_batch, item))
                if prev is not None:
                    b, f = prev
                    yield from self._classify_batch(b, f.result())
                prev = nxt
                if item is None:
                    break
        t.join()
