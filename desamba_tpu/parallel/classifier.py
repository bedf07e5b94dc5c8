"""MeshClassifier: the full classify pipeline on a jax.sharding.Mesh.

The reference scales by pthreads over reads with the index in shared
memory (src/lib/kthread.c:32-57); the device mapping is a 2-D mesh:

  dp  — reads. Every per-lane kernel (existence probe, ladders, M2
        chaining, rescore prep, rescore VM) runs under `shard_map` with
        its lane/batch axes split over dp. Each device iterates its own
        while_loops over its own lanes — no cross-device lockstep, so dp
        scaling is embarrassingly parallel per batch.
  idx — index memory. The existence-filter bit tables are sharded by
        address range: probes are computed everywhere, answered by the
        owning shard, and OR-merged with a psum over NVLink (the pattern
        for holding the RefSeq-"all" 69 GB index across cards, the
        reference README.md:50). The gather tables used inside the
        sequential FM walks (fm_blocks, lfc, hash13, ref_bin) are
        replicated at viral scale; sharding them uses the same
        ownership-mask+psum per gather.

Layout contract with DeviceClassifier (which this subclasses):
  - batch rows and ladder lanes are padded to multiples of n_dp
    (power-of-two buckets guarantee this for power-of-two meshes);
  - ladder packs are per-shard: the host globalizes pack offsets
    (shard stride = pack_cap // n_dp) before building gather maps;
  - chain_step consumes the pack replicated (GSPMD all-gathers the
    dp-sharded ladder output at the jit boundary — the pack is a few
    hundred KB).

Placement today: the engine is built on top of a single-card
DeviceClassifier, so the default device keeps the whole DeviceIndex, and
shard_index replicates the FM tables to every device; only the tables
that sharded_tables() names are split over ``idx``.

One thread dispatches (classify_reads / classify_file below): programs
that span several devices, enqueued from two threads, can reach the
devices in different orders and deadlock their collectives.

Bit-parity with the single-device engine is asserted by
tests/test_mesh_classifier.py on an 8-device CPU mesh;
`chip_smoke.py --four` is the same check on four GPUs.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..engine.device import chain as dc
from ..engine.device import rescore as drr
from ..engine.device.classifier import A_CAP, M_CAP, DeviceClassifier
from ..engine.device.islands import ekmer_probe_indices
from ..engine.device.ladder import IV_HOT, fast_ladder, slow_ladder
from .mesh import make_mesh, shard_index


class MeshClassifier(DeviceClassifier):
    def __init__(self, idx, opts=None, mesh=None, batch_size: int = 2048,
                 shard_full: bool = False):
        """shard_full=True splits the large gather tables the ladders
        and the rescore read (FM blocks, hash13, packed text/ref, REF_POS
        fan-out, ...) by row range over ``idx``; their gathers are
        answered with ownership-mask + psum (parallel/sharded.py). This
        is the layout meant for indexes beyond one card's memory (the
        reference's 69 GB RefSeq-"all" envelope, its README.md:50), but
        it does not reach that yet: the single-card DeviceIndex still
        sits whole on the default device and shard_index replicates the
        FM tables to every device. Off (default), only the
        existence-filter bit tables shard (viral-scale layout)."""
        super().__init__(idx, opts, batch_size=batch_size)
        self.mesh = mesh if mesh is not None else make_mesh(
            len(jax.devices()), 1)
        self.n_dp = self.mesh.shape["dp"]
        self.n_idx = self.mesh.shape["idx"]
        if self.n_dp & (self.n_dp - 1):
            raise ValueError("dp size must be a power of two (bucketed "
                             "shapes guarantee divisibility only then)")
        self.placed = shard_index(self.mesh, self.dix)
        self.shard_full = shard_full
        if shard_full:
            from . import sharded as sh

            fields = type(self.ixr)._fields
            self._sh_fields = [f for f in fields[:18]
                               if f in sh.SHARDED_IXR_FIELDS]
            placed, gshapes = [], []
            for f in self._sh_fields:
                p, g = sh.shard_table(self.mesh, getattr(self.ixr, f))
                placed.append(p)
                gshapes.append(g)
            self._sh_ixr = tuple(placed)
            self._sh_ixr_shapes = tuple(gshapes)
            self._sh_fm, self._sh_fm_shape = sh.shard_table(
                self.mesh, self.dix.fm_blocks)
            self._sh_h13, self._sh_h13_shape = sh.shard_table(
                self.mesh, self.dix.hash13)
            self._sh_ref, self._sh_ref_shape = sh.shard_table(
                self.mesh, self.dix.ref_bin)
        self._cache = {}

    def _wrap_ixr(self, shard_tup, ref_off):
        """Inside a shard_map body: rebuild IndexRefs over this device's
        shards (ShardedArray leaves gather via mask+psum)."""
        from . import sharded as sh

        vals = dict(zip(self._sh_fields,
                        (sh.wrap_local(s, g) for s, g in
                         zip(shard_tup, self._sh_ixr_shapes))))
        vals["ref_off"] = ref_off
        return type(self.ixr)(
            **vals, text_len=self.ixr.text_len, n_uni=self.ixr.n_uni,
            n_bases=self.ixr.n_bases)

    def sharded_tables(self) -> dict:
        """The placed tables that are row-sharded over ``idx``, by name."""
        tabs = {"ekmer0": self.placed["ekmer0"],
                "ekmer1": self.placed["ekmer1"]}
        if self.shard_full:
            tabs.update(zip(self._sh_fields, self._sh_ixr))
            tabs.update(fm_blocks=self._sh_fm, hash13=self._sh_h13,
                        ref_bin=self._sh_ref)
        return tabs

    # ---- dispatch from one thread ------------------------------------------
    def classify_reads(self, recs):
        for i in range(0, len(recs), self.batch_size):
            yield from self._classify_batch(recs[i : i + self.batch_size])

    def classify_file(self, path):
        from ..io.fastx import read_fastx_fast

        batch = []
        for rec in read_fastx_fast(path):
            batch.append(rec)
            if len(batch) == self.batch_size:
                yield from self._classify_batch(batch)
                batch = []
        if batch:
            yield from self._classify_batch(batch)

    # ---- sharded kernels --------------------------------------------------
    def _k_bloom(self, strands, lens):
        key = ("bloom", strands.shape)
        if key not in self._cache:
            l_ek = self.idx.len_e_kmer
            sbm = self.idx.single_base_max
            mask_bits = self.dix.mask_bits
            n_idx = self.n_idx
            shard_len = self.placed["ekmer0"].shape[0] // n_idx

            def step(ek0, ek1, strands, lens):
                b1, s1, b2, s2, valid = ekmer_probe_indices(
                    strands, lens, l_ek, sbm, mask_bits)
                me = jax.lax.axis_index("idx") * shard_len

                def probe(tab, byte_idx, shift):
                    local = byte_idx - me
                    own = (local >= 0) & (local < shard_len)
                    byte = tab[jnp.clip(local, 0, shard_len - 1)]
                    return jnp.where(own, (byte >> shift) & 1,
                                     0).astype(jnp.int32)

                hit1 = jax.lax.psum(probe(ek0, b1, s1), "idx")
                hit2 = jax.lax.psum(probe(ek1, b2, s2), "idx")
                hit = (hit1 > 0) & (hit2 > 0) & valid
                pad = (-hit.shape[1]) % 8
                hitp = jnp.pad(hit, ((0, 0), (0, pad)))
                # flat row-major, as _bloom_packed (per-dp-shard rows
                # concatenate to the global row-major order)
                return jnp.packbits(hitp, axis=1).reshape(-1)

            self._cache[key] = jax.jit(jax.shard_map(
                step, mesh=self.mesh,
                in_specs=(P("idx"), P("idx"), P("dp"), P("dp")),
                out_specs=P("dp"), check_vma=False))
        return self._cache[key](self.placed["ekmer0"], self.placed["ekmer1"],
                                strands, lens)

    def _k_ladder(self, kind, codes_fr, buf_len, pre13, lane_args, NB,
                  iv_cap=IV_HOT):
        l_ek = self.idx.len_e_kmer
        bl = min(128, NB // self.n_dp)
        pack_local = 2 * NB // self.n_dp
        key = ("ladder", kind, NB, codes_fr.shape, iv_cap)
        if key not in self._cache:
            if kind == "fast":
                fn = functools.partial(
                    fast_ladder.__wrapped__, l_ek=l_ek, a_cap=A_CAP,
                    pack_cap=pack_local, bl=bl, iv_cap=iv_cap)
            else:
                fn = functools.partial(
                    slow_ladder.__wrapped__, l_ek=l_ek, a_cap=A_CAP,
                    m_cap=M_CAP, pack_cap=pack_local, bl=bl, iv_cap=iv_cap)

            if self.shard_full:
                def step(sh_tup, ref_off, fm_flat, rank6, h13_flat,
                         codes, blen, pre, q_mem, q_lv, lanes):
                    from . import sharded as sh

                    ixr = self._wrap_ixr(sh_tup, ref_off)
                    fm = sh.wrap_local(fm_flat, self._sh_fm_shape)
                    h13 = sh.wrap_local(h13_flat, self._sh_h13_shape)
                    packed, info, povf = fn(ixr, fm, rank6, h13, codes,
                                            blen, pre, q_mem, q_lv, lanes)
                    return packed, info, povf.reshape(1)

                n_sh = len(self._sh_fields)
                self._cache[key] = jax.jit(jax.shard_map(
                    step, mesh=self.mesh,
                    in_specs=((P("idx"),) * n_sh, P(), P("idx"), P(),
                              P("idx"), P(), P(), P(), P(), P(),
                              P(None, "dp")),
                    out_specs=(P("dp"),) * 3, check_vma=False))
            else:
                def step(ixr, fm_blocks, rank6, hash13, codes, blen, pre,
                         q_mem, q_lv, lanes):
                    packed, info, povf = fn(ixr, fm_blocks, rank6, hash13,
                                            codes, blen, pre, q_mem, q_lv,
                                            lanes)
                    return packed, info, povf.reshape(1)

                # reads are replicated for the ladders (lanes of one read
                # may land on any shard); lane columns split over dp
                self._cache[key] = jax.jit(jax.shard_map(
                    step, mesh=self.mesh,
                    in_specs=(P(), P(), P(), P(), P(), P(), P(), P(), P(),
                              P(None, "dp")),
                    out_specs=(P("dp"),) * 3, check_vma=False))
        dix = self.dix
        if self.shard_full:
            return self._cache[key](self._sh_ixr, self.ixr.ref_off,
                                    self._sh_fm, dix.rank, self._sh_h13,
                                    codes_fr, buf_len, pre13,
                                    dix.q_mem, dix.q_lv, lane_args)
        return self._cache[key](self.ixr, dix.fm_blocks, dix.rank,
                                dix.hash13, codes_fr, buf_len, pre13,
                                dix.q_mem, dix.q_lv, lane_args)

    def _pack_cap_local(self, NB):
        # per-shard pack capacity (base offsets are shard-local before
        # _globalize_base)
        return 2 * NB // self.n_dp

    def _globalize_base(self, base, NB):
        shard = np.arange(len(base)) // (NB // self.n_dp)
        return base + shard[: len(base)] * (2 * NB // self.n_dp)

    def _k_chain(self, packed, gidx, nanc):
        key = ("chain", packed.shape, gidx.shape)
        if key not in self._cache:
            # pack replicated (GSPMD all-gathers the dp-sharded ladder
            # output at the boundary); reads split over dp
            self._cache[key] = jax.jit(jax.shard_map(
                dc.chain_step.__wrapped__, mesh=self.mesh,
                in_specs=(P(), P("dp"), P("dp")),
                out_specs=(P("dp"),) * 6, check_vma=False))
        return self._cache[key](packed, jnp.asarray(gidx),
                                jnp.asarray(nanc))

    def _k_prep(self, sel, chs3, ns3, pre3, anc3):
        key = ("prep", chs3.shape)
        if key not in self._cache:
            self._cache[key] = jax.jit(jax.shard_map(
                dc.prep_rescore.__wrapped__, mesh=self.mesh,
                in_specs=(P("dp"), P(None, "dp"), P(None, "dp"),
                          P(None, "dp"), P(None, "dp")),
                out_specs=(P("dp"),) * 6, check_vma=False))
        return self._cache[key](jnp.asarray(sel), chs3, ns3, pre3, anc3)

    def _k_rescore(self, inp):
        dix = self.dix
        B_loc = inp.n_chains.shape[0] // self.n_dp
        key = ("rescore", inp.n_chains.shape[0], inp.codes_fr.shape)
        if key not in self._cache:
            fn = functools.partial(
                drr.rescore_kernel.__wrapped__, n_bases=dix.n_bases,
                bf=max(64, B_loc // 13 // 32 * 32),
                bp=max(64, B_loc // 10 // 32 * 32), pp=8)

            if self.shard_full:
                def step(inp, ref_flat, ref_off, ref_len_arr):
                    from . import sharded as sh

                    ref_bin = sh.wrap_local(ref_flat, self._sh_ref_shape)
                    ch, fb, reason, iters = fn(inp, ref_bin, ref_off,
                                               ref_len_arr)
                    return ch, fb, reason, iters.reshape(1)

                self._cache[key] = jax.jit(jax.shard_map(
                    step, mesh=self.mesh,
                    in_specs=(drr.RescoreIn(*([P("dp")] * 8)), P("idx"),
                              P(), P()),
                    out_specs=(P("dp"),) * 4, check_vma=False))
                return self._cache[key](inp, self._sh_ref, dix.ref_off,
                                        dix.ref_len_arr)

            def step(inp, ref_bin, ref_off, ref_len_arr):
                ch, fb, reason, iters = fn(inp, ref_bin, ref_off,
                                           ref_len_arr)
                return ch, fb, reason, iters.reshape(1)  # per-shard iters

            self._cache[key] = jax.jit(jax.shard_map(
                step, mesh=self.mesh,
                in_specs=(drr.RescoreIn(*([P("dp")] * 8)), P(), P(), P()),
                out_specs=(P("dp"),) * 4, check_vma=False))
        if self.shard_full:
            return self._cache[key](inp, self._sh_ref, dix.ref_off,
                                    dix.ref_len_arr)
        return self._cache[key](inp, dix.ref_bin, dix.ref_off,
                                dix.ref_len_arr)
