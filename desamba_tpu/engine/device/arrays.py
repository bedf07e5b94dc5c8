"""DeviceIndex: device-resident gather tables derived from IndexData.

Layout choices (batched gathers first, see DESIGN.md):
  - fm_blocks: (n_blocks, 9) uint32 — per 32 BWT rows: 5 cumulative char
    counts + 32 chars packed 4-bit (nibble k of word k>>3). Batched rank =
    one 9-word row gather + vectorized nibble counting, vs the reference's
    168-byte block + 16-bit popcount tables (src/bwt.c:43-65).
  - lf: uint32[n_rows] — precomputed LF step for each row's own char; the
    reference recomputes this per step with two table walks (occ + rank).
  - row_pos: int32[n_rows] — full SA (text position per row): seed location
    is a single gather, replacing the reference's LF-walk to sparse SA
    samples (src/cly.c:737-760).
  - hash13: uint32[2^26+1] — 13-mer -> row interval starts.
  - ekmer0/1: uint8 bit tables for the existence filter.
  - position-space walk tables (round 3): the unitig text itself, packed
    2-bit (text_pk) with '#'/'$' bitmaps, the inverse SA (isa: text
    position -> BWT row), a sampled-position bitmap and a direct
    position -> unitig map. These replace the reference's sequential
    LF-walks (src/cly.c:1344-1383, 706-760) with O(1) packed-word
    gathers + vector compares: a walk of w matching chars costs ~w/16
    word gathers instead of w dependent row gathers.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

BLOCK = 32  # rows per rank checkpoint


@dataclasses.dataclass
class DeviceIndex:
    fm_blocks: jnp.ndarray   # (n_blocks, 9) uint32
    lf: jnp.ndarray          # (n_rows,) uint32
    lfc: jnp.ndarray         # (n_rows,) uint32: (lf << 3) | char
    row_char: jnp.ndarray    # (n_rows,) uint8
    row_pos: jnp.ndarray     # (n_rows,) int32
    hash13: jnp.ndarray      # (2^26+1,) uint32
    rank: jnp.ndarray        # (6,) uint32
    ekmer0: jnp.ndarray
    ekmer1: jnp.ndarray
    # locate / anchor fan-out tables (engine/device/mapseed.py)
    uni_start: jnp.ndarray   # (n_uni + 1,) int32 text start per unitig
    uni_len: jnp.ndarray     # (n_uni + 1,) int32
    uni_ref_list: jnp.ndarray  # (n_uni + 1,) int32 CSR into rp_*
    rp_global_off: jnp.ndarray  # (n_occ,) int32
    rp_ref_id: jnp.ndarray   # (n_occ,) int32
    ref_off: jnp.ndarray     # (n_ref,) int32
    ref_len_arr: jnp.ndarray  # (n_ref,) int32
    ref_bin: jnp.ndarray     # packed 2-bit reference, uint8
    q_mem: jnp.ndarray       # (Q_MEM_MAX,) int32 MAPQ tables
    q_lv: jnp.ndarray        # (20, 20) int32
    # position-space walk tables
    ref_pk: jnp.ndarray      # (1, ceil(n_bases/16)) uint32 packed 2-bit ref
    text_pk: jnp.ndarray     # (1, ceil(L/16)) uint32 packed 2-bit text
    sep_any: jnp.ndarray     # (ceil(L/32),) uint32: bit q = text[q] >= 4
    sep_hash: jnp.ndarray    # (ceil(L/32),) uint32: bit q = text[q] == '#'
    samp_bits: jnp.ndarray   # (ceil(L/32),) uint32: bit q = isa[q] % 8 == 0
    isa: jnp.ndarray         # (L,) int32: text position -> BWT row
    pos2uni: jnp.ndarray     # (L,) int32: position -> unitig (searchsorted)
    n_rows: int
    dollar_pos: int
    len_e_kmer: int
    single_base_max: int
    mask_bits: int
    text_len: int
    n_uni: int
    n_bases: int

    def index_refs(self):
        from .mapseed import IndexRefs

        return IndexRefs(
            lf=self.lf, lfc=self.lfc, row_char=self.row_char,
            row_pos=self.row_pos,
            uni_start=self.uni_start, uni_len=self.uni_len,
            uni_ref_list=self.uni_ref_list,
            rp_global_off=self.rp_global_off, rp_ref_id=self.rp_ref_id,
            ref_off=self.ref_off, ref_bin=self.ref_bin,
            ref_pk=self.ref_pk,
            text_pk=self.text_pk, sep_any=self.sep_any,
            sep_hash=self.sep_hash, samp_bits=self.samp_bits,
            isa=self.isa, pos2uni=self.pos2uni,
            text_len=self.text_len, n_uni=self.n_uni, n_bases=self.n_bases)

    @classmethod
    def build(cls, idx) -> "DeviceIndex":
        chars = idx.row_char
        n = len(chars)
        n_blocks = (n + BLOCK - 1) // BLOCK
        blocks = np.zeros((n_blocks, 9), dtype=np.uint32)
        counts = np.zeros((5, n + 1), dtype=np.int64)
        for c in range(5):
            np.cumsum(chars == c, out=counts[c, 1:])
        for c in range(5):
            blocks[:, c] = counts[c, : n_blocks * BLOCK : BLOCK].astype(np.uint32)
        padded = np.concatenate(
            [chars, np.full(n_blocks * BLOCK - n, 0xF, dtype=np.uint8)])
        nib = padded.reshape(n_blocks, 4, 8).astype(np.uint32)
        words = np.zeros((n_blocks, 4), dtype=np.uint32)
        for k in range(8):
            words |= nib[:, :, k] << np.uint32(4 * k)
        blocks[:, 5:9] = words

        occ = counts  # alias
        rank = np.zeros(6, dtype=np.uint32)
        rank[:] = idx.rank.astype(np.uint64) & 0xFFFFFFFF
        # LF for each row's own char (occ + rank, '$' handled like occ():
        # returns DOLLOR_POS then callers add rank[5], src/bwt.c:55)
        cidx = np.minimum(chars, 4).astype(np.int64)
        lf = occ[cidx, np.arange(n)] + idx.rank[cidx]
        dollar = chars == 5
        lf[dollar] = idx.dollar_pos + idx.rank[5]
        from ..gold.mapq import mapq_tables

        q_mem, q_lv = mapq_tables(len(idx.ref_bin) * 4)
        assert n < (1 << 28), "lfc packing needs n_rows < 2^28 (shard larger indexes)"

        # ---- position-space walk tables -------------------------------
        # Every 31-mer occurs once in the unitig set, so row_pos is a
        # bijection rows <-> text positions (full SA; asserted here).
        # text[q] is the char each row's LF step would read:
        # row_char[r] = text[(row_pos[r]-1) mod L].
        L = int(idx.text_len)
        assert L == n, "full-SA position tables need n_rows == text_len"
        pos = idx.row_pos.astype(np.int64)
        text = np.zeros(L, np.uint8)
        text[(pos - 1) % L] = chars
        isa = np.zeros(L, np.int32)
        isa[pos] = np.arange(n, dtype=np.int32)

        def bitmap32(mask):
            W = (L + 31) // 32
            m = np.zeros(W * 32, np.uint32)
            m[:L] = mask
            return (m.reshape(W, 32)
                    << np.arange(32, dtype=np.uint32)[None, :]).sum(
                        axis=1, dtype=np.uint32)

        def pack16(ch):
            n_ch = len(ch)
            Wp = (n_ch + 15) // 16
            tp = np.zeros(Wp * 16, np.uint32)
            tp[:n_ch] = ch
            return (tp.reshape(Wp, 16)
                    << (np.arange(16, dtype=np.uint32) * 2)[None, :]).sum(
                        axis=1, dtype=np.uint32)[None, :]

        text_pk = pack16(text & 3)
        # reference chars, same packed layout (MSB-first nibble order in
        # ref_bin bytes -> little-endian char order in words)
        rb = idx.ref_bin
        ref_chars = np.empty(len(rb) * 4, np.uint8)
        for j, sh in enumerate((6, 4, 2, 0)):
            ref_chars[j::4] = (rb >> sh) & 3
        ref_pk = pack16(ref_chars)
        del ref_chars
        # pos -> unitig: count of unitig starts <= q (get_uni's searchsorted)
        bounds = np.concatenate([
            [0], idx.uni_start[1 : idx.n_uni + 1].astype(np.int64), [L]])
        pos2uni = np.repeat(
            np.arange(idx.n_uni + 1, dtype=np.int32), np.diff(bounds))
        return cls(
            fm_blocks=jnp.asarray(blocks),
            lf=jnp.asarray(lf.astype(np.uint32)),
            lfc=jnp.asarray(((lf.astype(np.uint32) << 3)
                             | chars.astype(np.uint32))),
            row_char=jnp.asarray(chars),
            row_pos=jnp.asarray(idx.row_pos.astype(np.int32)),
            hash13=jnp.asarray(idx.hash13.astype(np.uint32)),
            rank=jnp.asarray(rank),
            ekmer0=jnp.asarray(idx.ekmer0),
            ekmer1=jnp.asarray(idx.ekmer1),
            uni_start=jnp.asarray(idx.uni_start[: idx.n_uni + 1].astype(np.int32)),
            uni_len=jnp.asarray(idx.uni_len[: idx.n_uni + 1].astype(np.int32)),
            uni_ref_list=jnp.asarray(
                idx.uni_ref_list[: idx.n_uni + 1].astype(np.int32)),
            rp_global_off=jnp.asarray(idx.rp_global_off.astype(np.int32)),
            rp_ref_id=jnp.asarray(idx.rp_ref_id.astype(np.int32)),
            ref_off=jnp.asarray(idx.ref_off.astype(np.int32)),
            ref_len_arr=jnp.asarray(idx.ref_len.astype(np.int32)),
            ref_bin=jnp.asarray(idx.ref_bin),
            q_mem=jnp.asarray(q_mem.astype(np.int32)),
            q_lv=jnp.asarray(q_lv.astype(np.int32)),
            ref_pk=jnp.asarray(ref_pk),
            text_pk=jnp.asarray(text_pk),
            sep_any=jnp.asarray(bitmap32(text >= 4)),
            sep_hash=jnp.asarray(bitmap32(text == 4)),
            samp_bits=jnp.asarray(bitmap32(isa % 8 == 0)),
            isa=jnp.asarray(isa),
            pos2uni=jnp.asarray(pos2uni),
            n_rows=n,
            dollar_pos=idx.dollar_pos,
            len_e_kmer=idx.len_e_kmer,
            single_base_max=idx.single_base_max,
            mask_bits=int(idx.e_hash_mask).bit_length(),
            text_len=int(idx.text_len),
            n_uni=int(idx.n_uni),
            n_bases=len(idx.ref_bin) * 4,
        )
