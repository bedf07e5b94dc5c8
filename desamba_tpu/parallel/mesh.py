"""Device mesh + sharded classify step.

The reference is single-host shared-memory (SURVEY §2.2): pthreads data
parallelism over reads, index fully replicated in RAM. The device
scale-out maps those axes onto a 2-D `jax.sharding.Mesh`:

  - ``dp``  — data parallelism over reads (the analogue of `kt_for` over
    read batches, src/lib/kthread.c:32-57). Read batches are sharded;
    every device classifies its own reads end to end.
  - ``idx`` — index-model parallelism (the analogue of sharding the 69 GB
    RefSeq-"all" index across hosts, BASELINE.md north star). The
    existence-filter bit tables are sharded by address range; probes are
    computed everywhere, answered by the owning shard, and OR-merged with
    a ``psum`` over the device links (NVLink between the cards of one
    host, all to all, so the mesh shape follows the algorithm).

At viral scale (test/demo) the FM arrays are replicated per device and
only the Bloom tables are sharded; the full FM shard-by-row-range path
uses the same ownership-mask + psum pattern.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..constants import (
    L_PRE_IDX,
    MEM_SEARCH_FAST,
    MIN_MEM_LEN_FAST,
    PRE_IDX_MASK,
    STEP_EK,
)
from ..engine.device import fm as dev_fm
from ..engine.device.islands import ekmer_probe_indices
from ..engine.device.textwalk import pack2


def make_mesh(n_dp: int, n_idx: int = 1, devices=None) -> Mesh:
    devices = list(jax.devices() if devices is None else devices)
    need = n_dp * n_idx
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.array(devices[:need]).reshape(n_dp, n_idx)
    return Mesh(arr, ("dp", "idx"))


def shard_index(mesh: Mesh, dix):
    """Place DeviceIndex arrays on the mesh.

    Bloom tables are sharded along ``idx`` (address-range ownership); all
    other gather tables are replicated (viral scale). Returns a dict of
    placed arrays.
    """
    repl = NamedSharding(mesh, P())
    shard0 = NamedSharding(mesh, P("idx"))
    placed = {
        "fm_blocks": jax.device_put(dix.fm_blocks, repl),
        "lfc": jax.device_put(dix.lfc, repl),
        "rank": jax.device_put(dix.rank, repl),
        "hash13": jax.device_put(dix.hash13, repl),
        "ekmer0": jax.device_put(dix.ekmer0, shard0),
        "ekmer1": jax.device_put(dix.ekmer1, shard0),
        "walk": jax.device_put(
            dev_fm.WalkRefs(row_pos=dix.row_pos, text_pk=dix.text_pk,
                            sep_any=dix.sep_any, samp_bits=dix.samp_bits,
                            isa=dix.isa), repl),
    }
    return placed


def sharded_seed_step(mesh: Mesh, placed, l_ek: int, single_base_max: int,
                      mask_bits: int, n_probes: int = 8):
    """Build the jitted sharded seeding step.

    step(codes, lengths) -> (hit_counts, mem_len, mem_valid):
      codes (B, L) uint8 sharded over dp; existence probes answered by the
      owning ``idx`` shard and OR-merged via psum; the first `n_probes`
      hit positions per read are FM MEM-probed (fast-mode parameters).
    """
    n_idx = mesh.shape["idx"]
    table_len = placed["ekmer0"].shape[0]
    shard_len = table_len // n_idx

    def step(walk, fm_blocks, lfc, rank6, hash13, ek0, ek1, codes, lengths):
        b1, s1, b2, s2, valid = ekmer_probe_indices(
            codes, lengths, l_ek, single_base_max, mask_bits)
        me = jax.lax.axis_index("idx") * shard_len

        def probe(tab, byte_idx, shift):
            local = byte_idx - me
            own = (local >= 0) & (local < shard_len)
            byte = tab[jnp.clip(local, 0, shard_len - 1)]
            return jnp.where(own, (byte >> shift) & 1, 0).astype(jnp.int32)

        hit1 = jax.lax.psum(probe(ek0, b1, s1), "idx")
        hit2 = jax.lax.psum(probe(ek1, b2, s2), "idx")
        hit = (hit1 > 0) & (hit2 > 0) & valid

        # pick the first n_probes hits, at least STEP_EK apart
        B, n_k = hit.shape
        pos = jnp.arange(n_k, dtype=jnp.int32)[None, :]

        def pick(carry, _):
            taken_after, out_i = carry
            cand = hit & (pos >= taken_after[:, None])
            idx = jnp.argmax(cand, axis=1).astype(jnp.int32)
            ok = jnp.take_along_axis(cand, idx[:, None], axis=1)[:, 0]
            taken_after = jnp.where(ok, idx + STEP_EK, n_k)
            return (taken_after, idx), (idx, ok)

        (_, _), (p_idx, p_ok) = jax.lax.scan(
            pick, (jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32)),
            None, length=n_probes)
        p_idx = p_idx.T  # (B, n_probes)
        p_ok = p_ok.T

        # 13-mer prefix value ending at each probe's last char
        c32 = codes.astype(jnp.uint32)
        pre = jnp.zeros((B, n_k), jnp.uint32)
        for j in range(L_PRE_IDX):
            sh = 2 * (L_PRE_IDX - 1 - j)
            off = l_ek - L_PRE_IDX + j
            pre = pre | (c32[:, off : off + n_k] << sh)
        pre = (pre & jnp.uint32(PRE_IDX_MASK)).astype(jnp.int32)

        mem_lens = []
        mem_valids = []
        spset, spcount = dev_fm.spset_init(B)
        codes_pk = pack2(codes)
        for k in range(n_probes):
            ki = p_idx[:, k]
            out = dev_fm.mem_probe.__wrapped__(
                walk, fm_blocks, rank6, hash13, codes, codes_pk,
                ki + l_ek - 1, jnp.take_along_axis(pre, ki[:, None], 1)[:, 0],
                p_ok[:, k], spset, spcount,
                MEM_SEARCH_FAST, MIN_MEM_LEN_FAST - 1)
            (res_len, _sp, _sa, _sa_ok, _sa_l, res_valid, spset, spcount) = out
            mem_lens.append(res_len)
            mem_valids.append(res_valid)
        mem_len = jnp.stack(mem_lens, axis=1)      # (B, n_probes, R)
        mem_valid = jnp.stack(mem_valids, axis=1)
        return hit.sum(axis=1), mem_len, mem_valid

    spec_in = (P(), P(), P(), P(), P(), P("idx"), P("idx"), P("dp"),
               P("dp"))
    spec_out = (P("dp"), P("dp"), P("dp"))
    sm = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=spec_in,
                               out_specs=spec_out, check_vma=False))

    def run(codes, lengths):
        # placed arrays are runtime args of the jitted shard_map (passing
        # them via closure would embed them as HLO constants)
        return sm(placed["walk"], placed["fm_blocks"], placed["lfc"],
                  placed["rank"], placed["hash13"], placed["ekmer0"],
                  placed["ekmer1"], codes, lengths)

    return run
