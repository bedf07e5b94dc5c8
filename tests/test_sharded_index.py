"""Fully-sharded index classify == single-device engine, bit-exact.

VERDICT r2 item 2: no device may hold a full copy of ANY index array.
A dp=2 x idx=4 CPU mesh shards every gather table (FM blocks, hash13,
full SA, packed text/ref, REF_POS fan-out, unitig tables) by row range;
gathers inside the classify kernels are answered with ownership-mask +
psum (parallel/sharded.py).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")


def test_sharded_array_getitem_matches_global():
    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual multi-device CPU mesh")
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from desamba_tpu.parallel.mesh import make_mesh
    from desamba_tpu.parallel.sharded import shard_table, wrap_local

    mesh = make_mesh(1, 4)
    rng = np.random.default_rng(3)
    glob = rng.integers(0, 1 << 30, size=103, dtype=np.int64)
    placed, gshape = shard_table(mesh, glob)
    idx = rng.integers(0, 103, size=(7, 5)).astype(np.int32)

    def step(flat, i):
        return wrap_local(flat, gshape)[i]

    got = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(P("idx"), P()),
                                out_specs=P(), check_vma=False))(
        placed, jnp.asarray(idx))
    np.testing.assert_array_equal(np.asarray(got), glob[idx])


def test_sharded_full_pipeline_parity(small_my_index):
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")

    from desamba_tpu.engine.device.classifier import DeviceClassifier
    from desamba_tpu.engine.gold.classify import Options
    from desamba_tpu.engine.gold.mapseed import get_ref
    from desamba_tpu.io.fastx import Record
    from desamba_tpu.io.sam import format_result
    from desamba_tpu.parallel.classifier import MeshClassifier
    from desamba_tpu.parallel.mesh import make_mesh

    idx = small_my_index
    rng = np.random.default_rng(11)
    total = int(idx.ref_off[-1] + idx.ref_len[-1])
    comp = {0: 3, 1: 2, 2: 1, 3: 0}
    recs = []
    for k in range(24):
        ln = int(rng.integers(150, 700))
        st = int(rng.integers(0, total - ln))
        seq = get_ref(idx.ref_bin, st, ln, True).copy()
        pos = rng.integers(0, ln, size=ln // 12)
        seq[pos] = (seq[pos] + rng.integers(1, 4, size=len(pos))) % 4
        s = "".join("ACGT"[c] for c in seq)
        if k % 3 == 1:
            s = "".join("ACGT"[comp[c]] for c in seq[::-1])
        if k % 7 == 0:
            s = s[:40]
        recs.append(Record(f"r{k}", "", s))

    single = DeviceClassifier(idx, Options())
    exp = [format_result(r, idx.ref_name, single.opts)
           for r in single.classify_reads(recs)]

    mesh = make_mesh(2, 4)
    eng = MeshClassifier(idx, Options(), mesh=mesh, shard_full=True)
    # no device holds a full copy of any sharded table
    for placed in (*eng._sh_ixr, eng._sh_fm, eng._sh_h13, eng._sh_ref):
        for s in placed.addressable_shards:
            assert s.data.size < placed.size or placed.size < 4
    got = [format_result(r, idx.ref_name, eng.opts)
           for r in eng.classify_reads(recs)]
    assert got == exp
