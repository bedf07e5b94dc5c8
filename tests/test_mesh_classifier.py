"""Full-pipeline mesh classifier == single-device engine, bit-exact.

Runs on the 8-virtual-CPU-device mesh from conftest (dp=4 x idx=2):
existence probe answered by idx shards + psum, ladders/chaining/rescore
dp-sharded via shard_map.
"""
import numpy as np
import pytest


@pytest.fixture(scope="module")
def noisy_reads(small_my_index):
    from desamba_tpu.engine.gold.mapseed import get_ref

    idx = small_my_index
    rng = np.random.default_rng(17)
    total = int(idx.ref_off[-1] + idx.ref_len[-1])
    reads = []
    comp = {0: 3, 1: 2, 2: 1, 3: 0}
    for k in range(48):
        ln = int(rng.integers(150, 900))
        st = int(rng.integers(0, total - ln))
        seq = get_ref(idx.ref_bin, st, ln, True).copy()
        pos = rng.integers(0, ln, size=ln // 12)
        seq[pos] = (seq[pos] + rng.integers(1, 4, size=len(pos))) % 4
        s = "".join("ACGT"[c] for c in seq)
        if k % 3 == 1:
            s = "".join("ACGT"[comp[c]] for c in seq[::-1])
        if k % 7 == 0:
            s = s[:40]  # below MIN_READ_LEN -> unclassified path
        reads.append((f"r{k}", s))
    return reads


def test_mesh_full_pipeline_parity(small_my_index, noisy_reads):
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")

    from desamba_tpu.engine.device.classifier import DeviceClassifier
    from desamba_tpu.engine.gold.classify import Options
    from desamba_tpu.io.fastx import Record
    from desamba_tpu.io.sam import format_result
    from desamba_tpu.parallel.classifier import MeshClassifier
    from desamba_tpu.parallel.mesh import make_mesh

    recs = [Record(n, "", s) for n, s in noisy_reads]
    single = DeviceClassifier(small_my_index, Options())
    exp = [format_result(r, small_my_index.ref_name, single.opts)
           for r in single.classify_reads(recs)]

    mesh = make_mesh(4, 2)
    eng = MeshClassifier(small_my_index, Options(), mesh=mesh)
    got = [format_result(r, small_my_index.ref_name, eng.opts)
           for r in eng.classify_reads(recs)]
    assert got == exp


def test_mesh_dispatches_from_one_thread(small_my_index, noisy_reads,
                                         tmp_path):
    """classify_file on a mesh runs every device stage on the calling
    thread, over several batches, and still equals the single-device
    engine."""
    import threading

    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")

    from desamba_tpu.engine.device.classifier import DeviceClassifier
    from desamba_tpu.engine.gold.classify import Options
    from desamba_tpu.io.sam import format_result
    from desamba_tpu.parallel.classifier import MeshClassifier
    from desamba_tpu.parallel.mesh import make_mesh

    fq = tmp_path / "reads.fq"
    fq.write_text("".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n"
                          for n, s in noisy_reads))
    single = DeviceClassifier(small_my_index, Options(), batch_size=16)
    exp = [format_result(r, small_my_index.ref_name, single.opts)
           for r in single.classify_file(str(fq))]

    eng = MeshClassifier(small_my_index, Options(), mesh=make_mesh(4, 2),
                         batch_size=16)
    seen = set()
    for name in ("_k_bloom", "_k_ladder", "_k_chain", "_k_prep",
                 "_k_rescore"):
        def spy(*a, _k=getattr(eng, name), **kw):
            seen.add(threading.get_ident())
            return _k(*a, **kw)

        setattr(eng, name, spy)
    got = [format_result(r, small_my_index.ref_name, eng.opts)
           for r in eng.classify_file(str(fq))]
    assert seen == {threading.get_ident()}
    assert got == exp
    assert len(got) == len(noisy_reads) > 2 * eng.batch_size
