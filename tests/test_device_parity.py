"""Device engine SAM == gold engine SAM on seeded reads over the small
synthetic genome: reads at the tail of the packed reference, noisy
mid-reference reads through the single- and multi-batch paths, repeated
runs, the rescore the classifier picks, and the CLI's device engine; and
the fast pass's skip_next rule on hand-made lanes."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")


class _Rec:
    def __init__(self, i, seq):
        self.name = f"r{i}"
        self.seq = "".join("ACGT"[c] for c in seq)
        self.qual = None


def _reads_from(idx, spans, rng, err):
    """Records copied from reference spans [(start, len)] with
    substitutions at int(len * err) random positions."""
    from desamba_tpu.engine.gold.mapseed import get_ref

    recs = []
    for i, (st, ln) in enumerate(spans):
        seq = get_ref(idx.ref_bin, int(st), int(ln), True).copy()
        nerr = int(ln * err)
        pos = rng.integers(0, ln, size=nerr)
        seq[pos] = (seq[pos] + rng.integers(1, 4, size=nerr)) % 4
        recs.append(_Rec(i, seq))
    return recs


def _mid_reads(idx, n=72, seed=11):
    rng = np.random.default_rng(seed)
    total = int(idx.ref_off[-1] + idx.ref_len[-1])
    spans = [(int(rng.integers(0, total - ln)), ln)
             for ln in rng.integers(250, 900, size=n)]
    return _reads_from(idx, spans, rng, 0.08)


def _gold_sam(idx, recs):
    from desamba_tpu.engine.gold.classify import ClassifyEngine, Options

    return ClassifyEngine(idx, Options()).classify_records_formatted(recs)


def _device_sam(idx, recs, batch_size=2048):
    from desamba_tpu.engine.device.classifier import DeviceClassifier
    from desamba_tpu.engine.gold.classify import Options
    from desamba_tpu.io.sam import format_result

    eng = DeviceClassifier(idx, Options(), batch_size=batch_size)
    out = [format_result(r, idx.ref_name, eng.opts)
           for r in eng.classify_reads(recs)]
    return out, eng


@pytest.mark.parametrize("where", ["inside", "straddling"])
def test_tail_of_reference(small_my_index, where):
    """Reads wholly inside, and straddling the start of, the last
    2,048-char packed row of the reference: the rescore's window fetch
    must clamp at the end of the reference, not a row early."""
    idx = small_my_index
    rng = np.random.default_rng(12)
    total = int(idx.ref_off[-1] + idx.ref_len[-1])
    lens = (300, 400, 500, 600)
    if where == "inside":
        spans = [(total - ln - 5, ln) for ln in lens]
    else:
        spans = [(total - 2048 - ln // 2, ln) for ln in lens]
    recs = _reads_from(idx, spans, rng, 0.05)
    got, eng = _device_sam(idx, recs)
    assert got == _gold_sam(idx, recs)
    assert eng.fallback_stats()["fallback_reads"] == 0


@pytest.mark.parametrize("batch_size", [64, 2048])
def test_mid_reference_noisy_reads(small_my_index, batch_size):
    """batch_size 64 splits the reads into two batches, so the pipelined
    multi-batch path runs; 2048 takes them as one batch."""
    recs = _mid_reads(small_my_index)
    got, _ = _device_sam(small_my_index, recs, batch_size)
    assert got == _gold_sam(small_my_index, recs)


def test_same_sam_from_two_runs(small_my_index):
    """Two engines on the same reads give the same SAM (a scatter whose
    live indices collided would be free to differ between runs)."""
    recs = _mid_reads(small_my_index, n=40, seed=3)
    first, _ = _device_sam(small_my_index, recs, 64)
    second, _ = _device_sam(small_my_index, recs, 64)
    assert first == second == _gold_sam(small_my_index, recs)


def test_rescore_is_the_xla_vm(small_my_index, monkeypatch):
    """The classifier rescores every main batch with the lockstep VM in
    rescore.py; nothing picks another kernel by platform."""
    from desamba_tpu.engine.device import rescore as dr
    from desamba_tpu.engine.device.classifier import DeviceClassifier

    assert not hasattr(DeviceClassifier, "_use_pl")
    rows = []
    vm = dr.rescore_kernel

    def spy(inp, *a, **kw):
        rows.append(inp.n_chains.shape[0])
        return vm(inp, *a, **kw)

    monkeypatch.setattr(dr, "rescore_kernel", spy)
    recs = _mid_reads(small_my_index, n=24, seed=5)
    got, _ = _device_sam(small_my_index, recs, 64)
    assert rows and rows[0] == 64
    assert got == _gold_sam(small_my_index, recs)


def test_cli_device_engine_matches_gold(small_my_index, tmp_path):
    """`classify --engine device` writes the gold engine's SAM."""
    from desamba_tpu import cli
    from desamba_tpu.index.store import save_index

    idx = small_my_index
    save_index(idx, str(tmp_path / "idx"))
    recs = _mid_reads(idx, n=24, seed=8)
    fq = tmp_path / "reads.fq"
    fq.write_text("".join(f"@{r.name}\n{r.seq}\n+\n{'I' * len(r.seq)}\n"
                          for r in recs))
    out = tmp_path / "out.sam"
    cli.main(["classify", str(tmp_path / "idx"), str(fq), "-o", str(out),
              "--engine", "device"])
    assert out.read_text() == "".join(_gold_sam(idx, recs))


@pytest.mark.parametrize("lanes,flags,keep", [
    # (read, direction, seed id) per fast lane, in lane order
    ([(0, 0, 4), (0, 0, 5)], [1, 0], [1, 0]),            # next seed: skipped
    ([(0, 0, 4), (0, 0, 6)], [1, 0], [1, 1]),            # next seed not top
    ([(0, 0, 4), (0, 1, 0)], [1, 0], [1, 1]),            # other direction
    ([(0, 0, 4), (1, 0, 5)], [1, 0], [1, 1]),            # other read
    # a skipped lane's own flag never fires
    ([(0, 0, 1), (0, 0, 2), (0, 0, 3)], [1, 1, 0], [1, 0, 1]),
], ids=["next_seed", "gap", "direction", "read", "alternation"])
def test_skip_next_follows_seed_index(lanes, flags, keep):
    """A fast-pass island scoring > 512 skips the next SEED of its read
    and direction (gold fast_classify), not the next top-seed lane."""
    from desamba_tpu.engine.device.classifier import DeviceClassifier, LaneSet

    a = np.array(lanes, np.int32)
    n = len(a)
    ls = LaneSet(a[:, 0], np.zeros(n, np.int32), np.zeros(n, np.int32),
                 a[:, 1], a[:, 2], np.zeros(n, np.int32),
                 np.zeros(n, np.int32))
    got = DeviceClassifier._keep_with_skip(ls, np.array(flags, bool))
    assert got.tolist() == [bool(k) for k in keep]
