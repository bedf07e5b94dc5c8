"""Differential tests for the repeat-driven branches the demo never hits:

- M3 chaining (>=50 anchors -> sort + sparse DP, src/cly.c:238-349,
  gold/chain.py:100)
- super-repeat occurrence guard in map_seed (>50 occurrences selects all,
  >=1000 returns score 50 with no anchors, src/cly.c:847-887)

The device engine is compared byte-for-byte against the gold engine on
the same repeat-heavy genome (and gold against the reference binary
where it is present), and the instrumented gold engine must actually
take the target code path (no vacuous pass).
"""
import subprocess

import pytest

from conftest import build_reference_index


@pytest.fixture(scope="module")
def repeat_genome(tmp_path_factory):
    """~300kb synthetic genome with a 60x and an 1100x repeat unit
    (desamba_tpu/corpus.py)."""
    from desamba_tpu.corpus import repeat_genome as make

    fa = tmp_path_factory.mktemp("repgen") / "repeat.fa"
    unit_a, unit_b = make(str(fa))
    return fa, unit_a, unit_b


@pytest.fixture(scope="module")
def repeat_reads(repeat_genome, tmp_path_factory):
    """Reads crafted to hit the branches + noisy background reads."""
    from desamba_tpu.corpus import repeat_reads as make

    fq = tmp_path_factory.mktemp("repreads") / "reads.fq"
    return fq, make(str(fq), *repeat_genome[1:])


@pytest.fixture(scope="module")
def repeat_ref_index(reference_binary, repeat_genome, tmp_path_factory):
    out = tmp_path_factory.mktemp("repidx_ref")
    build_reference_index(reference_binary, repeat_genome[0], out)
    return out


@pytest.fixture(scope="module")
def repeat_my_index(repeat_genome):
    from desamba_tpu.index.build import build_index

    return build_index(str(repeat_genome[0]))


@pytest.fixture(scope="module")
def reference_sam(reference_binary, repeat_ref_index, repeat_reads,
                  tmp_path_factory):
    out = tmp_path_factory.mktemp("repout") / "ref.sam"
    subprocess.run(
        [str(reference_binary), "classify", "-t", "1",
         str(repeat_ref_index), str(repeat_reads[0]), "-o", str(out)],
        check=True, capture_output=True)
    return out.read_text()


def test_m3_and_super_repeat_paths_taken(repeat_my_index, repeat_reads):
    """The crafted reads actually drive chain_insert_m3 and the
    >=1000-occurrence early return (not a vacuous differential)."""
    from desamba_tpu.engine.gold import chain as chain_mod
    from desamba_tpu.engine.gold.classify import ClassifyEngine, Options

    m3_calls = [0]
    orig_m3 = chain_mod.chain_insert_m3

    def count_m3(anchors, chains):
        m3_calls[0] += 1
        return orig_m3(anchors, chains)

    huge_hits = [0]
    from desamba_tpu.engine.gold import fastslow, mapseed as ms_mod

    orig_ms = ms_mod.map_seed

    def count_ms(*a, **kw):
        r = orig_ms(*a, **kw)
        if r == 50:
            huge_hits[0] += 1
        return r

    chain_mod.chain_insert_m3 = count_m3
    fastslow.map_seed = count_ms
    import desamba_tpu.io.native as _nv
    _real_avail = _nv.available
    _nv.available = lambda: False  # count_ms needs the python oracle
    try:
        eng = ClassifyEngine(repeat_my_index, Options())
        from desamba_tpu.io.fastx import read_fastx

        for rec in read_fastx(str(repeat_reads[0])):
            eng.classify_read(rec.name, rec.seq, rec.qual)
    finally:
        chain_mod.chain_insert_m3 = orig_m3
        fastslow.map_seed = orig_ms
        _nv.available = _real_avail
    assert m3_calls[0] >= 1, "M3 chain path not exercised"
    assert huge_hits[0] >= 1, ">=1000-occurrence guard not exercised"


def test_repeat_sam_parity_vs_reference(repeat_my_index, repeat_reads,
                                        reference_sam):
    """Gold engine == reference binary on the repeat corpus (M3 + super
    repeat + background), byte-identical SAM."""
    from desamba_tpu.engine.gold.classify import ClassifyEngine, Options
    from desamba_tpu.io.fastx import read_fastx
    from desamba_tpu.io.sam import format_result

    eng = ClassifyEngine(repeat_my_index, Options())
    out = []
    for rec in read_fastx(str(repeat_reads[0])):
        res = eng.classify_read(rec.name, rec.seq, rec.qual)
        out.append(format_result(res, repeat_my_index.ref_name, eng.opts))
    assert "".join(out) == reference_sam


def test_repeat_device_engine_matches_gold(repeat_my_index, repeat_reads):
    """Device engine output == gold on the repeat corpus (anchor-buffer
    overflows must fall back cleanly, not corrupt)."""
    from desamba_tpu.engine.device.classifier import DeviceClassifier
    from desamba_tpu.engine.gold.classify import ClassifyEngine, Options
    from desamba_tpu.io.fastx import read_fastx
    from desamba_tpu.io.sam import format_result

    recs = list(read_fastx(str(repeat_reads[0])))
    gold = ClassifyEngine(repeat_my_index, Options())
    exp = [format_result(gold.classify_read(r.name, r.seq, r.qual),
                         repeat_my_index.ref_name, gold.opts) for r in recs]
    dev = DeviceClassifier(repeat_my_index, Options())
    got = [format_result(res, repeat_my_index.ref_name, dev.opts)
           for res in dev.classify_reads(recs)]
    assert got == exp


def test_device_engine_repeat_corpus_no_rescue(repeat_my_index,
                                               repeat_reads):
    """The device engine handles the repeat corpus itself (M3 kernel +
    wide-anchor rescore sub-batch), not by gold rescue, and stays
    byte-equal to the gold engine."""
    from desamba_tpu.engine.device.classifier import DeviceClassifier
    from desamba_tpu.engine.gold.classify import ClassifyEngine, Options
    from desamba_tpu.io.fastx import read_fastx_fast as read_fastx
    from desamba_tpu.io.sam import format_result

    recs = list(read_fastx(str(repeat_reads[0])))
    gold = ClassifyEngine(repeat_my_index, Options())
    exp = "".join(gold.classify_records_formatted(recs, threads=1))
    eng = DeviceClassifier(repeat_my_index, Options())
    out = "".join(format_result(r, repeat_my_index.ref_name, eng.opts)
                  for r in eng.classify_reads(recs))
    assert out == exp
    fb = eng.fallback_stats()
    assert fb["fallback_reads"] == 0, fb
