"""chip_smoke.py off the GPU, and the seeded corpora it runs on.

The GPU run itself is `python chip_smoke.py` on the card; here it must
refuse to run, and its corpus generators and its check against gold must
hold on the CPU.
"""
import filecmp
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SMOKE = REPO / "chip_smoke.py"


def _run_smoke(script, platforms, cwd):
    # no card is visible even on a host that has one, so the smoke can
    # never reach a real GPU from here
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    if platforms is not None:
        env["JAX_PLATFORMS"] = platforms
    return subprocess.run([sys.executable, str(script)], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("platforms", ["cpu", None])
def test_smoke_fails_without_a_gpu(platforms):
    """JAX_PLATFORMS=cpu, or the script's own request for CUDA where no
    card is visible: non-zero exit and no result line."""
    r = _run_smoke(SMOKE, platforms, REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path / "chip_smoke.py", "cpu", tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def _scale(d, idx):
    from desamba_tpu.corpus import scale_genome

    scale_genome(str(d / "out"), 1)


def _reads(d, idx):
    from desamba_tpu.corpus import sampled_reads

    sampled_reads(idx, 64, str(d / "out"))


def _repeat(d, idx):
    from desamba_tpu.corpus import repeat_genome, repeat_reads

    units = repeat_genome(str(d / "genome"))
    repeat_reads(str(d / "out"), *units)


@pytest.mark.parametrize("make", [_scale, _reads, _repeat],
                         ids=["scale_genome", "sampled_reads", "repeat"])
def test_corpus_same_bytes_for_same_seed(make, small_my_index, tmp_path):
    runs = []
    for k in range(2):
        d = tmp_path / f"run{k}"
        d.mkdir()
        make(d, small_my_index)
        runs.append(d / "out")
    assert runs[0].stat().st_size > 0
    assert filecmp.cmp(runs[0], runs[1], shallow=False)


@pytest.fixture(scope="module")
def repeat_corpus(tmp_path_factory):
    """The smoke's corpus (c) with its gold SAM, made as the smoke makes
    it."""
    import chip_smoke
    from desamba_tpu.corpus import repeat_genome, repeat_reads
    from desamba_tpu.index.build import build_index

    d = tmp_path_factory.mktemp("smoke_rep")
    units = repeat_genome(str(d / "rep.fa"))
    idx = build_index(str(d / "rep.fa"))
    repeat_reads(str(d / "rep.fq"), *units)
    chip_smoke._gold_sam(idx, str(d / "rep.fq"), str(d / "rep.gold.sam"))
    return idx, d


@pytest.mark.parametrize("gold", ["as_made", "altered"])
def test_smoke_check_holds_device_to_gold(repeat_corpus, gold, tmp_path):
    """check_corpus passes on the gold SAM, with no fallback read, and
    exits non-zero when the gold SAM differs by one field."""
    import chip_smoke

    idx, d = repeat_corpus
    clock = chip_smoke.CompileClock()
    sam = d / "rep.gold.sam"
    if gold == "altered":
        text = sam.read_text()
        lines = text.splitlines(keepends=True)
        cols = lines[0].split("\t")
        cols[4] = str(int(cols[4]) + 1) if cols[4].isdigit() else "1"
        lines[0] = "\t".join(cols)
        sam = tmp_path / "altered.sam"
        sam.write_text("".join(lines))
        with pytest.raises(SystemExit) as e:
            chip_smoke.check_corpus("repeat", idx, str(d / "rep.fq"),
                                    str(sam), 0.0, clock)
        assert "1 of 8 reads differ" in str(e.value)
    else:
        eng = chip_smoke.check_corpus("repeat", idx, str(d / "rep.fq"),
                                      str(sam), 0.0, clock)
        assert eng.fallback_stats()["fallback_reads"] == 0


@pytest.mark.parametrize("shape,full", [((2, 2), False), ((1, 4), True)],
                         ids=["mesh_2x2", "shard_full_1x4"])
def test_smoke_spread_check_on_a_cpu_mesh(small_my_index, shape, full):
    """--four's placement check passes on both layouts, and fails once one
    idx-sharded table sits on a single device."""
    import jax

    import chip_smoke
    from desamba_tpu.engine.gold.classify import Options
    from desamba_tpu.parallel.classifier import MeshClassifier
    from desamba_tpu.parallel.mesh import make_mesh

    eng = MeshClassifier(small_my_index, Options(), mesh=make_mesh(*shape),
                         shard_full=full)
    names = set(eng.sharded_tables())
    assert {"ekmer0", "ekmer1"} <= names
    assert ({"fm_blocks", "hash13", "ref_bin", "text_pk"} <= names) == full
    chip_smoke.check_spread("layout", eng)
    eng.placed["ekmer1"] = jax.device_put(eng.placed["ekmer1"],
                                          jax.devices()[0])
    with pytest.raises(SystemExit) as e:
        chip_smoke.check_spread("layout", eng)
    assert "ekmer1" in str(e.value)
