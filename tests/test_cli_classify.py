"""CLI classify surface: subprocess end-to-end (read -> classify ->
format) equals the in-process engine, for both -f SAM and DES and for
multi-batch streams (the 5000-read/10 Mbp pipeline batching)."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest


@pytest.fixture(scope="module")
def cli_setup(small_my_index, tmp_path_factory):
    from desamba_tpu.engine.gold.mapseed import get_ref
    from desamba_tpu.index.store import save_index

    idx = small_my_index
    d = tmp_path_factory.mktemp("cli")
    save_index(idx, str(d / "idx"))
    rng = np.random.default_rng(33)
    total = int(idx.ref_off[-1] + idx.ref_len[-1])
    fq = d / "reads.fq"
    with open(fq, "w") as f:
        for i in range(40):
            L = int(rng.integers(150, 700))
            st = int(rng.integers(0, total - L))
            seq = get_ref(idx.ref_bin, st, L, True).copy()
            pos = rng.integers(0, L, size=L // 12)
            seq[pos] = (seq[pos] + rng.integers(1, 4, size=len(pos))) % 4
            s = "".join("ACGT"[c] for c in seq)
            f.write(f"@r{i}\n{s}\n+\n{'I' * L}\n")
    return idx, d


@pytest.mark.parametrize("fmt", ["SAM", "DES"])
def test_cli_matches_engine(cli_setup, fmt, tmp_path):
    from desamba_tpu.engine.gold.classify import ClassifyEngine, Options
    from desamba_tpu.io.fastx import read_fastx_fast
    from desamba_tpu.io.sam import format_result

    idx, d = cli_setup
    out = tmp_path / f"out.{fmt}"
    r = subprocess.run(
        [sys.executable, "-m", "desamba_tpu.cli", "classify",
         "--engine", "gold", "-f", fmt, str(d / "idx"), str(d / "reads.fq"),
         "-o", str(out)],
        capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin:/usr/local/bin",
             "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": str(Path(__file__).resolve().parent.parent)})
    assert r.returncode == 0, r.stderr[-2000:]
    eng = ClassifyEngine(idx, Options(out_format=fmt))
    exp = []
    for rec in read_fastx_fast(str(d / "reads.fq")):
        exp.append(format_result(eng.classify_read(rec.name, rec.seq,
                                                   rec.qual),
                                 idx.ref_name, eng.opts))
    assert out.read_text() == "".join(exp)
