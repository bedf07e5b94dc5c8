"""Shared fixtures.

Heavy fixtures (reference binary, demo index) are cached under
/tmp/desamba_test_cache so repeated pytest runs are fast. Tests that need the
reference repo skip cleanly when /root/reference is absent.

Device tests run on a virtual 8-device CPU mesh (see pytest_configure).
"""
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
REFERENCE = Path("/root/reference")
CACHE = Path(os.environ.get("DESAMBA_TEST_CACHE", "/tmp/desamba_test_cache"))

sys.path.insert(0, str(REPO))


def pytest_configure(config):
    # The tests run on the CPU, with 8 virtual devices for the mesh tests
    # (harmless for host-only tests). jax may already be imported, so the
    # platform is also set through its config before first backend use.
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        import jax
    except ImportError:
        return
    jax.config.update("jax_platforms", "cpu")
    # big device kernels compile once per shape across runs
    from desamba_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()


@pytest.fixture(scope="session")
def reference_binary():
    """Build the reference deSAMBA binary once (for differential tests)."""
    if not REFERENCE.exists():
        pytest.skip("/root/reference not available")
    exe = CACHE / "refbin" / "src" / "deSAMBA"
    if not exe.exists():
        (CACHE / "refbin").mkdir(parents=True, exist_ok=True)
        shutil.copytree(REFERENCE / "src", CACHE / "refbin" / "src", dirs_exist_ok=True)
        subprocess.run(["make", "-s"], cwd=CACHE / "refbin" / "src", check=True,
                       capture_output=True)
    return exe


@pytest.fixture(scope="session")
def demo_files():
    """Unzipped demo FASTA + FASTQ from the reference repo."""
    if not REFERENCE.exists():
        pytest.skip("/root/reference not available")
    d = CACHE / "demo"
    fa, fq = d / "viral-gs.fa", d / "ERR1050068.fastq"
    if not (fa.exists() and fq.exists()):
        d.mkdir(parents=True, exist_ok=True)
        for z in ["viral-gs.zip", "ERR1050068.zip"]:
            with zipfile.ZipFile(REFERENCE / "demo" / z) as zf:
                zf.extractall(d)
    return fa, fq


def _write_kmersrt(fa: Path, out: Path):
    sys.path.insert(0, str(REPO / "tools"))
    subprocess.run(
        [sys.executable, str(REPO / "tools" / "make_kmersrt.py"), str(fa), str(out)],
        check=True, capture_output=True,
    )


def build_reference_index(exe: Path, fa: Path, out_dir: Path):
    """Run the reference `index` command (kmer.srt generated by our tool)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    srt = out_dir / "kmer.srt"
    _write_kmersrt(fa, srt)
    subprocess.run([str(exe), "index", str(srt), str(fa), str(out_dir)],
                   check=True, capture_output=True)
    srt.unlink()


@pytest.fixture(scope="session")
def demo_ref_index(reference_binary, demo_files):
    """Reference-built index for the demo viral FASTA (cached)."""
    out = CACHE / "index_viral_ref"
    if not (out / "deSAMBA.bwt").exists():
        build_reference_index(reference_binary, demo_files[0], out)
    return out


@pytest.fixture(scope="session")
def small_genome(tmp_path_factory):
    """Deterministic ~130kb synthetic genome with repeats, Ns, short runs.

    Heavily fragmented (many N patches + repeats) so the de-Bruijn graph has
    hundreds of unitigs: the reference binary crashes when the lowest 1/16th
    of k-mer space contains no unitig-start k-mer (src/idx.c:739 assigns '$'
    per-thread-shard), so tiny unfragmented genomes cannot be compared.
    """
    rng = np.random.default_rng(7)
    d = tmp_path_factory.mktemp("smallgen")
    fa = d / "small.fa"
    bases = np.array(list("ACGT"))
    with open(fa, "w") as f:
        core = "".join(rng.choice(bases, size=30000))
        for i, tid in enumerate([101, 202, 303]):
            seq = list("".join(rng.choice(bases, size=30000)))
            # shared repeats to create multi-occurrence unitigs + branch nodes
            for at in range(2000, 28000, 2500):
                ins = core[at : at + 400]
                seq[at : at] = list(ins)
            # N patches fragment runs into many unitigs; one short island
            for at in range(1000, 29000, 1100):
                seq[at : at + 3] = list("NNN")
            seq[10080:10100] = list("N" * 20)
            f.write(f">tid|{tid}|ref|SYN_{i} synthetic\n")
            s = "".join(seq)
            for j in range(0, len(s), 80):
                f.write(s[j : j + 80] + "\n")
    return fa


@pytest.fixture(scope="session")
def small_ref_index(reference_binary, small_genome, tmp_path_factory):
    out = tmp_path_factory.mktemp("smallidx_ref")
    build_reference_index(reference_binary, small_genome, out)
    return out


@pytest.fixture(scope="session")
def small_my_index(small_genome):
    from desamba_tpu.index.build import build_index

    return build_index(str(small_genome))


@pytest.fixture(scope="session")
def demo_my_index(demo_files):
    """Our index for the demo FASTA, cached as .npy directory."""
    from desamba_tpu.index.build import build_index
    from desamba_tpu.index.store import load_index, save_index

    out = CACHE / "index_viral_ours"
    if not (out / "meta.json").exists():
        idx = build_index(str(demo_files[0]))
        save_index(idx, str(out))
        return idx
    return load_index(str(out))
