"""Scale validation: build an index from a large synthetic FASTA and
classify a read corpus against it. The corpora come from
desamba_tpu/corpus.py.

Usage:
  python3 tools/scale_proof.py gen <mb> <out.fa>        # synthetic genome
  python3 tools/scale_proof.py build <fa> <idxdir>      # timed build + RSS
  python3 tools/scale_proof.py reads <idxdir> <n> <fq>  # mutated reads
  python3 tools/scale_proof.py classify <idxdir> <fq> [--gold-sample N]
"""
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from desamba_tpu import corpus  # noqa: E402


def gen(mb: int, out: str):
    t0 = time.time()
    corpus.scale_genome(out, mb)
    print(f"gen: {mb} MB in {time.time() - t0:.1f}s -> {out}")


def gen_dup(mb: int, out: str):
    t0 = time.time()
    corpus.dup_genome(out, mb)
    print(f"gen_dup: {mb} MB in {time.time() - t0:.1f}s -> {out}")


def extbuild(fa: str, out: str, cgroup_mb: int = 0):
    """External-memory build, optionally inside a kernel-enforced
    memory cgroup (the honest <=N GB demonstration: the kernel
    OOM-kills us if the builder really needs more)."""
    if cgroup_mb:
        cg = "/sys/fs/cgroup/memory/desbuild"
        os.makedirs(cg, exist_ok=True)
        with open(cg + "/memory.limit_in_bytes", "w") as f:
            f.write(str(cgroup_mb << 20))
        with open(cg + "/cgroup.procs", "w") as f:
            f.write(str(os.getpid()))
        print(f"extbuild: memory cgroup limit {cgroup_mb} MB")
    from desamba_tpu.index.build_ext import build_index_external
    from desamba_tpu.index.store import save_index

    t0 = time.time()
    idx = build_index_external(fa, progress=lambda *a: print(
        f"  [{time.time() - t0:7.1f}s]", *a, flush=True))
    wall = time.time() - t0
    save_index(idx, out)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"extbuild: wall={wall:.1f}s peak_rss={rss:.2f}GB "
          f"n_bases={int(idx.ref_off[-1] + idx.ref_len[-1])} "
          f"n_uni={idx.n_uni} len_e_kmer={idx.len_e_kmer}")


def build(fa: str, out: str):
    from desamba_tpu.index.build import build_index
    from desamba_tpu.index.store import save_index

    t0 = time.time()
    idx = build_index(fa)
    wall = time.time() - t0
    save_index(idx, out)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"build: wall={wall:.1f}s peak_rss={rss:.2f}GB "
          f"n_bases={int(idx.ref_off[-1] + idx.ref_len[-1])} "
          f"unitigs={len(idx.ref_len)}")


def reads(idxdir: str, n: int, out: str):
    from desamba_tpu.index.store import load_index

    t0 = time.time()
    corpus.sampled_reads(load_index(idxdir), n, out)
    print(f"reads: {n} in {time.time() - t0:.1f}s -> {out}")


def classify(idxdir: str, fq: str, gold_sample: int = 0,
             engine: str = "device"):
    import jax

    if engine == "host":
        # the host engine needs no accelerator
        jax.config.update("jax_platforms", "cpu")
    from desamba_tpu.engine.device.classifier import DeviceClassifier
    from desamba_tpu.engine.gold.classify import ClassifyEngine, Options
    from desamba_tpu.index.store import load_index
    from desamba_tpu.io.fastx import read_fastx_fast
    from desamba_tpu.io.sam import format_result

    idx = load_index(idxdir)
    recs = list(read_fastx_fast(fq))
    if engine == "host":
        heng = ClassifyEngine(idx, Options())
        heng.classify_records(recs[:256], threads=8)  # warm pool
        heng.state.max_read_l = 0
        t0 = time.time()
        out = [format_result(r, idx.ref_name, heng.opts)
               for r in heng.classify_records(recs, threads=8)]
        wall = time.time() - t0
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        cls = sum(1 for s in out if "\t4\t" not in s.split("\n")[0])
        print(f"classify[host]: {len(recs)} reads in {wall:.1f}s = "
              f"{len(recs) / wall:.1f} reads/s, {cls} classified, "
              f"peak_rss={rss:.2f}GB")
        return
    eng = DeviceClassifier(idx, Options())
    warm = list(eng.classify_reads(recs[:2048]))   # compile pass
    del warm
    eng.state.max_read_l = 0
    t0 = time.time()
    out = [format_result(r, idx.ref_name, eng.opts)
           for r in eng.classify_reads(recs)]
    wall = time.time() - t0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    cls = sum(1 for s in out if "\t4\t" not in s.split("\n")[0])
    print(f"classify: {len(recs)} reads in {wall:.1f}s = "
          f"{len(recs) / wall:.1f} reads/s, {cls} classified, "
          f"peak_rss={rss:.2f}GB")
    if gold_sample:
        g = ClassifyEngine(idx, Options())
        exp = [format_result(r, idx.ref_name, g.opts)
               for r in g.classify_records(recs[:gold_sample], threads=4)]
        ok = out[:gold_sample] == exp
        print(f"gold sample parity ({gold_sample} reads): {ok}")
        assert ok


if __name__ == "__main__":
    cmd = sys.argv[1]
    if cmd == "gen":
        gen(int(sys.argv[2]), sys.argv[3])
    elif cmd == "gen_dup":
        gen_dup(int(sys.argv[2]), sys.argv[3])
    elif cmd == "extbuild":
        cg = 0
        if "--cgroup-mb" in sys.argv:
            cg = int(sys.argv[sys.argv.index("--cgroup-mb") + 1])
        extbuild(sys.argv[2], sys.argv[3], cg)
    elif cmd == "build":
        build(sys.argv[2], sys.argv[3])
    elif cmd == "reads":
        reads(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    elif cmd == "classify":
        gs = 0
        if "--gold-sample" in sys.argv:
            gs = int(sys.argv[sys.argv.index("--gold-sample") + 1])
        classify(sys.argv[2], sys.argv[3], gs)
