#!/usr/bin/env python3
"""Smoke run of the device classify path on NVIDIA GPUs.

    python chip_smoke.py            one card: corpora (b) and (c) below
    python chip_smoke.py --mb 64    the same on a larger reference
    python chip_smoke.py --four     the multi-card mesh path, four cards
    python chip_smoke.py --four --corpus repeat   the same on corpus (c)

Corpora, all made from seeds in desamba_tpu/corpus.py:
  (a) a synthetic reference of --mb MiB (default 16; deSAMBA's own demo
      reference is 11.6 MB), indexed with index.build.build_index;
  (b) 8,192 reads of 200-2,000 bp with 10% substitutions sampled from
      (a): four full 2,048-read batches;
  (c) the repeat corpus that drives the M3 chain kernel and the
      wide-anchor rescore sub-batch, on its own small index.
They are cached, with their gold SAM, under .cache/smoke/ in the
checkout, keyed by the generator parameters. A child process that never
imports jax makes them: the gold engine forks a process pool, which is
unsafe once CUDA threads run, and the child must not open the card.

One card: (b) and (c) each go through the `classify --engine device`
calls twice (cold: compile + run, then warm) and (b) once more through
the threaded classify_reads pipeline. Every pass must give SAM
byte-equal to the gold engine, so the passes also agree with each other,
and the host oracle may finish at most 1% of the reads of (b) and none
of (c). The rescore stage is then timed alone on the batches of (b).

--four: MeshClassifier on a 2x2 (dp x idx) mesh and, with the big gather
tables row-sharded, on a 1x4 mesh, both on (b) (or on (c) with --corpus
repeat), each compared with gold and with the single-card engine. Each
idx-sharded table must sit one row range per card; device memory in use
is printed per card before and after each placement, but not checked:
the engine still keeps a whole single-card index on the first card.

Exits non-zero, before the result line, when JAX finds no GPU or any
check fails. The last line of stdout is the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""
from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_READS = 8192
MAX_FALLBACK_FRAC = 0.01   # corpus (b); corpus (c) allows none


def fail(msg: str):
    sys.exit(f"chip_smoke: FAILED: {msg}")


class CompileClock:
    """Counts XLA backend compilations and their seconds (jax.monitoring)."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        import jax

        self.n, self.secs = 0, 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, secs, **_):
        if event == self.EVENT:
            self.n += 1
            self.secs += secs

    def since(self, mark):
        return f"{self.n - mark[0]} programs compiled in " \
               f"{self.secs - mark[1]:.3f} s"

    def mark(self):
        return self.n, self.secs


def sam_diff(got: str, want: str) -> str:
    """How two SAM texts differ: differing read count and the first one."""
    def by_read(text):
        recs = {}
        for line in text.splitlines(keepends=True):
            recs.setdefault(line.split("\t", 1)[0], []).append(line)
        return recs

    g, w = by_read(got), by_read(want)
    bad = [name for name in w if g.get(name) != w[name]]
    bad += [name for name in g if name not in w]
    if not bad:
        return "same records, different order"
    first, none = bad[0], ["(none)\n"]
    return (f"{len(bad)} of {len(w)} reads differ; first {first}:\n"
            f"got  {''.join(g.get(first, none))}"
            f"want {''.join(w.get(first, none))}")


def corpus_dir(mb: int) -> str:
    return os.path.join(ROOT, ".cache", "smoke",
                        f"scale{mb}mb_{N_READS}reads_repeat")


def _gold_sam(idx, fq: str, out: str):
    from desamba_tpu.engine.gold.classify import ClassifyEngine, Options
    from desamba_tpu.io.fastx import read_fastx_fast

    eng = ClassifyEngine(idx, Options())
    recs = list(read_fastx_fast(fq))
    with open(out, "w") as f:
        f.write("".join(eng.classify_records_formatted(
            recs, threads=os.cpu_count() or 1)))


def make_corpus(d: str, mb: int):
    """Corpora (a)-(c), their indexes and gold SAM into d. Runs in a
    child process that never imports jax."""
    from desamba_tpu import corpus
    from desamba_tpu.index.build import build_index
    from desamba_tpu.index.store import save_index

    tmp = f"{d}.part"
    os.makedirs(tmp, exist_ok=True)
    t0 = time.perf_counter()
    corpus.scale_genome(os.path.join(tmp, "ref.fa"), mb)
    idx = build_index(os.path.join(tmp, "ref.fa"))
    save_index(idx, os.path.join(tmp, "idx"))
    t_build = time.perf_counter() - t0
    corpus.sampled_reads(idx, N_READS, os.path.join(tmp, "reads.fq"))
    t0 = time.perf_counter()
    _gold_sam(idx, os.path.join(tmp, "reads.fq"),
              os.path.join(tmp, "reads.gold.sam"))
    t_gold = time.perf_counter() - t0
    units = corpus.repeat_genome(os.path.join(tmp, "rep.fa"))
    rep = build_index(os.path.join(tmp, "rep.fa"))
    save_index(rep, os.path.join(tmp, "rep_idx"))
    corpus.repeat_reads(os.path.join(tmp, "rep.fq"), *units)
    _gold_sam(rep, os.path.join(tmp, "rep.fq"),
              os.path.join(tmp, "rep.gold.sam"))
    print(f"corpus: {mb} MiB reference indexed in {t_build:.2f} s; gold "
          f"engine (host CPU, {os.cpu_count()} processes) on {N_READS} "
          f"reads: {t_gold:.3f} s", flush=True)
    os.replace(tmp, d)


def ensure_corpus(mb: int) -> str:
    d = corpus_dir(mb)
    if not os.path.isdir(d):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--corpus-child", d, "--mb", str(mb)], check=True)
    return d


def device_index_bytes(dix) -> int:
    import jax

    return sum(v.nbytes for v in vars(dix).values()
               if isinstance(v, jax.Array))


def classify_pass(eng, fq: str):
    """One `classify --engine device` pass: (SAM text, reads, seconds)."""
    from desamba_tpu.cli import classify_device

    buf = io.StringIO()
    t0 = time.perf_counter()
    n = classify_device(eng, [fq], buf)
    return buf.getvalue(), n, time.perf_counter() - t0


def check_corpus(name, idx, fq, gold_sam, max_fallback_frac, clock,
                 time_rescore=False):
    """Cold and warm passes of one corpus, each held to gold; returns the
    warm engine. With time_rescore, the rescore stage of every main batch
    of the cold pass is then re-run alone on the warm engine."""
    import jax

    from desamba_tpu.engine.device.classifier import DeviceClassifier
    from desamba_tpu.engine.gold.classify import Options

    with open(gold_sam) as f:
        gold = f.read()
    captured = []
    for label in ("cold", "warm"):
        mark = clock.mark()
        t0 = time.perf_counter()
        eng = DeviceClassifier(idx, Options())
        t_setup = time.perf_counter() - t0
        if label == "cold" and time_rescore:
            k_rescore = eng._k_rescore

            def spy(inp, k_rescore=k_rescore):
                captured.append(inp)
                return k_rescore(inp)

            eng._k_rescore = spy
        sam, n_reads, dt = classify_pass(eng, fq)
        fb = eng.fallback_stats()["fallback_reads"]
        print(f"{name} {label}: {n_reads} reads in {dt:.3f} s "
              f"({n_reads / dt:.1f} reads/s; engine set-up {t_setup:.3f} s"
              f" before it; {clock.since(mark)}), host-oracle fallback "
              f"reads {fb}", flush=True)
        if sam != gold:
            fail(f"{name} {label} pass: device SAM differs from gold: "
                 f"{sam_diff(sam, gold)}")
        if fb > max_fallback_frac * n_reads:
            fail(f"{name} {label} pass: {fb} fallback reads > "
                 f"{max_fallback_frac:.0%} of {n_reads}")
    print(f"{name}: index bytes on device {device_index_bytes(eng.dix)}",
          flush=True)
    if time_rescore:
        if not captured:
            fail(f"{name}: no batch reached the rescore stage")
        per_batch = []
        for inp in captured:
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                jax.block_until_ready(eng._k_rescore(inp))
                best = min(best, time.perf_counter() - t0)
            per_batch.append(best)
        print(f"{name}: rescore stage alone (_k_rescore, blocked, best of "
              f"3) {[round(1e3 * t, 3) for t in per_batch]} ms over "
              f"{len(per_batch)} batches of {inp.n_chains.shape[0]} rows; "
              f"sum {1e3 * sum(per_batch):.3f} ms = "
              f"{sum(per_batch) / dt:.1%} of the warm pass wall", flush=True)
    return eng


def run_one(d: str, clock):
    from desamba_tpu.engine.device.classifier import DeviceClassifier
    from desamba_tpu.engine.gold.classify import Options
    from desamba_tpu.index.store import load_index
    from desamba_tpu.io.fastx import read_fastx_fast
    from desamba_tpu.io.sam import format_result

    idx = load_index(os.path.join(d, "idx"))
    fq = os.path.join(d, "reads.fq")
    gold_sam = os.path.join(d, "reads.gold.sam")
    eng = check_corpus("scale", idx, fq, gold_sam, MAX_FALLBACK_FRAC, clock,
                       time_rescore=True)
    del eng
    # the threaded 3-deep device pipeline (classify_reads)
    recs = list(read_fastx_fast(fq))
    eng = DeviceClassifier(idx, Options())
    t0 = time.perf_counter()
    sam = "".join(format_result(r, idx.ref_name, eng.opts)
                  for r in eng.classify_reads(recs))
    dt = time.perf_counter() - t0
    print(f"scale classify_reads: {len(recs)} reads in {dt:.3f} s "
          f"({len(recs) / dt:.1f} reads/s)", flush=True)
    with open(gold_sam) as f:
        gold = f.read()
    if sam != gold:
        fail(f"classify_reads pass: device SAM differs from gold: "
             f"{sam_diff(sam, gold)}")
    del eng
    rep = load_index(os.path.join(d, "rep_idx"))
    check_corpus("repeat", rep, os.path.join(d, "rep.fq"),
                 os.path.join(d, "rep.gold.sam"), 0.0, clock)


def print_memory(label: str, devices):
    used = [dev.memory_stats()["bytes_in_use"] for dev in devices]
    print(f"{label}: bytes_in_use per card {used}", flush=True)


def check_spread(label: str, eng):
    """Every idx-sharded table must hold one 1/n_idx row range on each
    card of the mesh. Only these tables are checked: the engine also keeps
    the single-card DeviceIndex on the default card and replicates the FM
    tables to every card, so the totals per card do not spread."""
    cards = set(eng.mesh.devices.flat)
    total = 0
    for name, arr in eng.sharded_tables().items():
        shards = arr.addressable_shards
        on = {s.device for s in shards}
        rows = {s.data.shape[0] for s in shards}
        if on != cards or rows != {arr.shape[0] // eng.n_idx}:
            fail(f"{label}: {name} of {arr.shape[0]} rows sits on "
                 f"{len(on)} of {len(cards)} cards with shard rows {rows}")
        total += arr.nbytes
    print(f"{label}: {len(eng.sharded_tables())} idx-sharded tables, "
          f"{total} bytes, one 1/{eng.n_idx} row range on each of "
          f"{len(cards)} cards; the default card also keeps the whole "
          f"DeviceIndex ({device_index_bytes(eng.dix)} bytes) and the FM "
          f"tables are replicated, so per-card totals are not checked",
          flush=True)


CORPORA = {  # --corpus: (index, reads, gold SAM)
    "scale": ("idx", "reads.fq", "reads.gold.sam"),
    "repeat": ("rep_idx", "rep.fq", "rep.gold.sam"),
}


def run_four(d: str, corpus: str, devices, clock):
    """Both mesh layouts on one corpus, each held to gold, then the
    single-card engine, held to gold and to each layout. Fallback reads
    are printed, not limited: a mesh shard packs its ladder lanes into
    1/n_dp of the single card's room, so a lane that fits one card can
    overflow its shard and go to the host oracle."""
    import gc

    from desamba_tpu.engine.device.classifier import DeviceClassifier
    from desamba_tpu.engine.gold.classify import Options
    from desamba_tpu.index.store import load_index
    from desamba_tpu.parallel.classifier import MeshClassifier
    from desamba_tpu.parallel.mesh import make_mesh

    idx_dir, fq_name, gold_name = CORPORA[corpus]
    idx = load_index(os.path.join(d, idx_dir))
    fq = os.path.join(d, fq_name)
    with open(os.path.join(d, gold_name)) as f:
        gold = f.read()
    sams = {}
    for label, mesh, full in (("mesh dp=2 x idx=2", make_mesh(2, 2), False),
                              ("shard_full dp=1 x idx=4", make_mesh(1, 4),
                               True)):
        gc.collect()
        print_memory(f"{label}: before placement", devices)
        eng = MeshClassifier(idx, Options(), mesh=mesh, shard_full=full)
        check_spread(label, eng)
        print_memory(f"{label} placed", devices)
        mark = clock.mark()
        sam, n_reads, dt = classify_pass(eng, fq)
        fb = eng.fallback_stats()["fallback_reads"]
        print(f"{label} ({corpus}): {n_reads} reads in {dt:.3f} s "
              f"({clock.since(mark)}), host-oracle fallback reads {fb}",
              flush=True)
        if sam != gold:
            fail(f"{label}: SAM differs from gold: {sam_diff(sam, gold)}")
        sams[label] = sam
        del eng
    mark = clock.mark()
    single, n_reads, dt = classify_pass(DeviceClassifier(idx, Options()), fq)
    print(f"single card ({corpus}): {n_reads} reads in {dt:.3f} s "
          f"({clock.since(mark)})", flush=True)
    if single != gold:
        fail(f"single-card SAM differs from gold: {sam_diff(single, gold)}")
    for label, sam in sams.items():
        if sam != single:
            fail(f"{label}: SAM differs from the single-card engine: "
                 f"{sam_diff(sam, single)}")
    print(f"both layouts byte-equal to the single card and to gold on "
          f"{n_reads} reads", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=int, default=16,
                    help="synthetic reference size in MiB (default 16)")
    ap.add_argument("--four", action="store_true",
                    help="run the four-card mesh path and nothing else")
    ap.add_argument("--corpus", choices=sorted(CORPORA), default="scale",
                    help="with --four: classify (b) scale (default) or "
                         "(c) repeat")
    ap.add_argument("--corpus-child", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.corpus_child:
        make_corpus(args.corpus_child, args.mb)
        return

    # ask for CUDA: a broken plugin must be an error, not a CPU run
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    import desamba_tpu  # noqa: F401  (its XLA_FLAGS, before JAX starts)
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        fail(f"needs a GPU; JAX found {dev.platform}")
    need = 4 if args.four else 1
    if len(devices) < need:
        fail(f"needs {need} GPUs; JAX found {len(devices)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    print(f"jax {jax.__version__}; {len(devices)} x {dev.device_kind}",
          flush=True)

    from desamba_tpu.compile_cache import cache_dir, enable_compile_cache

    enable_compile_cache()
    print(f"compile cache: {cache_dir()}", flush=True)
    clock = CompileClock()
    t0 = time.perf_counter()
    d = ensure_corpus(args.mb)
    print(f"corpus ready in {time.perf_counter() - t0:.2f} s: {d}",
          flush=True)
    if args.four:
        run_four(d, args.corpus, devices[:4], clock)
    else:
        run_one(d, clock)
    print(f"peak_bytes_in_use {dev.memory_stats()['peak_bytes_in_use']}",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": need}}))


if __name__ == "__main__":
    main()
