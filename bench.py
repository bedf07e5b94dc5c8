"""End-to-end benchmark: classify throughput vs the reference binary.

Prints one JSON line per measurement; the LAST line is the headline
result: the device engine's saturation line when it ran with SAM
parity. A device run that fails, times out or loses parity exits
non-zero; the host engine's number is never reprinted as the headline.

Protocol (all in one run, same thermal window):
  1. measure the REFERENCE binary in-run (t1 + t4) on the demo corpus
     and on a ~10k-read saturation corpus (demo x8); its SAM output on
     the saturation corpus becomes the parity oracle for that corpus.
  2. gold (host) engine on both corpora -> JSON lines.
  3. device engine in a time-boxed child on both corpora -> JSON lines
     (the parent never imports jax, so only the child opens the device).
  4. headline: device saturation line if parity held, else exit 1.

vs_baseline uses the in-run reference t4 measurement on the same corpus
(falls back to the frozen 2026-08-16 number when the reference binary
is unavailable). A number is always printed early (gold lands first,
flushed) so an outer driver timeout can never erase the run.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
import zipfile
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

FROZEN_BASELINE_T4 = 10060.0   # reads/s, reference t4 on demo, 2026-08-16
CACHE = Path(os.environ.get("DESAMBA_TEST_CACHE",
                            Path(__file__).resolve().parent / ".cache"
                            / "bench"))
REFERENCE = Path("/root/reference")
# Total self-imposed budget; the device attempt gets what is left of it.
BUDGET_S = float(os.environ.get("DESAMBA_BENCH_BUDGET", "1500"))
T_START = time.time()
SAT_COPIES = int(os.environ.get("DESAMBA_BENCH_SAT_COPIES", "8"))


def _emit(metric, n, dt, parity, baseline, extra=None):
    val = n / dt
    rec = {
        "metric": metric,
        "value": round(val, 2),
        "unit": "reads/s",
        "vs_baseline": round(val / baseline, 4) if baseline else None,
        "n_reads": n,
        "seconds": round(dt, 3),
        "sam_parity": parity,
    }
    if extra:
        rec.update(extra)
    print(json.dumps(rec), flush=True)
    return rec


def _demo_files():
    d = CACHE / "demo"
    fa, fq = d / "viral-gs.fa", d / "ERR1050068.fastq"
    if not (fa.exists() and fq.exists()):
        d.mkdir(parents=True, exist_ok=True)
        for z in ["viral-gs.zip", "ERR1050068.zip"]:
            with zipfile.ZipFile(REFERENCE / "demo" / z) as zf:
                zf.extractall(d)
    return fa, fq


def _sat_corpus(fq: Path) -> Path:
    """Saturation corpus: the demo FASTQ repeated SAT_COPIES times
    (~10k reads). Stream order matters (max_read_l is a prefix-max,
    src/cly.h:157), so the oracle is the reference run on this exact
    file, not 8 copies of the demo golden."""
    out = CACHE / f"demo/ERR1050068_x{SAT_COPIES}.fastq"
    if not out.exists():
        data = fq.read_bytes()
        if not data.endswith(b"\n"):
            data += b"\n"
        with open(out, "wb") as f:
            for _ in range(SAT_COPIES):
                f.write(data)
    return out


def _demo_index(fa):
    from desamba_tpu.index.build import build_index
    from desamba_tpu.index.store import load_index, save_index

    out = CACHE / "index_viral_ours"
    if (out / "meta.json").exists():
        return load_index(str(out))
    idx = build_index(str(fa))
    save_index(idx, str(out))
    return idx


# ---- reference binary ----------------------------------------------------

def _reference_binary():
    if not REFERENCE.exists():
        return None
    exe = CACHE / "refbin" / "src" / "deSAMBA"
    if not exe.exists():
        (CACHE / "refbin").mkdir(parents=True, exist_ok=True)
        shutil.copytree(REFERENCE / "src", CACHE / "refbin" / "src",
                        dirs_exist_ok=True)
        subprocess.run(["make", "-s"], cwd=CACHE / "refbin" / "src",
                       check=True, capture_output=True)
    return exe


def _reference_index(exe, fa):
    out = CACHE / "index_viral_ref"
    if (out / "deSAMBA.bwt").exists():
        return out
    out.mkdir(parents=True, exist_ok=True)
    srt = out / "kmer.srt"
    repo = Path(__file__).parent
    subprocess.run([sys.executable, str(repo / "tools" / "make_kmersrt.py"),
                    str(fa), str(srt)], check=True, capture_output=True)
    subprocess.run([str(exe), "index", str(srt), str(fa), str(out)],
                   check=True, capture_output=True)
    srt.unlink()
    return out


def _run_reference(exe, idx_dir, fq, threads, sam_out=None, repeats=3):
    """Best-of-N reference classify; returns (reads_per_s, n, dt).
    Parses the binary's own report (src/cly_mt.c:439-446) so index-load
    time is excluded, same as its published Kseq/m metric."""
    best = None
    for _ in range(repeats):
        r = subprocess.run([str(exe), "classify", "-t", str(threads),
                            str(idx_dir), str(fq)],
                           capture_output=True, text=True, check=True)
        m = re.search(r"(\d+) sequences processed in ([\d.]+)s", r.stderr)
        if not m:
            return None
        n, dt = int(m.group(1)), float(m.group(2))
        if best is None or n / dt > best[0]:
            best = (n / dt, n, dt, r.stdout)
    if sam_out is not None:
        sam_out.write_text(best[3])
    return best[:3]


# ---- our engines ---------------------------------------------------------

def _check_parity(out_lines, oracle: Path):
    if oracle.exists():
        return "".join(out_lines) == oracle.read_text()
    return None


def _run_gold(idx, reads, opts, metric, oracle, baseline, repeats=5):
    from desamba_tpu.engine.gold.classify import ClassifyEngine

    eng = ClassifyEngine(idx, opts)
    # thread-pool size is host-dependent: measured optimum on the dev box
    # is 2x cores (chunks stall briefly on python-side result assembly);
    # override with DESAMBA_BENCH_THREADS elsewhere
    cores = os.cpu_count() or 4
    threads = int(os.environ.get("DESAMBA_BENCH_THREADS", str(2 * cores)))
    eng.classify_records(reads[:64], threads=threads)  # pool+table warm-up
    dt = float("inf")
    for _ in range(repeats):
        eng.state.max_read_l = 0
        t0 = time.time()
        out_lines = eng.classify_records_formatted(reads, threads=threads)
        dt = min(dt, time.time() - t0)
    return _emit(metric, len(reads), dt, _check_parity(out_lines, oracle),
                 baseline, {"engine": "gold", "threads": threads})


def _run_device(idx, reads, opts, metric, oracle, baseline):
    from desamba_tpu.engine.device.classifier import DeviceClassifier
    from desamba_tpu.io.sam import format_result

    eng = DeviceClassifier(idx, opts)
    # warm-up pass compiles every production shape outside the timed
    # region (programs are shape-bucketed + disk-cached)
    warm = list(eng.classify_reads(reads[: min(len(reads), 2048)]))
    del warm
    eng.state.max_read_l = 0
    t0 = time.time()
    out_lines = [format_result(r, idx.ref_name, opts)
                 for r in eng.classify_reads(reads)]
    dt = time.time() - t0
    extra = {"engine": "device"}
    if hasattr(eng, "fallback_stats"):
        extra["fallback"] = eng.fallback_stats()
    return _emit(metric, len(reads), dt,
                 _check_parity(out_lines, oracle), baseline, extra)


def main():
    fa, fq = _demo_files()
    fq8 = _sat_corpus(fq)
    idx = _demo_index(fa)
    golden_demo = Path(__file__).parent / "tests" / "golden" / "demo_viral.sam"
    oracle8 = CACHE / f"demo/ref_sam_x{SAT_COPIES}.sam"

    from desamba_tpu.engine.gold.classify import Options
    from desamba_tpu.io.fastx import read_fastx_fast as read_fastx

    opts = Options()
    reads = list(read_fastx(str(fq)))
    reads8 = list(read_fastx(str(fq8)))

    # ---- in-run reference measurement (same thermal window) -------------
    base_demo = base_sat = None
    mode = os.environ.get("DESAMBA_BENCH_ENGINE", "auto")
    if mode != "device-child":
        try:
            exe = _reference_binary()
            if exe is not None:
                ridx = _reference_index(exe, fa)
                r1 = _run_reference(exe, ridx, fq, 1, repeats=2)
                r4 = _run_reference(exe, ridx, fq, 4, repeats=3)
                r48 = _run_reference(exe, ridx, fq8, 4, sam_out=oracle8,
                                     repeats=3)
                if r1:
                    _emit("reference_t1", r1[1], r1[2], True, None,
                          {"engine": "reference"})
                if r4:
                    base_demo = r4[0]
                    _emit("reference_t4", r4[1], r4[2], True, None,
                          {"engine": "reference"})
                if r48:
                    base_sat = r48[0]
                    _emit("reference_t4_10k", r48[1], r48[2], True, None,
                          {"engine": "reference"})
        except Exception as e:  # reference unavailable: frozen fallback
            print(f"reference measurement failed: {e}", file=sys.stderr)
    base_demo = base_demo or FROZEN_BASELINE_T4
    base_sat = base_sat or FROZEN_BASELINE_T4

    if mode == "device-child":
        # child re-derives baselines from env (set by parent)
        base_demo = float(os.environ.get("DESAMBA_BASE_DEMO", base_demo
                                         or FROZEN_BASELINE_T4))
        base_sat = float(os.environ.get("DESAMBA_BASE_SAT", base_sat
                                        or FROZEN_BASELINE_T4))
        _run_device(idx, reads, opts, "demo_classify_device", golden_demo,
                    base_demo)
        _run_device(idx, reads8, opts, "classify10k_device", oracle8,
                    base_sat)
        return

    if mode in ("auto", "gold"):
        _run_gold(idx, reads, opts, "demo_classify_gold", golden_demo,
                  base_demo)
        _run_gold(idx, reads8, opts, "classify10k_gold", oracle8, base_sat,
                  repeats=3)
    if mode == "gold":
        return

    # ---- device engine, time-boxed in a child ---------------------------
    remaining = BUDGET_S - (time.time() - T_START) - 30
    if remaining < 60:
        sys.exit(f"no time left for the device run ({remaining:.0f}s)")
    env = dict(os.environ, DESAMBA_BENCH_ENGINE="device-child",
               DESAMBA_BASE_DEMO=str(base_demo),
               DESAMBA_BASE_SAT=str(base_sat))
    try:
        r = subprocess.run([sys.executable, os.path.abspath(__file__)],
                           env=env, timeout=remaining, capture_output=True,
                           text=True)
    except subprocess.TimeoutExpired:
        sys.exit("device child timed out")
    recs = []
    for line in r.stdout.splitlines():
        if line.startswith("{"):
            print(line, flush=True)   # every device line is first-class
            recs.append(json.loads(line))
    if r.returncode != 0:
        sys.stderr.write(r.stderr[-2000:])
        sys.exit(f"device child failed (exit {r.returncode})")
    head = next((x for x in reversed(recs)
                 if x["metric"] == "classify10k_device"
                 and x.get("sam_parity")), None)
    if head is None:
        sys.exit("device parity failed or missing")
    print(json.dumps(head), flush=True)


if __name__ == "__main__":
    main()
