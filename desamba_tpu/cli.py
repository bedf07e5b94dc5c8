"""Command-line interface: index / classify / analysis.

Mirrors the reference binary's subcommands (src/main.c:35-53) with a native
index format; `classify --engine` selects the host engine (gold) or the
batched device engine (device).
"""
from __future__ import annotations

import argparse
import sys
import time


def cmd_index(args):
    from .index.build import build_index
    from .index.store import save_index

    t0 = time.time()
    idx = build_index(args.reference,
                      progress=lambda *a: print(*a, file=sys.stderr))
    save_index(idx, args.index_dir)
    if args.export_reference_format:
        from .index.compat import export_reference_format

        export_reference_format(idx, args.index_dir)
    print(f"index built in {time.time()-t0:.1f}s -> {args.index_dir}",
          file=sys.stderr)


def cmd_classify(args):
    from .engine.gold.classify import ClassifyEngine, Options
    from .index.store import load_index
    from .io.fastx import read_fastx_fast as read_fastx

    t0 = time.time()
    idx = load_index(args.index_dir)
    print("loading index\tStart classify", file=sys.stderr)
    opts = Options(filter_min_length=args.l, max_sec_n=args.r,
                   filter_min_score=args.s, out_format=args.f)
    out = sys.stdout if args.o is None else open(args.o, "w")
    n = 0
    t1 = time.time()
    if args.engine == "device":
        from .engine.device.classifier import DeviceClassifier

        eng = DeviceClassifier(idx, opts)
        n = classify_device(eng, args.reads, out)
    else:
        import queue
        import threading

        eng = ClassifyEngine(idx, opts)
        for path in args.reads:
            print(f"Processing file: [{path}].", file=sys.stderr)
            # 3-stage kt_pipeline analogue (src/lib/kthread.c:157-197):
            # a reader thread parses batch N+1 while batch N classifies;
            # batches bound memory like the reference's: <=5000 reads or
            # 10 Mbp, whichever first (N_NEEDED / MAX_read_size,
            # src/cly_mt.c:19-20)
            q: "queue.Queue" = queue.Queue(maxsize=2)

            def reader(p=path):
                batch: list = []
                batch_bp = 0
                try:
                    for rec in read_fastx(p):
                        batch.append(rec)
                        batch_bp += len(rec.seq)
                        if len(batch) >= 5000 or batch_bp >= 10_000_000:
                            q.put(batch)
                            batch = []
                            batch_bp = 0
                    q.put(batch)
                    q.put(None)
                except BaseException as e:
                    q.put(e)

            threading.Thread(target=reader, daemon=True).start()
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                for line in eng.classify_records_formatted(
                        item, threads=args.t):
                    out.write(line)
                    n += 1
    dt = time.time() - t1
    print(f"{n} sequences processed in {dt:.3f}s "
          f"({n / 1e3 / (dt / 60):.1f} Kseq/m).", file=sys.stderr)
    # oracle-fallback rate (VERDICT r2: make silent rescue visible);
    # in-process counts only — fork-pool workers count per process
    n_fb = getattr(eng, "n_fallback", None)
    if n_fb is None and hasattr(eng, "fallback_stats"):
        n_fb = eng.fallback_stats()["fallback_reads"]
    if n_fb:
        print(f"oracle-fallback reads: {n_fb}/{n}", file=sys.stderr)
    if args.o is not None:
        out.close()
    _report_peak_rss()


def classify_device(eng, paths, out):
    """`classify --engine device` with a DeviceClassifier: writes the
    records of every read in paths to out, in input order; returns the
    read count. eng.fallback_stats() counts the reads the host oracle
    finished."""
    import jax

    from .io.sam import format_result

    dev = jax.devices()[0]
    print(f"device engine on {dev.platform} ({dev.device_kind})",
          file=sys.stderr)
    n = 0
    for path in paths:
        print(f"Processing file: [{path}].", file=sys.stderr)
        for res in eng.classify_file(path):
            out.write(format_result(res, eng.idx.ref_name, eng.opts))
            n += 1
    return n


def _report_peak_rss():
    """Reference main.c:51 prints peak RSS at exit (unit label bug kept
    in spirit, value in GB)."""
    try:
        import resource

        gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        print(f"MAX MEM:[{gb:.3f}] Gbp", file=sys.stderr)
    except Exception:
        pass


def cmd_analysis(args):
    from .analysis.taxonomy import run_analysis

    run_analysis(args.mode, args.args)


def read_jellyfish_dump(path: str, k: int):
    """Parse a Jellyfish binary dump (JFLISTDN, the format the reference
    kmersort ingests, src/idx_sort.c:30-47): 8-byte magic, key_bits at
    offset 8, val_len at 16, key count at 48, header size
    72 + 2*(4 + 8*key_bits), then key_ct (key_len + val_len)-byte pairs
    with the k-mer little-endian in the first key_len bytes."""
    import numpy as np

    with open(path, "rb") as f:
        head = f.read(56)
        if head[:8] != b"JFLISTDN":
            raise ValueError(f"{path}: not a Jellyfish JFLISTDN dump")
        key_bits = int.from_bytes(head[8:16], "little")
        val_len = int.from_bytes(head[16:24], "little")
        key_ct = int.from_bytes(head[48:56], "little")
        if val_len != 4:
            raise ValueError("can only handle 4 byte DB values")
        if key_bits != 2 * k:
            raise ValueError(f"dump has {key_bits // 2}-mers, expected {k}")
        key_len = key_bits // 8 + (1 if key_bits % 8 else 0)
        h_size = 72 + 2 * (4 + 8 * key_bits)
        f.seek(h_size)
        raw = np.fromfile(f, np.uint8,
                          key_ct * (key_len + val_len))
    pairs = raw.reshape(key_ct, key_len + val_len)
    keys = np.zeros((key_ct, 8), np.uint8)
    keys[:, :key_len] = pairs[:, :key_len]
    return keys.view(np.uint64).ravel()


def cmd_kmersort(args):
    """Sorted unique k-mer dump, byte-compatible with the reference's
    `kmersort` output (src/idx_sort.c): [u64 count][u64 kmers...].
    Counts k-mers from the FASTA directly (the Jellyfish replacement) or
    ingests a Jellyfish JFLISTDN dump via --jf."""
    import numpy as np

    from .index.kmers import BIT, rolling_kmers
    from .io.fastx import read_fastx_fast as read_fastx

    if args.jf:
        uniq = np.unique(read_jellyfish_dump(args.reference, args.k))
    else:
        vals = []
        for rec in read_fastx(args.reference):
            c = BIT[np.frombuffer(rec.seq.encode(), np.uint8)]
            d = np.diff(np.concatenate([[0], (c < 4).astype(np.int8), [0]]))
            for s, e in zip(np.flatnonzero(d == 1), np.flatnonzero(d == -1)):
                if e - s >= args.k:
                    vals.append(rolling_kmers(c[s:e], args.k))
        uniq = (np.unique(np.concatenate(vals)) if vals
                else np.empty(0, np.uint64))
    with open(args.o, "wb") as f:
        np.uint64(len(uniq)).tofile(f)
        uniq.tofile(f)
    print(f"{len(uniq)} unique {args.k}-mers -> {args.o}", file=sys.stderr)


def main(argv=None):
    p = argparse.ArgumentParser(prog="desamba-tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("index", help="build index from reference FASTA")
    pi.add_argument("reference")
    pi.add_argument("index_dir")
    pi.add_argument("--export-reference-format", action="store_true",
                    help="also write the reference binary's 8-file format")
    pi.set_defaults(fn=cmd_index)

    pc = sub.add_parser("classify", help="classify reads")
    pc.add_argument("index_dir")
    pc.add_argument("reads", nargs="+")
    pc.add_argument("-t", type=int, default=4, help="threads (host engine)")
    pc.add_argument("-l", type=int, default=170, help="min matching length")
    pc.add_argument("-r", type=int, default=5, help="max secondary output")
    pc.add_argument("-o", default=None, help="output file")
    pc.add_argument("-s", type=int, default=64, help="min score")
    pc.add_argument("-f", default="SAM",
                    choices=["SAM", "SAM_FULL", "DES", "DES_FULL"])
    pc.add_argument("--engine", default="auto",
                    choices=["auto", "gold", "device"],
                    help="auto = gold, the native host engine; device = "
                         "the batched device engine on the accelerator JAX "
                         "finds")
    pc.set_defaults(fn=cmd_classify)

    pa = sub.add_parser("analysis", help="taxonomy / accuracy analysis")
    pa.add_argument("mode")
    pa.add_argument("args", nargs="*")
    pa.set_defaults(fn=cmd_analysis)

    pk = sub.add_parser(
        "kmersort",
        help="write sorted unique 31-mers (reference kmer.srt format)")
    pk.add_argument("reference",
                    help="FASTA, or a Jellyfish JFLISTDN dump with --jf")
    pk.add_argument("-k", type=int, default=31)
    pk.add_argument("-o", default="kmer.srt")
    pk.add_argument("--jf", action="store_true",
                    help="input is a Jellyfish binary dump (JFLISTDN)")
    pk.set_defaults(fn=cmd_kmersort)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
