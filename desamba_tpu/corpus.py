"""Seeded synthetic corpora: reference FASTAs and read sets.

Every generator draws from a fixed seed, so the same arguments give the
same bytes on every machine. Used by chip_smoke.py, tools/scale_proof.py
and the tests.

  scale_genome   random genome with a shared 5 kb core and N patches
  dup_genome     genome with ~2x content duplication
  sampled_reads  reads copied from an index's reference, 10% substitutions
  repeat_genome  genome with a 60x and an 1100x repeat unit (M3 chaining,
                 the >=1000-occurrence guard)
  repeat_reads   reads crafted to hit those branches, plus background
"""
from __future__ import annotations

import numpy as np

_ACGT = np.frombuffer(b"ACGT", np.uint8)


def _write_fasta_record(f, header: str, seq: np.ndarray):
    """One record, 80 bases per line."""
    f.write(f">{header}\n".encode())
    n_full = len(seq) // 80
    if n_full:
        rows = np.empty((n_full, 81), np.uint8)
        rows[:, :80] = seq[: n_full * 80].reshape(n_full, 80)
        rows[:, 80] = ord("\n")
        f.write(rows.tobytes())
    if len(seq) % 80:
        f.write(seq[n_full * 80 :].tobytes() + b"\n")


def scale_genome(path: str, mb: int):
    """mb MiB of random sequence in max(4, mb // 8) records. A 5 kb core
    is copied in every 1 Mb and NNN patches break runs every 400 kb."""
    rng = np.random.default_rng(99)
    n_seq = max(4, mb // 8)
    per = mb * (1 << 20) // n_seq
    core = _ACGT[rng.integers(0, 4, 5000)]
    with open(path, "wb") as f:
        for i in range(n_seq):
            s = _ACGT[rng.integers(0, 4, per)]
            for at in range(50_000, per - 6000, 1_000_000):
                s[at : at + 5000] = core
            for at in range(25_000, per - 100, 400_000):
                s[at : at + 3] = ord("N")
            _write_fasta_record(f, f"tid|{1000 + i}|ref|SCALE_{i} synthetic",
                                s)


def dup_genome(path: str, mb: int):
    """Synthetic genome with ~2x content duplication: half the k-mers of
    a same-size random genome (real reference collections repeat; the
    external build's k-mer table scales with unique k-mers)."""
    rng = np.random.default_rng(123)
    n_seq = max(8, mb // 16)
    per = mb * (1 << 20) // n_seq // 2
    with open(path, "wb") as f:
        for i in range(n_seq):
            core = _ACGT[rng.integers(0, 4, per)]
            # each sequence = unique core + a shifted copy of it
            s = np.concatenate([core, np.frombuffer(b"NNN", np.uint8),
                                core[137:], core[:137]])
            _write_fasta_record(f, f"tid|{2000 + i}|ref|DUP_{i} synthetic", s)


def sampled_reads(idx, n: int, path: str):
    """n reads of 200-2,000 bp copied from idx's reference at random
    offsets, with substitutions at len // 10 random positions."""
    from .engine.gold.mapseed import get_ref

    rng = np.random.default_rng(7)
    total = int(idx.ref_off[-1] + idx.ref_len[-1])
    with open(path, "wb") as f:
        for k in range(n):
            ln = int(rng.integers(200, 2000))
            st = int(rng.integers(0, total - ln))
            seq = get_ref(idx.ref_bin, st, ln, True).copy()
            pos = rng.integers(0, ln, size=ln // 10)
            seq[pos] = (seq[pos] + rng.integers(1, 4, size=len(pos))) % 4
            f.write(b"@s%d\n%s\n+\n%s\n"
                    % (k, _ACGT[seq].tobytes(), b"I" * ln))


def repeat_genome(path: str):
    """~300 kb genome with a 60x repeat unit (drives >=50 anchors -> M3)
    and a 1100x unit (drives the >=1000-occurrence guard). N patches
    fragment the de Bruijn graph. Returns (unit_a, unit_b)."""
    rng = np.random.default_rng(23)
    bases = np.array(list("ACGT"))
    unit_a = "".join(rng.choice(bases, size=180))   # 60 copies
    unit_b = "".join(rng.choice(bases, size=120))   # 1100 copies
    with open(path, "w") as f:
        for i, tid in enumerate([11, 22, 33]):
            seq = list("".join(rng.choice(bases, size=30000)))
            for at in range(1000, 29000, 1100):
                seq[at : at + 3] = list("NNN")
            for at in range(2000, 28000, 1300):
                seq[at:at] = list(unit_a)
            s = "".join(seq)
            if i == 0:
                # the 1100x block, copies separated by random 30bp spacers
                blocks = []
                for _ in range(1100):
                    blocks.append(unit_b)
                    blocks.append("".join(rng.choice(bases, size=30)))
                s = s + "NNN" + "".join(blocks)
            f.write(f">tid|{tid}|ref|REP_{i} synthetic\n")
            for j in range(0, len(s), 80):
                f.write(s[j : j + 80] + "\n")
    return unit_a, unit_b


def repeat_reads(path: str, unit_a: str, unit_b: str):
    """Writes the repeat corpus FASTQ; returns its [(name, seq)]: one
    read of unit-A content (every MEM fans out to ~60 anchors -> M3),
    one of unit-B content (the >=1000-occurrence guard), six random
    400 bp background reads."""
    rng = np.random.default_rng(5)
    bases = np.array(list("ACGT"))

    def mutate(s, rate):
        arr = np.frombuffer(s.encode(), np.uint8).copy()
        pos = rng.random(len(arr)) < rate
        arr[pos] = np.frombuffer(
            "".join(rng.choice(bases, size=int(pos.sum()))).encode(),
            np.uint8)
        return arr.tobytes().decode()

    flank = "".join(rng.choice(bases, size=150))
    reads = [("m3_read", mutate(unit_a + flank + unit_a, 0.02)),
             ("super_read", mutate(flank + unit_b + unit_b, 0.02))]
    for k in range(6):
        reads.append((f"bg_{k}", "".join(rng.choice(bases, size=400))))
    with open(path, "w") as f:
        for name, seq in reads:
            f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
    return reads
