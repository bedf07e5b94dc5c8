"""Multi-host (DCN) bootstrap and host-aware mesh construction.

The reference is strictly single-host: pthreads over reads with the
whole index in shared RAM (src/lib/kthread.c:32-57, SURVEY §2.2). Its
RefSeq-"all" envelope (69 GB classify-time index, the reference
README.md:50) therefore needs a 69 GB-RAM machine. This scale-out
instead spans hosts with `jax.distributed`:

  - ``dp`` (reads) is laid out across *hosts* — read batches are an
    embarrassingly parallel stream, so the only DCN traffic is input
    scatter + result gather, which overlaps with compute (the
    kt_pipeline analogue, DeviceClassifier.classify_file).
  - ``idx`` (index memory) is laid out *within* a host's devices so the
    ownership-mask + psum merges of sharded index probes
    (parallel/mesh.py) ride the host's device links (NVLink), never
    DCN.

This module only arranges processes and devices; the sharded kernels in
mesh.py / classifier.py are mesh-shape-agnostic.
"""
from __future__ import annotations

import os

import numpy as np

import jax
from jax.sharding import Mesh


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Initialize jax.distributed from args or the standard env vars.

    Returns True when a multi-process runtime was initialized, False for
    single-process (no coordinator configured). Safe to call twice.
    """
    coordinator = coordinator or os.environ.get("DESAMBA_COORDINATOR")
    if coordinator is None:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("DESAMBA_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("DESAMBA_PROCESS_ID", "0"))
    try:
        jax.distributed.initialize(coordinator, num_processes, process_id)
    except RuntimeError as e:  # already initialized
        if "already" not in str(e):
            raise
    return True


def host_mesh(n_idx: int | None = None, devices=None) -> Mesh:
    """Build a (dp, idx) mesh whose ``idx`` axis never crosses hosts.

    Devices are grouped by process index; ``idx`` splits the devices of
    one process (NVLink), ``dp`` concatenates across the process groups
    (DCN) and any leftover within-process factor. With `n_idx` omitted,
    the index axis takes all devices of one process — the layout for an
    index too big for one card but fitting in one host's combined device
    memory.
    """
    devices = list(jax.devices() if devices is None else devices)
    by_proc: dict[int, list] = {}
    for d in devices:
        by_proc.setdefault(getattr(d, "process_index", 0), []).append(d)
    groups = [by_proc[k] for k in sorted(by_proc)]
    per_host = len(groups[0])
    if any(len(g) != per_host for g in groups):
        raise ValueError("uneven devices per process")
    if n_idx is None:
        n_idx = per_host
    if per_host % n_idx:
        raise ValueError(f"n_idx={n_idx} does not divide {per_host} "
                         "devices per host")
    rows = []
    for g in groups:
        # idx is the fastest-varying (innermost) factor of a host's
        # devices, so each idx group stays inside one host
        arr = np.array(g).reshape(per_host // n_idx, n_idx)
        rows.append(arr)
    grid = np.concatenate(rows, axis=0)  # (dp, idx)
    return Mesh(grid, ("dp", "idx"))
