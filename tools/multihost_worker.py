"""One process of a multi-host (DCN) classify run.

The reference is strictly single-host (pthreads + shared RAM,
src/lib/kthread.c:32-57); this worker is the multi-host analogue per
parallel/distributed.py: `dp` (reads) spans processes — the DCN carries
only the input scatter and the ordered result gather — while the
index-sharded kernels run on each process's local devices.

Protocol (every process runs the same program):
  1. jax.distributed.initialize via parallel.distributed.initialize.
  2. host_mesh() over the GLOBAL device set; a shard_map psum across
     ``dp`` on that mesh is executed as a DCN liveness/correctness
     check (each process contributes its read count; all must agree on
     the total).
  3. Input scatter: process k classifies the contiguous read slice
     [k*ceil(n/P), (k+1)*ceil(n/P)). Bit-parity with a single-process
     run is guaranteed by seeding the stream state with the prefix-max
     read length before the slice (src/cly.h:157 max_read_l is the only
     cross-read state; same trick as gold classify_records threads=N).
  4. Each process classifies its slice with MeshClassifier on its LOCAL
     submesh (dp x idx over local devices).
  5. Ordered result gather: SAM bytes are allgathered over DCN
     (multihost_utils.process_allgather, length-padded); process 0
     concatenates the slices in process order and writes --out.

Launched by tests/test_multihost.py as 2 localhost processes on the
virtual CPU platform (--local-devices virtual CPU devices each).
"""
import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--index", required=True)
    ap.add_argument("--reads", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--n-idx", type=int, default=2,
                    help="idx axis size within each host")
    args = ap.parse_args()

    # virtual CPU devices: set before the first backend use
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count="
                                 f"{args.local_devices}")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    from desamba_tpu.compile_cache import enable_compile_cache
    from desamba_tpu.engine.gold.classify import Options
    from desamba_tpu.index.store import load_index
    from desamba_tpu.io.fastx import read_fastx_fast as read_fastx
    from desamba_tpu.io.sam import format_result
    from desamba_tpu.parallel.classifier import MeshClassifier
    from desamba_tpu.parallel.distributed import host_mesh, initialize
    from desamba_tpu.parallel.mesh import make_mesh

    enable_compile_cache()
    assert initialize(args.coordinator, args.num_processes,
                      args.process_id), "distributed bootstrap failed"
    pid = jax.process_index()
    assert pid == args.process_id
    devs = jax.devices()
    assert len(devs) == args.num_processes * args.local_devices

    # global mesh: idx never crosses a process (checked), dp spans them
    gmesh = host_mesh(n_idx=args.n_idx)
    for row in gmesh.devices:
        assert len({d.process_index for d in row}) == 1, \
            "idx axis crossed a process boundary"

    recs = list(read_fastx(args.reads))
    n = len(recs)
    per = math.ceil(n / args.num_processes)
    lo, hi = pid * per, min(n, (pid + 1) * per)
    my = recs[lo:hi]

    # DCN check on the global mesh: psum of per-process read counts
    def count(x):
        return jax.lax.psum(jax.lax.psum(x, "dp"), "idx")

    counted = jax.jit(jax.shard_map(count, mesh=gmesh,
                                    in_specs=P("dp", "idx"), out_specs=P(),
                                    check_vma=False))
    n_dp, n_idx = gmesh.shape["dp"], gmesh.shape["idx"]
    local_rows = n_dp // args.num_processes
    contrib = np.full((local_rows, n_idx), float(len(my)) / (
        local_rows * n_idx))
    x = multihost_utils.host_local_array_to_global_array(
        contrib, gmesh, P("dp", "idx"))
    total = float(np.asarray(jax.device_get(
        counted(x).addressable_data(0))))
    assert round(total) == n, (total, n)

    # classify the local slice on the local submesh
    idx = load_index(args.index)
    local = [d for d in devs if d.process_index == pid]
    lmesh = make_mesh(len(local) // args.n_idx, args.n_idx, devices=local)
    eng = MeshClassifier(idx, Options(), mesh=lmesh)
    eng.state.max_read_l = max((len(r.seq) for r in recs[:lo]), default=0)
    out = "".join(format_result(r, idx.ref_name, eng.opts)
                  for r in eng.classify_reads(my)).encode()

    # ordered gather: pad to the max slice length, allgather, reassemble
    lens = multihost_utils.process_allgather(
        np.array([len(out)], np.int64)).ravel()
    buf = np.zeros(int(lens.max()), np.uint8)
    buf[: len(out)] = np.frombuffer(out, np.uint8)
    blobs = multihost_utils.process_allgather(buf)
    if pid == 0:
        with open(args.out, "wb") as f:
            for k in range(args.num_processes):
                f.write(blobs[k, : lens[k]].tobytes())
    print(f"proc {pid}: {len(my)} reads, {len(out)} bytes; "
          f"fallback={eng.fallback_stats()}", flush=True)


if __name__ == "__main__":
    main()
