"""Device engine: batched JAX classify pipeline (plain jax.numpy/lax,
all integer, compiled by XLA for the accelerator JAX finds).

Stage kernels (each parity-tested against engine/gold):
  - u64ops/hash64: 64-bit ops on uint32 pairs (the hash and k-mer math
    needs only shifts, adds and xors, so no int64 mode is required)
  - islands: e-kmer rolling + low-complexity filter + 2-hash existence
    probe over device-resident bit tables, batched over (reads, positions)
  - fm: FM rank over a checkpointed 4-bit block layout + batched backward
    MEM search (lax.while_loop over extension steps, whole batch per step)
"""
