"""Lane compaction for lockstep VMs (ladder, rescore).

The device engines compact their active lanes to a static width before
each heavy iteration step (gather state -> work at width k -> scatter
back). The selection is a cumsum scan plus a k-wide scatter instead of
`jax.lax.top_k(where(mask, B-i, 0), k)`, which lowers to a full sort;
both select the first k active lanes in ascending lane order.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

I32 = jnp.int32


def compact_rows(mask, k: int):
    """Indices of the first k True lanes of `mask`, ascending.

    Returns (rows_g, rows_s, valid):
      rows_g (k,) int32 — gather indices (0 at empty slots);
      rows_s (k,) int32 — scatter indices (B at empty slots, which jax
        scatter drops as out-of-bounds — no dump row needed);
      valid  (k,) bool — live compact slots.
    """
    B = mask.shape[0]
    pos = jnp.cumsum(mask.astype(I32)) - 1
    take = mask & (pos < k)
    lanes = jnp.arange(B, dtype=I32)
    dest = jnp.where(take, pos, k)  # k = out of bounds -> dropped
    rows_s = jnp.full((k,), B, I32).at[dest].set(lanes, mode="drop")
    valid = rows_s < B
    rows_g = jnp.where(valid, rows_s, 0)
    return rows_g, rows_s, valid


def gather_rows(full_tree, rows_g):
    """Compact: per-array row gather."""
    return jax.tree.map(lambda f: f[rows_g], full_tree)


def scatter_rows(full_tree, comp_tree, rows_s):
    """Write compact rows back. Empty slots carry index B (out of
    bounds) and are dropped by jax scatter semantics — this replaces
    the concatenate-pad-then-slice pattern, saving two full-array
    copies per array per iteration."""
    return jax.tree.map(lambda f, c: f.at[rows_s].set(c),
                        full_tree, comp_tree)


def compact_cols(mask, k: int):
    """Row-wise variant: first k True columns per row, ascending.

    mask (B, N) -> (cols_g, valid): cols_g (B, k) int32 gather columns
    (0 at empty slots), valid (B, k) bool. Replaces per-row
    `top_k(where(mask, N - col, 0), k)` (a width-N sort per row)."""
    B, N = mask.shape
    pos = jnp.cumsum(mask.astype(I32), axis=1) - 1
    take = mask & (pos < k)
    cols = jnp.broadcast_to(jnp.arange(N, dtype=I32)[None, :], (B, N))
    dest = jnp.where(take, pos, k)
    rows = jnp.broadcast_to(jnp.arange(B, dtype=I32)[:, None], (B, N))
    buf = jnp.full((B, k), N, I32).at[rows, dest].set(cols, mode="drop")
    valid = buf < N
    return jnp.where(valid, buf, 0), valid
