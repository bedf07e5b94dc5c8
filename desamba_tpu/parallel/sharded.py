"""Row-range sharding of the gather-table index across the ``idx`` axis.

The reference replicates its whole index in every process's RAM
(SURVEY §2.2); its RefSeq-"all" classify envelope is 69 GB (the
reference README.md:50), beyond one card's memory. This layout splits
every large gather table by row range over the
mesh ``idx`` axis and answers each gather with the ownership-mask +
psum pattern already used for the existence-filter tables
(parallel/mesh.py): every device computes the local part of the gather
(zero where it does not own the row) and a ``psum`` over ``idx``
(over NVLink) reconstructs the values everywhere.

``ShardedArray`` carries one device's shard inside a ``shard_map``
body and reproduces the *global* array's ``__getitem__`` / ``shape``,
so the classify kernels (fm, mapseed, textwalk, rescore) run unchanged
on sharded tables. Collectives inside the engines' ``lax.while_loop``
bodies stay aligned because the lane arrays are sharded over ``dp``
only — every device in an ``idx`` group executes the same reads, hence
the same trip counts.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

I32 = jnp.int32


@jax.tree_util.register_pytree_node_class
class ShardedArray:
    """One device's row-range shard of a global gather table.

    ``shard`` is a 1-D slice of the FLATTENED global array (row-major);
    ``global_shape`` is the unflattened global shape for ``.shape`` /
    bound queries. Supports the index forms the engine kernels use:
    ``a[i]`` (i any int array or scalar) and ``a[0, i]`` for
    (1, W)-shaped packed tables. Out-of-range rows contribute zeros
    locally; exactly one shard owns each in-range row.
    """

    def __init__(self, shard, global_shape, axis: str = "idx"):
        self.shard = shard
        self.global_shape = tuple(global_shape)
        self.axis = axis

    # ---- pytree ------------------------------------------------------------
    def tree_flatten(self):
        return (self.shard,), (self.global_shape, self.axis)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1])

    # ---- array-like surface ------------------------------------------------
    @property
    def shape(self):
        return self.global_shape

    @property
    def dtype(self):
        return self.shard.dtype

    def reshape(self, *shape):
        if len(shape) == 1 and not isinstance(shape[0], int):
            shape = tuple(shape[0])
        n = math.prod(self.global_shape)
        if len(shape) == 2 and shape[0] == -1 and shape[1] > 0:
            # blocked row view (e.g. the 9-word FM blocks): legal for any
            # row_b dividing ROW_ALIGN, so shard boundaries stay row-aligned
            return ShardedArray(self.shard, (n,), self.axis).as_rows(shape[1])
        assert shape == (-1,), "ShardedArray only supports reshape(-1)/(-1,n)"
        return ShardedArray(self.shard, (n,), self.axis)

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            # (0, i) on a (1, W) packed table -> flat index i
            assert len(idx) == 2 and self.global_shape[0] == 1
            idx = idx[1]
        idx = jnp.asarray(idx)
        sh = self.shard.shape[0]
        me = jax.lax.axis_index(self.axis) * sh
        loc = idx - me
        own = (loc >= 0) & (loc < sh)
        v = self.shard[jnp.where(own, loc, 0)]
        z = jnp.where(own, v, jnp.zeros((), v.dtype))
        if z.dtype.itemsize < 4:  # u8 bitmaps: reduce in 32-bit
            return jax.lax.psum(z.astype(jnp.int32),
                                self.axis).astype(v.dtype)
        return jax.lax.psum(z, self.axis)

    def as_rows(self, row_b: int) -> "ShardedRows":
        """Row view: global flat array as (NR, row_b) rows.

        Requires the local shard length to divide by row_b —
        ``_flat_pad`` pads every placement to ``n_idx * ROW_ALIGN``
        elements so shard boundaries are always row-aligned."""
        assert len(self.global_shape) == 1
        assert self.shard.shape[0] % row_b == 0, (
            f"shard len {self.shard.shape[0]} not divisible by {row_b}")
        nr = -(-self.global_shape[0] // row_b)
        return ShardedRows(self.shard.reshape(-1, row_b), nr, self.axis)


@jax.tree_util.register_pytree_node_class
class ShardedRows:
    """Row-range-sharded (NR, row_b) view: ``a[i]`` with i (N,) returns
    (N, row_b) rows by local gather + psum over the idx axis."""

    def __init__(self, rows, n_rows: int, axis: str = "idx"):
        self.rows = rows
        self.n_rows = int(n_rows)
        self.axis = axis

    def tree_flatten(self):
        return (self.rows,), (self.n_rows, self.axis)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1])

    @property
    def shape(self):
        return (self.n_rows, self.rows.shape[1])

    @property
    def dtype(self):
        return self.rows.dtype

    def __getitem__(self, idx):
        idx = jnp.asarray(idx)
        sh = self.rows.shape[0]
        me = jax.lax.axis_index(self.axis) * sh
        loc = idx - me
        own = (loc >= 0) & (loc < sh)
        v = self.rows[jnp.where(own, loc, 0)]
        z = jnp.where(own[..., None], v, jnp.zeros((), v.dtype))
        if z.dtype.itemsize < 4:
            return jax.lax.psum(z.astype(jnp.int32),
                                self.axis).astype(v.dtype)
        return jax.lax.psum(z, self.axis)


# Index arrays big enough to be worth sharding (everything whose size
# scales with the reference collection); the rest stay replicated
# (ref_off/rank/q_mem/q_lv are O(n_ref) or O(1)).
SHARDED_IXR_FIELDS = frozenset({
    "lf", "lfc", "row_char", "row_pos", "uni_start", "uni_len",
    "uni_ref_list", "rp_global_off", "rp_ref_id", "ref_bin", "ref_pk",
    "text_pk", "sep_any", "sep_hash", "samp_bits", "isa", "pos2uni",
})


# Shard lengths are a multiple of ROW_ALIGN so as_rows(row_b) is legal
# for every row_b that divides it: all powers of two <= 256 AND the
# 9-word FM block rows (2304 = 256 * 9).
ROW_ALIGN = 2304


def _flat_pad(arr, n_idx: int):
    """Flatten row-major and zero-pad so every shard is ROW_ALIGN-long
    aligned (hence also divides n_idx)."""
    a = np.asarray(arr)
    flat = a.reshape(-1)
    pad = (-flat.shape[0]) % (n_idx * ROW_ALIGN)
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, flat.dtype)])
    return flat, a.shape


def shard_table(mesh: Mesh, arr, name: str = ""):
    """Place one gather table sharded by row range along ``idx``.

    Returns (placed_flat, global_shape). With the mesh's idx size 1 the
    placement degenerates to replication (same math, psum over a
    singleton axis)."""
    n_idx = mesh.shape["idx"]
    flat, gshape = _flat_pad(arr, n_idx)
    placed = jax.device_put(jnp.asarray(flat), NamedSharding(mesh, P("idx")))
    return placed, gshape


def wrap_local(local_flat, global_shape, axis: str = "idx") -> ShardedArray:
    """Inside a shard_map body: wrap this device's flat shard."""
    return ShardedArray(local_flat, global_shape, axis)
