"""desamba_tpu — metagenomic long-read classification on an accelerator.

A from-scratch re-implementation of the capabilities of hitbc/deSAMBA
(sparse-approximate-match pseudo-alignment + taxonomy analysis): a
device-resident gather-table index, batched JAX classify kernels and
shard_map scale-out over several GPUs. See DESIGN.md / SURVEY.md.
"""
from .compile_cache import set_xla_flags

__version__ = "0.1.0"

# before any JAX backend starts: XLA reads XLA_FLAGS only then
set_xla_flags()
