"""Distribution substrate of the port: sharding rules (DP/TP/EP/SP/CP and
the pod axis) and the pane-batch sharding hook, checkpointing with elastic
resharding, error-feedback int8 gradient compression, a GPipe pipeline,
their collectives over a caller's process group, and spawned ranks on one
host.  The JAX package's ``compat.py`` (a ``shard_map`` shim across jax
versions) has no counterpart: torch has nothing to shim."""

from .compression import (compressed_psum_tree, dequantize_int8,  # noqa: F401
                          dp_compressed_step_fn, ef_compress_tree,
                          quantize_int8)
from .pipeline import pipelined_apply, sequential_apply  # noqa: F401
from .sharding import (batch_pspecs, cache_pspecs, explain,  # noqa: F401
                       pane_batch_pspecs, pane_bucket_shards, param_pspecs,
                       shard_pane_bucket, shardings_for)
