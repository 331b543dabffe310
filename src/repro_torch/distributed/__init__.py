"""Distribution substrate of the port.

Only the engine's pane-batch sharding hook is here so far
(:func:`~repro_torch.distributed.sharding.pane_bucket_shards`); the JAX
package's mesh rules, checkpointing, compression and pipeline belong to its
LM substrate, which is not ported yet.
"""

from .sharding import pane_bucket_shards  # noqa: F401
