"""Distribution substrate of the port.

The engine's pane-batch sharding hook
(:func:`~repro_torch.distributed.sharding.pane_bucket_shards`) and the
training loop's checkpointing (:mod:`~repro_torch.distributed.checkpoint`).
The JAX package's mesh rules, compression and pipeline are collectives over
a mesh of devices and are not ported yet.
"""

from .sharding import pane_bucket_shards  # noqa: F401
