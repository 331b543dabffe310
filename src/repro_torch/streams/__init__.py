"""Bursty event-stream substrate: generators modelled on the paper's four
evaluation datasets, multi-tenant and disordered variants, and group-key
partitioning (host numpy, bitwise the JAX package's for the same seed)."""

from .generator import (  # noqa: F401
    StreamConfig, ridesharing_stream, stock_stream, smarthome_stream,
    nyc_taxi_stream, bursty_stream, OverloadStreamConfig, overload_stream,
)
from .partition import shard_by_group  # noqa: F401
