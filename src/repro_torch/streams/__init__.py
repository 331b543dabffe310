"""Bursty event-stream substrate: generators modelled on the paper's four
evaluation datasets."""

from .generator import (  # noqa: F401
    StreamConfig, ridesharing_stream, stock_stream, smarthome_stream,
    nyc_taxi_stream, bursty_stream, OverloadStreamConfig, overload_stream,
)
