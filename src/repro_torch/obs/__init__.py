"""Observability primitives the engine imports: the span tracer (``trace``)
and the metrics registry (``metrics``)."""
