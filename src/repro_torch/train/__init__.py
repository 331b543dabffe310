"""Training substrate of the port: hand-rolled AdamW, the synthetic LM data
pipeline, and the fault-tolerant training loop (``repro.train``'s)."""

from .optimizer import AdamW  # noqa: F401
