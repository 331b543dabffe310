"""Model zoo: the 10 assigned architectures as one composable PyTorch stack
(GQA/SWA attention, MoE, Mamba2, RWKV6, enc-dec), the port of
``repro.models``'s serving part."""

from .lm import LM, decode_fn, init_cache, prefill_fn  # noqa: F401
