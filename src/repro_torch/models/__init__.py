"""Model zoo: the 10 assigned architectures as one composable PyTorch stack
(GQA/SWA attention, MoE, Mamba2, RWKV6, enc-dec), the port of
``repro.models``: serving steps and the training step."""

from .lm import (LM, decode_fn, init_cache, loss_fn,  # noqa: F401
                 prefill_fn, train_step_fn)
