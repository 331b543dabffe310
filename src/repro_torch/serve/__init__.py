"""Serving layer.

Two independent subsystems live here:

* the Hamlet **session front-end** — concurrent client sessions trickle
  event streams into one shared engine through a continuous-batching
  scheduler (:class:`ServingFrontend`, :class:`SessionHandle`,
  :class:`ContinuousBatcher`);
* the batched **token serving engine** of the LM substrate
  (:class:`ServeEngine`, :class:`Request`): request queue, gang-scheduled
  batched prefill + masked decode with per-request lengths, on the
  model's device (by default ``cuda:0``).

The front-end also speaks a real wire protocol
(:mod:`repro_torch.serve.transport`, the JAX package's byte for byte):
:class:`ServingServer` puts it on an asyncio socket with zero-copy chunk
ingest and credit-based per-session flow control; :class:`ServingClient`
is the synchronous producer/consumer counterpart.

The front-end's engine runs on its ``np_backend``/``device``; the default
is the hand-written CUDA kernels on ``cuda:0``, which raises without a GPU.
"""

from .engine import Request, ServeEngine  # noqa: F401
from .frontend import ServingFrontend  # noqa: F401
from .scheduler import ContinuousBatcher, SessionAdmission  # noqa: F401
from .session import Delivery, SessionHandle  # noqa: F401
from .transport import CreditGate, ServingClient, ServingServer  # noqa: F401
