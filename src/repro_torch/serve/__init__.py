"""Serving layer: the Hamlet session front-end.

Concurrent client sessions trickle event streams into one shared engine
through a continuous-batching scheduler (:class:`ServingFrontend`,
:class:`SessionHandle`, :class:`ContinuousBatcher`).  The front-end also
speaks a real wire protocol (:mod:`repro_torch.serve.transport`, the JAX
package's byte for byte): :class:`ServingServer` puts it on an asyncio
socket with zero-copy chunk ingest and credit-based per-session flow
control; :class:`ServingClient` is the synchronous producer/consumer
counterpart.

The engine runs on the front-end's ``np_backend``/``device``; the default
is the hand-written CUDA kernels on ``cuda:0``, which raises without a GPU.
The JAX package's batched token engine (``ServeEngine``, ``Request``)
belongs to its LM substrate and is not ported yet.
"""

from .frontend import ServingFrontend  # noqa: F401
from .scheduler import ContinuousBatcher, SessionAdmission  # noqa: F401
from .session import Delivery, SessionHandle  # noqa: F401
from .transport import CreditGate, ServingClient, ServingServer  # noqa: F401
