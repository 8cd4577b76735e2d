"""Online serving plane: request-scale reads from live training state.

Counterpart of ``harmony_tpu/serving/``. A
:class:`~harmony_tpu_torch.serving.service.ServingEndpoint` rides the
jobserver (started on demand by its ``SERVING`` command) and answers framed
lookup streams against the SAME storage the trainers update: micro-batched
onto the table's K1 gather, cached in a bytes-bounded hot-row tier, and
readable in two consistency modes (``live`` and checkpoint-``pinned``).
"""
from harmony_tpu_torch.serving.client import ServingClient
from harmony_tpu_torch.serving.service import ServingEndpoint

__all__ = ["ServingClient", "ServingEndpoint"]
