"""repro_torch.serve — DSE-as-a-service: concurrent sweep serving.

Public surface::

    from repro_torch.serve import DSEService, DSEClient, DSERequest

    svc = DSEService(Study(...))
    client = DSEClient(svc)
    result = client.query("resnet18", size_budget_kb=512, bw_budget=16)
    print(svc.stats().summary())

See ``service.py`` for the architecture (micro-batching, coalescing,
admission control, graceful degradation) and ``metrics.py`` for the
``ServiceStats`` snapshot semantics.  The port's own copy of the JAX
package's ``serve``; a service prices with the port's ``Study``, on that
study's device.
"""
from .client import DSEClient
from .metrics import ServiceMetrics, ServiceStats, percentile
from .service import (AdmissionError, DSERequest, DSEService,
                      InvalidRequest, RequestFailed, RequestTimeout,
                      ServiceError, Ticket)

__all__ = [
    "DSEClient", "DSEService", "DSERequest", "Ticket",
    "ServiceError", "AdmissionError", "InvalidRequest",
    "RequestFailed", "RequestTimeout",
    "ServiceMetrics", "ServiceStats", "percentile",
]
