"""Serving runtime of the port: split execution and prefill/decode steps
(``splitpoint``, ``serve``), the streaming BO server (``stream``) and its
fault injector (``chaos``). Counterpart of ``repro.runtime`` (the fleet
front end is not ported yet)."""
from repro_torch.runtime.chaos import (  # noqa: F401
    FaultInjector, NetworkChaos, SimulatedCrash, load_events,
)
from repro_torch.runtime.stream import (  # noqa: F401
    DEGRADED_REASONS, StreamingBayesSplitEdge, StreamResult, dedup_results,
    host_degraded_result, requests_from_trace,
)
