"""Serving runtime of the port: split execution and prefill/decode steps
(``splitpoint``, ``serve``), the streaming BO server (``stream``), its
fault injector (``chaos``) and the fleet front end over simulated and
socket transports (``fleet``). Counterpart of ``repro.runtime``."""
from repro_torch.runtime.chaos import (  # noqa: F401
    FaultInjector, NetworkChaos, SimulatedCrash, load_events,
)
from repro_torch.runtime.fleet import (  # noqa: F401
    ENVELOPE_KINDS, ROUTER, Envelope, FleetRouter, FleetWorker,
    SimTransport, SocketTransport, Transport, sim_fleet, socket_fleet,
)
from repro_torch.runtime.stream import (  # noqa: F401
    DEGRADED_REASONS, StreamingBayesSplitEdge, StreamResult, dedup_results,
    host_degraded_result, requests_from_trace,
)
