"""Wireless uplink model (Eq. 1-2) and the channel and arrival trace
generators: the port's own copies of ``repro.wireless.channel`` and
``repro.wireless.traces``, so the port imports nothing of the JAX
package."""
from repro_torch.wireless.channel import (  # noqa: F401
    LinkParams, achievable_rate, db_to_lin, lin_to_db,
)
from repro_torch.wireless.traces import (  # noqa: F401
    ARRIVAL_KINDS, LM_TRACE_ARCHS, MIXED_TRACE_ARCHS, arrival_trace,
    bursty_arrivals, frame_stats, load_trace, merge_traces,
    poisson_arrivals, replay_arrivals, save_trace, split_trace,
    synth_mmobile_trace,
)
