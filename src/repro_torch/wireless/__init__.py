"""Wireless uplink model (Eq. 1-2): the port's own copy of
``repro.wireless.channel``, so the port imports nothing of the JAX
package. The trace generators (``repro.wireless.traces``) belong to the
serving slice and are not ported yet."""
from repro_torch.wireless.channel import (  # noqa: F401
    LinkParams, achievable_rate, db_to_lin, lin_to_db,
)
