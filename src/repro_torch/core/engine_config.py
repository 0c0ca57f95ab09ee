"""One shared engine configuration for the three BO engines. Counterpart
of ``repro/core/engine_config.py``, with the same fields.

``BatchedBayesSplitEdge``, ``WholeRunBayesSplitEdge`` and
``StreamingBayesSplitEdge`` historically each grew their own copy of the
same ~10 BO-engine keyword arguments (init-design size, acquisition
weights, GP config, ablation toggles, staging layout). ``EngineConfig``
is the single frozen dataclass all three consume: engine-specific knobs
(mesh, lane counts, serving policies, checkpoint dirs) stay per-engine
keyword arguments, but everything that defines *the BO run itself* —
including the ``surrogate`` plug — lives here, so a config tuned on
the offline engines drops into the server unchanged.

Deprecation (release note, also in ``docs/engine.md``): passing these
knobs as individual keyword arguments (``n_init=``, ``gp_cfg=``, ...)
still works through :func:`resolve_config` — the values fold over the
given/default ``EngineConfig`` — but emits a ``DeprecationWarning``.
New code passes ``config=EngineConfig(...)``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

from repro_torch.core import gp as gpm
from repro_torch.core import surrogate as smod
from repro_torch.core.acquisition import AcqWeights


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The BO-engine knobs shared by all three engines.

    Frozen (hashable), so one instance can be reused across engines
    without aliasing. Engines ignore fields outside their feature set
    (``compact`` means nothing to the batched engine) — the point is that
    ONE config describes the run everywhere.
    """
    n_init: int = 9                  # init-design size
    n_max_repeat: int = 5            # incumbent-repeat early stop
    weights: AcqWeights = AcqWeights()
    gp_cfg: gpm.GPConfig = gpm.GPConfig()
    grid_n: int = 64                 # acquisition candidate grid side
    constraint_aware: bool = True
    use_grad_term: bool = True
    use_schedules: bool = True
    warm_start: bool = True          # warm GP refits (wholerun/stream)
    l_pad: Optional[int] = None      # padded layer count (None: batch L_max)
    pack: bool = False               # architecture-aware lane packing
    compact: bool = True             # between-phase lane compaction
    # pluggable surrogate model: None is the exact GP — the
    # bitwise-historical default; see core/surrogate.py
    surrogate: Optional[smod.Surrogate] = None

    def acq_weights(self) -> AcqWeights:
        """Effective acquisition weights after the ablation toggles
        (the transform every engine applied by hand before)."""
        w = self.weights
        if not self.use_grad_term:
            w = dataclasses.replace(w, lam_g0=0.0, lam_gT=1e-9)
        if not self.constraint_aware:
            w = dataclasses.replace(w, lam_p=0.0)
        return w


FIELD_NAMES = tuple(f.name for f in dataclasses.fields(EngineConfig))


def resolve_config(config: Optional[EngineConfig], kw: dict,
                   engine: str) -> EngineConfig:
    """The constructors' deprecation shim: pop every ``EngineConfig``
    field found in ``kw`` (mutating it — whatever remains is the
    engine's own keyword surface, or a genuine ``TypeError``) and fold
    the popped values over ``config`` (or the defaults). Old call sites
    keep working bit-for-bit; they just warn."""
    legacy = {k: kw.pop(k) for k in list(kw) if k in FIELD_NAMES}
    if legacy:
        warnings.warn(
            f"{engine}: passing engine knobs as individual keyword "
            f"arguments ({', '.join(sorted(legacy))}) is deprecated — "
            f"pass config=EngineConfig(...) instead (docs/engine.md, "
            f"'One EngineConfig')", DeprecationWarning, stacklevel=3)
        config = dataclasses.replace(config or EngineConfig(), **legacy)
    return config if config is not None else EngineConfig()
