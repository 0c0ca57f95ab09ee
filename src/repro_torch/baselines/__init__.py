"""The paper's comparison methods (§6.2). Counterpart of
``repro.baselines``: the host searches are numpy over the problem, PPO
trains its two small nets in torch on ``device``."""
from repro_torch.baselines.exhaustive import ExhaustiveSearch  # noqa: F401
from repro_torch.baselines.random_search import RandomSearch  # noqa: F401
from repro_torch.baselines.direct import DirectSearch  # noqa: F401
from repro_torch.baselines.cmaes import CMAES  # noqa: F401
from repro_torch.baselines.ppo import PPOBaseline  # noqa: F401
from repro_torch.baselines.greedy import (  # noqa: F401
    ComputeFirst, TransmitFirst,
)
