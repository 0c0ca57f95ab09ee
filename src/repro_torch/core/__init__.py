"""The paper's primary contribution in PyTorch: constrained Bayesian
optimization for wireless split inference (GP surrogate + hybrid
acquisition + Algorithm 1), over the analytic cost substrate.
Counterpart of ``repro.core``."""
from repro_torch.core.batch_bo import (  # noqa: F401
    BatchedBayesSplitEdge, Scenario, make_hetero_scenarios,
    make_mixed_scenarios, make_vgg19_scenarios, request_archs,
    run_packed_shards, scenario_from_request,
)
from repro_torch.core.bo import BasicBO, BayesSplitEdge, BOResult  # noqa: F401
from repro_torch.core.cost_model import (  # noqa: F401
    Budgets, CostModel, DeviceParams, LayerProfile, ServerParams,
    profile_from_cnn,
)
from repro_torch.core.problem import (  # noqa: F401
    SplitInferenceProblem, UtilityParams, default_lm_problem,
    default_resnet101_problem, default_vgg19_problem, derive_lm_budgets,
)
from repro_torch.core.wholerun import WholeRunBayesSplitEdge  # noqa: F401
