"""Digital-twin evaluation of HALDA placements, on the port.

The solver optimizes an analytic proxy for per-token latency; this package
*executes* placements against that proxy's own physics and stress-tests
them under device drift (``distilp_tpu/twin``, ported):

- ``model``  — deterministic pipeline-execution model (host numpy oracle);
- ``engine`` — Monte-Carlo perturbation engine (kernel K8 on a CUDA card,
  its plain PyTorch version on the CPU);
- ``report`` — pydantic report schemas (the JAX package's, field for field);
- ``api``    — ``evaluate_placement`` / ``robustness_report`` /
  ``rank_agreement`` / ``twin_p95_score``.

Used by ``python -m distilp_torch.cli.solver_cli evaluate``.
"""

from .api import (
    applicable_candidates,
    evaluate_placement,
    rank_agreement,
    robustness_report,
    twin_p95_score,
)
from .engine import run_monte_carlo
from .model import (
    TwinArrays,
    build_twin_arrays,
    placement_applicable,
    placement_vectors,
    simulate_placement,
)
from .report import (
    DeviceSensitivity,
    DeviceTwinRow,
    RobustnessReport,
    TwinEvaluation,
)

__all__ = [
    "evaluate_placement",
    "robustness_report",
    "rank_agreement",
    "twin_p95_score",
    "applicable_candidates",
    "run_monte_carlo",
    "TwinArrays",
    "build_twin_arrays",
    "placement_applicable",
    "placement_vectors",
    "simulate_placement",
    "RobustnessReport",
    "TwinEvaluation",
    "DeviceTwinRow",
    "DeviceSensitivity",
]
