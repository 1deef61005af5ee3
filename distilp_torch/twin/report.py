"""Twin report schemas: the JSON contract of the digital-twin evaluation.

The port's copy of the JAX package's twin report schemas: the same fields,
so a report dumps equal in both packages. Schema-only (pydantic, no torch,
no solver imports), so reports can be parsed, rendered and round-tripped by
processes that never touch a device.

Two documents:

- :class:`TwinEvaluation`  — one deterministic simulated execution of a
  placement: per-device busy breakdown, the pipeline cycle time, the
  predicted per-token latency, and the cross-check against the HALDA
  objective it must agree with.
- :class:`RobustnessReport` — the vmapped Monte-Carlo view: latency
  quantiles under device drift, feasibility-violation probability, and the
  worst-device sensitivity ranking.
"""

from __future__ import annotations

from typing import List, Optional

from pydantic import BaseModel


class DeviceTwinRow(BaseModel):
    """One device's simulated steady-state execution of its window."""

    name: str
    w: int  # layers hosted
    n: int  # of those, accelerator-resident
    y: Optional[int] = None  # routed experts hosted (MoE placements)
    busy_s: float  # B_i: everything below plus comm/offload constants
    compute_s: float  # a·w + b·n (+ expert share) seconds
    comm_s: float  # t_comm: per-round inter-device link time
    offload_s: float  # xi: host<->accelerator round trip (split memory)
    disk_s: float  # slack-layer streaming penalty seconds
    prefetch_s: float  # F_i: next-window disk prefetch seconds
    spill_layers: int  # layers that overflow RAM and stream from disk
    vram_spill_layers: int  # layers that overflow VRAM/wired memory
    feasible: bool  # required spill fits the placement's slack capacity


class TwinEvaluation(BaseModel):
    """Deterministic pipeline execution of one placement over one fleet."""

    k: int  # pipeline segments
    W: int  # layers per segment
    latency_s: float  # predicted per-token latency (the twin's headline)
    cycle_s: float  # steady-state cycle time C
    bottleneck: str  # device attaining the cycle bound
    feasible: bool  # all devices' spill fits their slack capacity
    # Cross-check against the analytic proxy the solver optimizes: the
    # HALDA objective of the same placement (when the caller has it) and
    # the relative disagreement. The two must agree on the golden
    # fixtures — that is the twin's conformance contract.
    objective_s: Optional[float] = None
    rel_err: Optional[float] = None
    devices: List[DeviceTwinRow] = []

    def render_text(self) -> str:
        lines = [
            "=" * 66,
            "Digital-twin execution",
            "=" * 66,
            f"k={self.k} segments x W={self.W} layers; "
            f"predicted per-token latency {self.latency_s:.6f} s "
            f"(cycle {self.cycle_s:.6f} s, bottleneck {self.bottleneck})",
        ]
        if self.objective_s is not None:
            err = f" (rel err {self.rel_err:.2e})" if self.rel_err is not None else ""
            lines.append(f"HALDA objective cross-check: {self.objective_s:.6f} s{err}")
        if not self.feasible:
            lines.append("WARNING: placement overflows memory beyond disk-slack capacity")
        lines.append("")
        lines.append(
            f"{'device':<30s} {'w':>3s} {'n':>3s} {'busy_s':>10s} "
            f"{'compute':>9s} {'disk':>8s} {'spill':>5s}"
        )
        for d in self.devices:
            flag = "" if d.feasible else "  INFEASIBLE"
            lines.append(
                f"{d.name:<30.30s} {d.w:>3d} {d.n:>3d} {d.busy_s:>10.6f} "
                f"{d.compute_s:>9.6f} {d.disk_s:>8.5f} {d.spill_layers:>5d}{flag}"
            )
        return "\n".join(lines)


class DeviceSensitivity(BaseModel):
    """Latency cost of one device degrading by the probe factor, ranked."""

    name: str
    delta_s: float  # latency increase when only this device slows down
    share: float  # delta normalized over all devices (sums to ~1)


class RobustnessReport(BaseModel):
    """Monte-Carlo what-if view of one placement under device drift.

    Produced by ``twin.api.robustness_report`` from one launch of the
    Monte-Carlo kernel: ``samples`` log-normal perturbation draws + one
    deterministic degraded run per device (the sensitivity probes) + the
    unperturbed base run, all rows of one batch.
    """

    samples: int
    seed: int
    # Log-normal jitter widths (mean-1 multiplicative noise per device).
    sigma_compute: float
    sigma_comm: float
    sigma_disk: float
    sigma_mem: float
    # Straggler/dropout scenario: with probability dropout_p a device runs
    # dropout_slowdown x slower for that sample (0 disables).
    dropout_p: float
    dropout_slowdown: float
    degrade: float  # sensitivity-probe slowdown factor
    base_latency_s: float  # unperturbed twin latency (must match objective)
    mean_s: float
    p50_s: float
    p95_s: float
    p99_s: float
    worst_s: float
    p_violation: float  # P(RAM/VRAM overflow beyond slack capacity)
    sensitivity: List[DeviceSensitivity] = []  # worst device first

    def render_text(self) -> str:
        lines = [
            "=" * 66,
            f"Robustness report ({self.samples} Monte-Carlo samples, seed {self.seed})",
            "=" * 66,
            f"jitter: compute {self.sigma_compute:.3f} / comm {self.sigma_comm:.3f} / "
            f"disk {self.sigma_disk:.3f} / mem {self.sigma_mem:.3f}"
            + (
                f"; dropout p={self.dropout_p:.3f} x{self.dropout_slowdown:.1f}"
                if self.dropout_p > 0
                else ""
            ),
            "",
            f"  base latency : {self.base_latency_s:.6f} s",
            f"  mean         : {self.mean_s:.6f} s",
            f"  p50          : {self.p50_s:.6f} s",
            f"  p95          : {self.p95_s:.6f} s",
            f"  p99          : {self.p99_s:.6f} s",
            f"  worst        : {self.worst_s:.6f} s",
            f"  P(mem violation): {self.p_violation:.4f}",
            "",
            f"Worst-device sensitivity (latency cost of a {self.degrade:.2f}x slowdown):",
        ]
        for i, s in enumerate(self.sensitivity, 1):
            lines.append(
                f"  {i:2d}. {s.name:<30.30s} +{s.delta_s:.6f} s ({s.share * 100:5.1f}%)"
            )
        return "\n".join(lines)
