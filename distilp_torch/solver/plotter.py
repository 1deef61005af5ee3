"""Optional k-vs-objective curve plot (matplotlib is an optional extra).

The port's copy of ``distilp_tpu/solver/plotter.py``: ``halda_solve(plot=
True)``, ``halda_solve_per_k(plot=True)`` and the CLI's ``--plot`` draw
with it; ``save_path`` writes the figure instead of showing it."""

from __future__ import annotations

from typing import List, Optional, Tuple


def plot_k_curve(
    per_k_objs: List[Tuple[int, Optional[float]]],
    k_star: Optional[int] = None,
    title: str = "HALDA: k vs objective",
    save_path: Optional[str] = None,
) -> None:
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not installed; skipping k-curve plot")
        return

    ks = [k for k, obj in per_k_objs if obj is not None]
    objs = [obj for _, obj in per_k_objs if obj is not None]
    infeasible = [k for k, obj in per_k_objs if obj is None]

    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(ks, objs, marker="o", label="objective")
    if k_star is not None:
        ax.axvline(k_star, linestyle="--", alpha=0.6, label=f"k* = {k_star}")
    for k in infeasible:
        ax.axvline(k, color="red", alpha=0.2)
    ax.set_xlabel("k (pipeline segments)")
    ax.set_ylabel("objective (s)")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    else:
        plt.show()
    plt.close(fig)
