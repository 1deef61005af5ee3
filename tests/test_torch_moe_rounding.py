"""The MoE part of the port's rounding (plain version of kernel K2's MoE
mode) against the JAX package's ``_round_to_incumbent(moe=True)``.

Three modes, on seeded rows: LP points (floor + largest-remainder
redistribution of y, 8 expert-move steps), Lagrangian-primal hints
(``y_steps = E + 4`` exact-priced repair steps) and warm rows (integer
points, 2 move steps). Objectives within 1e-12 relative (the port sums the
devices' costs in device order, the reference in XLA's order); the integer
vectors equal, or, where a tie broke another way, pricing equal under the
reference's own ``price_fixed_assignment``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from distilp_torch.profiler import profile_model  # noqa: E402
from distilp_torch.solver import rounding as R  # noqa: E402
from distilp_torch.solver.api import _build_instance  # noqa: E402
from distilp_torch.solver.standard_form import (  # noqa: E402
    MOE_LOCAL_MOVES,
    MOE_LOCAL_MOVES_WARM,
    rounding_arrays_np,
)
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402
from distilp_tpu.solver import backend_jax as BJ  # noqa: E402

TOL = 1e-12
CASES = {
    "mixtral_M4": ("mixtral_8x7b", 4, 7, 64e9),
    "qwen3_30b_a3b_M8": ("qwen3_30b_a3b_8bit", 8, 1, 64e9),
}
B = 12


def _instance(name):
    cfg, M, seed, pool = CASES[name]
    model = profile_model(
        f"tests/configs/{cfg}.json", batch_sizes=[1], sequence_length=128
    ).to_model_profile()
    devs = make_synthetic_fleet(M, seed=seed, pool_bytes=int(pool))
    Ks, _, coeffs, arrays = _build_instance(devs, model, None, "8bit", None, None)
    feas = [(k, model.L // k) for k in Ks if model.L // k >= M]
    return M, feas, rounding_arrays_np(coeffs, arrays.moe), arrays.layout.n_vars + 6 * M


def _rows(M, feas, E, nf, mode, seed=1):
    """B seeded rows: near-feasible LP points (w summing near W, n in
    [0, w], y summing near E); warm rows are their integer roundings."""
    rng = np.random.default_rng(seed)
    kidx = rng.integers(0, len(feas), B)
    W = np.array([feas[j][1] for j in kidx], np.float64)
    k = np.array([feas[j][0] for j in kidx], np.float64)
    v = np.zeros((B, nf))
    for r in range(B):
        w = rng.dirichlet(np.ones(M)) * (W[r] - M) + 1.0
        v[r, :M] = w
        v[r, M : 2 * M] = w * rng.random(M)
        v[r, 2 * M : 3 * M] = rng.dirichlet(np.ones(M)) * E * rng.uniform(0.6, 1.4)
    if mode == "warm":
        v[:, : 3 * M] = np.round(v[:, : 3 * M])
    return v, W, k


MODES = {
    "lp": {"moves": MOE_LOCAL_MOVES},
    "hint": {"y_steps": None, "moves": MOE_LOCAL_MOVES},  # y_steps set to E + 4
    "warm": {"moves": MOE_LOCAL_MOVES_WARM},
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(CASES))
def test_moe_rounding_matches_jax(name, mode):
    M, feas, rd_np, nf = _instance(name)
    E = float(rd_np["E"])
    kw = dict(MODES[mode])
    if mode == "hint":
        kw["y_steps"] = int(E) + 4
    v, W, k = _rows(M, feas, E, nf, mode)
    jrd = BJ.RoundingData(**{f: jnp.asarray(x, jnp.float64) for f, x in rd_np.items()})
    ref = jax.vmap(
        lambda vr, Wr, kr: BJ._round_to_incumbent(vr, M, Wr, kr, jrd, moe=True, **kw)
    )(jnp.asarray(v), jnp.asarray(W), jnp.asarray(k))
    ref = [np.asarray(x) for x in ref]
    got = R.round_to_incumbent(
        torch.tensor(v), torch.tensor(W), torch.tensor(k),
        R.rounding_data(rd_np, "cpu"), moe=True, **kw,
    )
    got = [x.numpy() for x in got]
    assert np.array_equal(np.isfinite(got[0]), np.isfinite(ref[0]))
    fin = np.isfinite(ref[0])
    assert fin.any(), "no row rounded to a feasible point"
    assert np.max(np.abs(got[0][fin] - ref[0][fin]) / np.abs(ref[0][fin])) <= TOL
    assert np.array_equal(got[1], ref[1]) and np.array_equal(got[2], ref[2])
    differ = np.nonzero((got[3] != ref[3]).any(axis=1))[0]
    for r in differ:
        # A tie the two sums broke apart: the port's vector must price as
        # the reference's under the reference's own pricer.
        price = float(BJ.price_fixed_assignment(jrd, k[r], W[r], got[1][r], got[2][r], got[3][r]))
        assert abs(price - ref[0][r]) <= TOL * abs(ref[0][r])
    assert np.all(got[3][fin].sum(axis=1) == E)


def test_moe_rounding_dense_call_keeps_its_output():
    """Without ``moe`` the rounding returns (obj, w, n), as before."""
    M, feas, rd_np, nf = _instance("mixtral_M4")
    v, W, k = _rows(M, feas, float(rd_np["E"]), nf, "lp")
    out = R.round_to_incumbent(torch.tensor(v), torch.tensor(W), torch.tensor(k),
                               R.rounding_data(rd_np, "cpu"))
    assert len(out) == 3


def test_hint_repair_reaches_E_from_far_off():
    """A hint short of E by more than M experts is repaired to sum E."""
    M, feas, rd_np, nf = _instance("qwen3_30b_a3b_M8")
    E = float(rd_np["E"])
    v, W, k = _rows(M, feas, E, nf, "lp", seed=3)
    v[:, 2 * M : 3 * M] *= 0.3  # ~90 experts short
    got = R.round_to_incumbent(torch.tensor(v), torch.tensor(W), torch.tensor(k),
                               R.rounding_data(rd_np, "cpu"), moe=True,
                               y_steps=int(E) + 4)
    fin = torch.isfinite(got[0])
    assert bool(fin.any())
    assert bool((got[3][fin].sum(1) == E).all())
