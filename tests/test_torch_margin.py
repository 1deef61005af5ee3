"""The MoE margin fast path in the port (mirrors the JAX package's
``tests/test_margin.py``): ``margin_bounds_from_state`` equals the
reference's on the same anchor (relative error 1e-12 or less, the same
refusals), the reused bound never exceeds a fresh K7 evaluation at the
anchor's multipliers, and the replanner's margin ticks engage, certify and
keep their anchor fixed.
"""

import copy
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from distilp_torch.ops import decomp as D  # noqa: E402
from distilp_torch.profiler import profile_model  # noqa: E402
from distilp_torch.solver import StreamingReplanner, halda_solve  # noqa: E402
from distilp_torch.solver.api import _build_instance  # noqa: E402
from distilp_torch.solver.backend_torch import margin_bounds_from_state  # noqa: E402
from distilp_torch.solver.standard_form import build_standard_form, rounding_arrays_np  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402
from distilp_tpu.solver import backend_jax as BJ  # noqa: E402

GAP = 1e-3


@pytest.fixture(scope="module")
def mixtral():
    return profile_model("tests/configs/mixtral_8x7b.json", batch_sizes=[1],
                         sequence_length=128).to_model_profile()


@pytest.fixture(scope="module")
def anchor(mixtral):
    """A port cold solve's margin anchor (its y-profile, rounding data and
    multipliers) on Mixtral over 4 devices."""
    devs = make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9))
    ms: dict = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        halda_solve(devs, mixtral, kv_bits="8bit", mip_gap=GAP, device="cpu", margin_state=ms)
    assert {"m_y", "rd", "duals", "ks", "Ws"} <= set(ms)
    return devs, ms


def _tick(devs, model, factors=None):
    Ks, _, coeffs, arrays = _build_instance(devs, model, None, "8bit", None, factors)
    feasible = [(k, model.L // k) for k in Ks if model.L // k >= len(devs)]
    return build_standard_form(arrays, coeffs, feasible), rounding_arrays_np(coeffs, arrays.moe)


def _drifts(devs, rng):
    """(fleet, load factors) of drift-class ticks and of one that changes a
    byte-class field (the fleet's memory pools)."""
    out = []
    for _ in range(4):
        d2 = [copy.deepcopy(d) for d in devs]
        for d in d2:
            d.t_comm = max(0.0, d.t_comm * float(rng.uniform(0.8, 1.25)))
        out.append((d2, list(rng.uniform(0.6, 1.6, len(devs)))))
    out.append((make_synthetic_fleet(4, seed=7, pool_bytes=int(96e9)), None))
    return out


def test_margin_bounds_equal_reference_on_the_same_anchor(mixtral, anchor):
    devs, ms = anchor
    rng = np.random.default_rng(5)
    refused = 0
    for d2, factors in _drifts(devs, rng):
        sf, rd = _tick(d2, mixtral, factors)
        ours = margin_bounds_from_state(ms, rd, sf, ms["duals"])
        theirs = BJ.margin_bounds_from_state(ms, rd, sf, ms["duals"])
        assert (ours is None) == (theirs is None)
        if ours is None:
            refused += 1
            continue
        assert np.all(np.abs(ours - theirs) <= 1e-12 * np.abs(theirs))
    assert refused == 1  # the pool change, only
    # Multipliers other than the anchor's are refused by both.
    other = tuple(np.asarray(x) + 0.5 for x in ms["duals"])
    sf, rd = _tick(devs, mixtral)
    assert margin_bounds_from_state(ms, rd, sf, other) is None
    assert BJ.margin_bounds_from_state(ms, rd, sf, other) is None


def test_margin_bound_is_sound_against_a_fresh_evaluation(mixtral, anchor):
    """The reused bound never exceeds K7's fresh float64 evaluation at the
    anchor's multipliers; under t_comm drift alone it sits within the 1e-9
    slack of it."""
    devs, ms = anchor
    rng = np.random.default_rng(11)
    lam, mu, tau = (torch.tensor(np.asarray(x, np.float64)) for x in ms["duals"])
    for d2, factors in _drifts(devs, rng)[:3] + [(_drifts(devs, rng)[0][0], None)]:
        sf, rd = _tick(d2, mixtral, factors)
        reused = margin_bounds_from_state(ms, rd, sf, ms["duals"])
        p64 = D.stack_problems([D.decomp_problem(rd, sf.ks, sf.Ws, max(sf.Ws), int(rd["E"]),
                                                 torch.float64, "cpu")])
        fresh = D.eval64(p64, lam[None], mu[None], tau[None], False)[0][0].numpy()
        assert np.all(reused <= fresh + 1e-12 * np.abs(fresh))
        if factors is None:
            np.testing.assert_allclose(reused, fresh, rtol=3e-9)


def test_replanner_margin_ticks_engage_certify_and_keep_the_anchor(mixtral):
    devs = make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9))
    planner = StreamingReplanner(mip_gap=GAP, kv_bits="8bit", device="cpu")
    rng = np.random.default_rng(7)
    modes = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        planner.step(devs, mixtral)
        modes.append(planner.last_tick_mode)
        anchor_m_y = planner._margin_state["m_y"].copy()
        for _ in range(2):
            for d in devs:
                d.t_comm = max(0.0, d.t_comm * float(rng.uniform(0.95, 1.05)))
            tm = {}
            r = planner.step(devs, mixtral, timings=tm)
            modes.append(planner.last_tick_mode)
            assert r.certified and sum(r.y) == mixtral.n_routed_experts
            assert tm.get("decomp_steps") == 0
        # The anchor stays fixed on margin ticks (no decay of the chain).
        assert np.array_equal(planner._margin_state["m_y"], anchor_m_y)
        # Grown memory pools leave the drift class: a full (warm) evaluation.
        devs = make_synthetic_fleet(4, seed=7, pool_bytes=int(96e9))
        planner.step(devs, mixtral)
        modes.append(planner.last_tick_mode)
        cold = halda_solve(devs, mixtral, kv_bits="8bit", mip_gap=GAP, device="cpu")
    assert modes == ["cold", "margin", "margin", "warm"]
    assert abs(planner.last.obj_value - cold.obj_value) <= 2 * GAP * abs(cold.obj_value)
