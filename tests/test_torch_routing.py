"""Load-aware expert routing in the port (``solver/routing.py``) and the
fixed-assignment pricer (B14) against the JAX package.

- ``normalize_loads``, ``map_experts`` and ``expert_makespan`` equal the
  JAX package's on random inputs (their arithmetic is numpy in both).
- ``price_fixed_assignment``'s plain version equals the JAX package's within
  rel 1e-12, with ``+inf`` in the same places, on Mixtral 8x7B (4 devices)
  and Qwen3-30B-A3B (16 devices): the solver's own assignments and edits
  that break each validity test (sum w, w >= 1, sum y, the RAM and VRAM
  slack caps) one at a time.
- ``solve_load_aware`` on the skewed-Mixtral study instance (two hot experts
  carrying half the load, 4 devices): certified, and its realized objective
  within 2x gap of the JAX package's (the incumbents may differ inside the
  gap); at uniform loads ``realized_objective`` equals the solve's objective
  at rel 1e-6; an uncertified warm iterate is solved again cold.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from distilp_torch.profiler import profile_model  # noqa: E402
from distilp_torch.solver import halda_solve  # noqa: E402
from distilp_torch.solver import routing as R  # noqa: E402
from distilp_torch.solver.api import _build_instance  # noqa: E402
from distilp_torch.solver.moe import build_moe_arrays  # noqa: E402
from distilp_torch.solver.rounding import (  # noqa: E402
    price_fixed_assignment,
    price_fixed_assignment_reference,
    rounding_data,
)
from distilp_torch.solver.standard_form import rounding_arrays_np  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402
from distilp_tpu.profiler.api import profile_model as jprofile  # noqa: E402
from distilp_tpu.solver import backend_jax as BJ  # noqa: E402
from distilp_tpu.solver import routing as JR  # noqa: E402
from distilp_tpu.utils import make_synthetic_fleet as jfleet  # noqa: E402
from torch_price_edits import EDITS, validity_edits  # noqa: E402

GAP = 1e-3
MIXTRAL = "tests/configs/mixtral_8x7b.json"
HOT = [4.0, 4.0] + [1.0] * 6  # two hot experts carry half the routed load


def _model(cfg, jax_package=False):
    fn = jprofile if jax_package else profile_model
    return fn(cfg, batch_sizes=[1], sequence_length=128).to_model_profile()


@pytest.fixture(scope="module")
def mixtral():
    return _model(MIXTRAL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mapping_helpers_equal_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    E, M = int(rng.integers(4, 64)), int(rng.integers(1, 9))
    raw = rng.gamma(0.7, size=E)
    np.testing.assert_array_equal(R.normalize_loads(raw, E), JR.normalize_loads(raw, E))
    np.testing.assert_array_equal(R.normalize_loads(None, E), JR.normalize_loads(None, E))
    loads = R.normalize_loads(raw, E)
    y = rng.multinomial(E, np.ones(M) / M)
    g = rng.uniform(0.1, 3.0, M)
    got, ref = R.map_experts(y, g, loads), JR.map_experts(y, g, loads)
    assert got.expert_of_device == ref.expert_of_device
    np.testing.assert_array_equal(got.load_share, ref.load_share)
    np.testing.assert_array_equal(got.factors, ref.factors)
    assert R.expert_makespan(g, got) == JR.expert_makespan(g, ref)
    for bad in ([1.0] * (E - 1), [1.0] * (E - 1) + [-1.0]):
        with pytest.raises(ValueError):
            R.normalize_loads(bad, E)
    with pytest.raises(ValueError):
        R.map_experts(list(y[:-1]) + [y[-1] + 1], g, loads)


@pytest.mark.parametrize("cfg, M, seed", [
    (MIXTRAL, 4, 7),
    ("tests/configs/qwen3_30b_a3b_8bit.json", 16, 1),
])
def test_price_fixed_assignment_matches_the_jax_package(cfg, M, seed):
    model = _model(cfg)
    devs = make_synthetic_fleet(M, seed=seed, pool_bytes=int(64e9))
    _, _, coeffs, arrays = _build_instance(devs, model, None, "8bit", None, None)
    rd_np = rounding_arrays_np(coeffs, arrays.moe)
    rd = rounding_data(rd_np, "cpu")
    jrd = BJ.rounding_data(coeffs, arrays.moe)
    res = halda_solve(devs, model, mip_gap=GAP, kv_bits="8bit", device="cpu")
    W = model.L // res.k
    cases = validity_edits(W, res.w, res.n, res.y, rd_np)
    got = price_fixed_assignment(rd, res.k, W, [c[1] for c in cases], [c[2] for c in cases],
                                 [c[3] for c in cases])
    ref = [float(BJ.price_fixed_assignment(jrd, res.k, W, *c[1:])) for c in cases]
    infs = []
    for (name, *_), g, r in zip(cases, got.tolist(), ref):
        assert np.isinf(g) == np.isinf(r), name
        if np.isfinite(r):
            assert abs(g - r) <= 1e-12 * abs(r), name
        else:
            infs.append(name)
    assert np.isfinite(ref[0]) and infs == list(EDITS), infs
    assert abs(float(got[0]) + float(arrays.obj_const) - res.obj_value) <= 1e-9 * abs(
        res.obj_value)
    single = price_fixed_assignment(rd, res.k, W, res.w, res.n, res.y)
    assert single.dim() == 0 and float(single) == float(got[0])
    batch = price_fixed_assignment_reference(
        rd, torch.full((2,), float(res.k), dtype=torch.float64),
        torch.full((2,), float(W), dtype=torch.float64),
        *(torch.tensor([c, c], dtype=torch.float64) for c in (res.w, res.n, res.y)),
    )
    assert batch.tolist() == [float(got[0])] * 2


def test_solve_load_aware_matches_the_jax_package(mixtral):
    devs = make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9))
    E = mixtral.n_routed_experts
    result, mapping, realized = R.solve_load_aware(
        devs, mixtral, expert_loads=HOT, iters=2, kv_bits="8bit", mip_gap=GAP, device="cpu",
    )
    assert result.certified and sum(result.y) == E and np.isfinite(realized)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jres, jmap, jreal = JR.solve_load_aware(
            jfleet(4, seed=7, pool_bytes=int(64e9)), _model(MIXTRAL, True),
            expert_loads=HOT, iters=2, kv_bits="8bit", mip_gap=GAP, backend="jax",
        )
    assert abs(realized - jreal) <= 2 * GAP * abs(jreal), (realized, jreal)
    # The hot experts sit on devices whose per-unit busy is below average.
    g = build_moe_arrays(devs, mixtral).g_raw
    host_of = {e: i for i, ids in enumerate(mapping.expert_of_device) for e in ids}
    assert all(g[host_of[e]] <= np.mean(g) for e in (0, 1))
    # The HiGHS backend selects on the makespan and reports no realized value.
    r_cpu, m_cpu, real_cpu = R.solve_load_aware(
        devs, mixtral, expert_loads=HOT, iters=2, kv_bits="8bit", mip_gap=GAP, backend="cpu",
    )
    assert real_cpu is None and sum(r_cpu.y) == E
    assert abs(r_cpu.obj_value - result.obj_value) <= 2 * GAP * abs(r_cpu.obj_value) or \
        R.expert_makespan(g, m_cpu) <= R.expert_makespan(g, mapping) + 1e-12


def test_realized_objective_at_uniform_loads_is_the_objective(mixtral):
    devs = make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9))
    E = mixtral.n_routed_experts
    result = halda_solve(devs, mixtral, kv_bits="8bit", mip_gap=GAP, moe=True, device="cpu")
    g = build_moe_arrays(devs, mixtral).g_raw
    uni = R.map_experts(result.y, g, R.normalize_loads(None, E))
    assert np.allclose(uni.factors, 1.0)
    val = R.realized_objective(devs, mixtral, result, uni, kv_bits="8bit", device="cpu")
    assert val == pytest.approx(result.obj_value, rel=1e-6)
    skewed = R.map_experts(result.y, g, R.normalize_loads(HOT, E))
    assert np.isfinite(R.realized_objective(devs, mixtral, result, skewed, kv_bits="8bit",
                                            device="cpu"))


def test_uncertified_warm_iterate_is_solved_again_cold(monkeypatch, mixtral):
    from distilp_torch.solver import api

    devs = make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9))
    E = mixtral.n_routed_experts
    calls = []
    real = api.halda_solve

    def spy(*args, **kwargs):
        result = real(*args, **kwargs)
        warm = kwargs.get("warm") is not None
        calls.append(warm)
        return result.model_copy(update={"certified": False}) if warm else result

    monkeypatch.setattr(api, "halda_solve", spy)
    result, _, _ = R.solve_load_aware(
        devs, mixtral, expert_loads=[5.0] + [1.0] * (E - 1), iters=2, kv_bits="8bit",
        mip_gap=GAP, device="cpu",
    )
    assert calls == [False, True, False] and result.certified


def test_solve_load_aware_refuses_what_it_manages(mixtral):
    devs = make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9))
    for kw in ({"moe": True}, {"warm": None}, {"load_factors": [1.0] * 4}):
        with pytest.raises(TypeError, match="manages"):
            R.solve_load_aware(devs, mixtral, expert_loads=None, **kw)
    with pytest.raises(ValueError, match="batch"):
        R.solve_load_aware(devs, mixtral, batch_size=2)
