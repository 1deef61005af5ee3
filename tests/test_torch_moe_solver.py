"""MoE expert+layer co-assignment through the port's ``halda_solve``
(``device='cpu'``: the plain versions of kernels K1, K2, K3 and K7) against
the JAX package.

Mirrors ``tests/test_solver_moe.py`` (formulation invariants, the
Mixtral/GPU-heavy/residency/DeepSeek-V3 instances), the MoE cases of
``tests/test_fuzz_backends.py`` (random fleets with expert-load factors, the
GPT-OSS and Qwen3-30B-A3B families) and the MoE warm paths of
``tests/test_warm_start.py`` and ``tests/test_streaming.py`` (warm re-solves
with stored Lagrangian multipliers). Every objective is held against the
JAX package's (its JAX backend, or its HiGHS oracle for the fuzz cases)
within twice the mip gap, the band two certified solves may differ by.
"""

import copy
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("scipy")

from distilp_torch.common import load_from_profile_folder  # noqa: E402
from distilp_torch.profiler import profile_model  # noqa: E402
from distilp_torch.solver import HALDAResult, halda_solve  # noqa: E402
from distilp_torch.solver.moe import (  # noqa: E402
    adjust_model,
    build_moe_arrays,
    model_has_moe_components,
)
from distilp_torch.solver.standard_form import (  # noqa: E402
    DECOMP_STEPS_COLD,
    DECOMP_STEPS_WARM,
)
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402
from distilp_tpu.profiler.api import profile_model as jax_profile_model  # noqa: E402
from distilp_tpu.solver import halda_solve as jax_halda_solve  # noqa: E402
from distilp_tpu.utils import make_synthetic_fleet as jax_fleet  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module: the plain PDHG's and IPM's many
    small batched products each open a parallel region, which with several
    test processes on few cores costs far more than the product."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

GAP = 1e-3
MIXTRAL = "tests/configs/mixtral_8x7b.json"


def _models(path):
    kw = dict(batch_sizes=[1], sequence_length=128)
    return (profile_model(path, **kw).to_model_profile(),
            jax_profile_model(path, **kw).to_model_profile())


@pytest.fixture(scope="module")
def mixtral():
    return _models(MIXTRAL)


def _fleets(M, seed, pool):
    return (make_synthetic_fleet(M, seed=seed, pool_bytes=int(pool)),
            jax_fleet(M, seed=seed, pool_bytes=int(pool)))


def _solve(devs, model, **kw):
    kw.setdefault("mip_gap", GAP)
    kw.setdefault("kv_bits", "8bit")
    return halda_solve(devs, model, device="cpu", **kw)


def _agree(ref_obj, got, gap=GAP):
    tol = 2 * gap * abs(ref_obj) + 1e-9
    assert abs(got.obj_value - ref_obj) <= tol, (
        f"port {got.obj_value} vs JAX package {ref_obj}"
    )


def _valid(r, model):
    assert r.y is not None and sum(r.y) == model.n_routed_experts
    assert all(0 <= yi <= model.n_routed_experts for yi in r.y)
    assert sum(r.w) * r.k == model.L
    assert all(0 <= n <= w for w, n in zip(r.w, r.n))


# ---------------------------------------------------------------- invariants


def test_moe_detection(mixtral):
    model, _ = mixtral
    assert model_has_moe_components(model)
    assert model.n_routed_experts == 8 and model.experts_per_token == 2
    assert model.total_moe_layers == model.L == 32


def test_adjust_model_strips_expert_cost(mixtral):
    model, _ = mixtral
    adj = adjust_model(model)
    assert adj.b_layer < 0.1 * model.b_layer
    assert adj.f_q["b_1"] < model.f_q["b_1"]
    assert adj.L == model.L and adj.n_kv == model.n_kv


def test_build_moe_arrays(mixtral):
    model, _ = mixtral
    devs = make_synthetic_fleet(4, seed=7)
    moe = build_moe_arrays(devs, model)
    assert moe.E == 8 and moe.n_moe == 32
    assert moe.g_raw.shape == (4,) and (moe.g_raw > 0).all()
    assert ((moe.eb_ram == 0) | (moe.eb_vram == 0)).all()
    assert moe.eb_vram[1] > 0 and moe.eb_ram[1] == 0


def test_moe_off_by_flag(mixtral):
    model, _ = mixtral
    devs, _ = _fleets(4, 7, 64e9)
    assert _solve(devs, model, moe=False).y is None


def test_moe_flag_requires_components(profiles_dir):
    devs, model = load_from_profile_folder(profiles_dir / "hermes_70b")
    with pytest.raises(ValueError):
        halda_solve(devs, model, moe=True, device="cpu")


def test_port_highs_oracle_solves_moe(mixtral):
    model, _ = mixtral
    devs, _ = _fleets(4, 7, 64e9)
    res = halda_solve(devs, model, kv_bits="8bit", backend="cpu", mip_gap=GAP)
    _valid(res, model)


# ---------------------------------------------------------------- against JAX


@pytest.mark.parametrize("M", [4, 8])
def test_mixtral_matches_jax(mixtral, M):
    model, jmodel = mixtral
    devs, jdevs = _fleets(M, 7, 64e9)
    ref = jax_halda_solve(jdevs, jmodel, kv_bits="8bit", backend="jax", mip_gap=GAP)
    tm = {}
    got = _solve(devs, model, timings=tm)
    assert got.certified and got.gap is not None and got.gap <= GAP
    assert tm["lp_backend"] == "ipm" and tm["decomp_steps"] == DECOMP_STEPS_COLD
    _valid(got, model)
    _agree(ref.obj_value, got)
    assert got.duals is not None and set(got.duals) == {"lam", "mu", "tau", "root_bounds"}


def test_memory_affinity(mixtral):
    """Experts concentrate on the device with memory headroom."""
    model, _ = mixtral
    devs, _ = _fleets(2, 3, 64e9)
    big, small = devs[0], devs[1]
    big.d_avail_ram = int(400e9)
    if big.d_avail_metal is not None:
        big.d_avail_metal = int(400e9)
    small.d_avail_ram = int(2e9)
    if small.d_avail_metal is not None:
        small.d_avail_metal = int(2e9)
    if small.d_avail_cuda is not None:
        small.d_avail_cuda = int(2e9)
    res = _solve(devs, model)
    assert res.y is not None and res.y[0] > res.y[1]


def _gpu_heavy(pool):
    devs = [pool[1], pool[5], pool[2], pool[6]]  # cuda, cuda, cpu, cpu
    for i, d in enumerate(devs):
        d.is_head = i == 0
        d.t_comm = 0.01
        if d.d_avail_cuda is not None:
            d.d_avail_cuda = int(250e9)
        else:
            d.scpu = {q: {b: v / 50.0 for b, v in cols.items()} for q, cols in d.scpu.items()}
    return devs


def test_gpu_heavy_fleet_experts_shift_to_accelerators(mixtral):
    model, jmodel = mixtral
    devs = _gpu_heavy(make_synthetic_fleet(8, seed=1, pool_bytes=int(64e9)))
    jdevs = _gpu_heavy(jax_fleet(8, seed=1, pool_bytes=int(64e9)))
    ref = jax_halda_solve(jdevs, jmodel, kv_bits="8bit", backend="jax", mip_gap=GAP)
    got = _solve(devs, model)
    _agree(ref.obj_value, got)
    assert got.y[0] + got.y[1] > got.y[2] + got.y[3]


def test_expert_residency_is_hard_capped(mixtral):
    model, _ = mixtral
    devs, _ = _fleets(2, 3, 4e9)
    with pytest.raises(RuntimeError, match="No feasible"):
        _solve(devs, model)


def test_deepseek_v3_flagship_certified():
    """E=256 routed experts over 32 devices: certified at 1e-3 with no
    RuntimeWarning (the decomposition bounds close the structural LP root
    gap), and within 2x the gap of the JAX package's objective."""
    model, jmodel = _models("tests/configs/deepseek_v3.json")
    assert model.n_routed_experts == 256
    devs, jdevs = _fleets(32, 11, 32e9)
    ref = jax_halda_solve(jdevs, jmodel, kv_bits="8bit", backend="jax", mip_gap=GAP)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got = _solve(devs, model)
    assert got.certified and got.gap is not None and got.gap <= GAP
    _agree(ref.obj_value, got)
    _valid(got, model)


# ---------------------------------------------------------------- fuzz


def _perturb_fleet(devs, rng):
    for d in devs:
        d.t_comm = max(0.0, d.t_comm * float(rng.uniform(0.3, 3.0)))
        d.s_disk = max(1e6, d.s_disk * float(rng.uniform(0.3, 3.0)))
        d.d_avail_ram = max(int(1e9), int(d.d_avail_ram * rng.uniform(0.5, 2.0)))
        if d.d_avail_cuda is not None:
            d.d_avail_cuda = max(int(1e9), int(d.d_avail_cuda * rng.uniform(0.5, 2.0)))
        if d.d_avail_metal is not None:
            d.d_avail_metal = max(int(1e9), int(d.d_avail_metal * rng.uniform(0.5, 2.0)))
    return devs


def _fuzz_case(seed, extreme: bool):
    """The same perturbed fleet and load factors for both packages."""
    rng = np.random.default_rng(seed)
    M = int(rng.choice([3, 4] if extreme else [3, 4, 5]))
    state = rng.bit_generator.state
    fleets = []
    for make in (make_synthetic_fleet, jax_fleet):
        rng.bit_generator.state = state
        fleets.append(_perturb_fleet(make(M, seed=seed, pool_bytes=int(96e9)), rng))
    if extreme:
        hot = int(rng.integers(M))
        factors = [0.9 * M if i == hot else 0.1 * M / (M - 1) for i in range(M)]
    else:
        factors = [float(rng.uniform(0.2, 2.5)) for _ in range(M)]
    return fleets, factors


@pytest.mark.parametrize("seed,extreme", [(7, False), (41, False), (53, False),
                                          (11, True), (29, True)])
def test_fuzz_moe_with_load_factors_agrees(mixtral, seed, extreme):
    model, jmodel = mixtral
    (devs, jdevs), factors = _fuzz_case(seed, extreme)
    ref = jax_halda_solve(jdevs, jmodel, mip_gap=GAP, kv_bits="8bit", backend="cpu",
                          load_factors=factors)
    got = _solve(devs, model, load_factors=factors)
    _agree(ref.obj_value, got)
    assert sum(got.y) == model.n_routed_experts


@pytest.mark.parametrize("cfg,M,seed,pool", [
    ("gpt_oss_20b_mxfp4", 4, 13, 8e9),
    ("qwen3_30b_a3b_8bit", 4, 17, 24e9),
])
def test_moe_families_agree(cfg, M, seed, pool):
    model, jmodel = _models(f"tests/configs/{cfg}.json")
    devs, jdevs = _fleets(M, seed, pool)
    ref = jax_halda_solve(jdevs, jmodel, mip_gap=GAP, kv_bits="8bit", backend="cpu")
    got = _solve(devs, model)
    assert got.certified
    _agree(ref.obj_value, got)
    _valid(got, model)


# ---------------------------------------------------------------- warm paths


def _drift(fleets, seed, lo, hi):
    """The same multiplicative t_comm drift on every fleet given."""
    for devs in fleets:
        rng = np.random.default_rng(seed)
        for d in devs:
            d.t_comm = max(0.0, d.t_comm * float(rng.uniform(lo, hi)))


@pytest.mark.parametrize("cfg", ["qwen15_moe_a27b", "mixtral_8x7b"])
def test_warm_equals_cold_on_moe_families(cfg):
    """A warm re-solve carrying the incumbent, the duals and the root
    iterates re-evaluates the bound (zero ascent steps) and certifies the
    same optimum as a cold solve of the drifted instance."""
    model, jmodel = _models(f"tests/configs/{cfg}.json")
    devs, jdevs = _fleets(4, 3, 48e9)
    first = _solve(devs, model)
    _drift([devs, jdevs], 17, 0.95, 1.05)
    tm = {}
    warm = _solve(devs, model, warm=first, timings=tm)
    assert warm.certified and tm["decomp_steps"] == DECOMP_STEPS_WARM
    cold = jax_halda_solve(jdevs, jmodel, mip_gap=GAP, kv_bits="8bit", backend="jax")
    assert abs(warm.obj_value - cold.obj_value) <= GAP * abs(cold.obj_value)
    if model.n_routed_experts:
        assert sum(warm.y) == model.n_routed_experts


def test_moe_warm_ticks_use_stored_duals_and_certify(mixtral):
    model, jmodel = mixtral
    devs, jdevs = _fleets(4, 7, 64e9)
    prev = _solve(devs, model)
    assert prev.duals is not None
    n_k = len(prev.duals["lam"])
    assert len(prev.duals["mu"]) == n_k
    assert len(prev.duals["tau"]) == n_k and len(prev.duals["tau"][0]) == len(devs)
    assert all(np.isfinite(prev.duals["lam"]))
    for tick in range(3):
        _drift([devs, jdevs], 3 + tick, 0.9, 1.1)
        tm = {}
        prev = _solve(devs, model, warm=prev, timings=tm)
        assert tm["decomp_steps"] == DECOMP_STEPS_WARM
        assert prev.certified and prev.gap is not None and prev.gap <= GAP
        assert prev.duals is not None
        _valid(prev, model)
    cold = jax_halda_solve(jdevs, jmodel, mip_gap=GAP, kv_bits="8bit", backend="jax")
    _agree(cold.obj_value, prev)


def test_moe_duals_without_usable_warm_hint_run_the_ascent(mixtral):
    """Duals whose shapes match but a hint whose k left the grid: the zero-
    step mode must not engage (it skips the Lagrangian-primal incumbent)."""
    model, _ = mixtral
    devs, _ = _fleets(4, 7, 64e9)
    prev = _solve(devs, model, k_candidates=[1, 2])
    assert prev.duals is not None and prev.k in (1, 2)
    tm = {}
    got = _solve(devs, model, k_candidates=[4, 8], warm=prev, timings=tm)
    assert tm["decomp_steps"] == DECOMP_STEPS_COLD
    assert got.certified and got.k in (4, 8)
    _valid(got, model)


def test_warm_moe_from_dense_hint_repairs_y(mixtral):
    model, _ = mixtral
    devs, _ = _fleets(4, 7, 64e9)
    cold = _solve(devs, model)
    hint = cold.model_copy(update={"y": None, "duals": None})
    warm = _solve(devs, model, warm=hint)
    _valid(warm, model)
    assert abs(warm.obj_value - cold.obj_value) <= GAP * abs(cold.obj_value)


def test_duals_blob_crosses_packages_both_ways(mixtral):
    """A result (with its duals) of either package warm-starts the other:
    same keys, same shapes, and each re-certifies the drifted fleet."""
    model, jmodel = mixtral
    devs, jdevs = _fleets(4, 7, 64e9)
    j_first = jax_halda_solve(jdevs, jmodel, mip_gap=GAP, kv_bits="8bit", backend="jax")
    p_first = _solve(devs, model)
    assert set(j_first.duals) == set(p_first.duals)
    _drift([devs, jdevs], 23, 0.95, 1.05)
    blob = {f: copy.deepcopy(getattr(j_first, f))
            for f in ("w", "n", "k", "obj_value", "sets", "y", "duals")}
    tm = {}
    p_warm = _solve(devs, model, warm=HALDAResult(**blob), timings=tm)
    assert tm["decomp_steps"] == DECOMP_STEPS_WARM and p_warm.certified
    from distilp_tpu.solver.result import HALDAResult as JaxResult

    blob = {f: copy.deepcopy(getattr(p_first, f))
            for f in ("w", "n", "k", "obj_value", "sets", "y", "duals")}
    j_warm = jax_halda_solve(jdevs, jmodel, mip_gap=GAP, kv_bits="8bit", backend="jax",
                             warm=JaxResult(**blob))
    assert j_warm.certified
    assert abs(p_warm.obj_value - j_warm.obj_value) <= 2 * GAP * abs(j_warm.obj_value)


# ---------------------------------------------------------------- the API


def test_moe_api_rules(mixtral):
    model, _ = mixtral
    devs, _ = _fleets(4, 7, 64e9)
    with pytest.raises(ValueError, match="one entry per device"):
        _solve(devs, model, load_factors=[1.0])
    with pytest.raises(ValueError, match="batch_size"):
        _solve(devs, model, batch_size=2)
    # MoE on the PDHG engine (K5's per-element entry) meets the JAX
    # package's pin (halda_solve(..., lp_backend="pdhg", backend="jax")).
    tm = {}
    r = _solve(devs, model, lp_backend="pdhg", timings=tm)
    assert tm["lp_backend"] == "pdhg" and r.certified and r.k == 4
    _agree(-132.93320566181376, r)
    # The margin chain is ported: a full evaluation stores its anchor.
    ms = {}
    assert _solve(devs, model, margin_state=ms).certified
    assert {"m_y", "rd", "duals"} <= set(ms) and ms["used"] is False
