"""Scenario sweeps through the port (``halda_solve_scenarios`` on
``device='cpu'``), held against the JAX package's scenario batch on the same
fleets: the same k, objectives within 2x gap, both certified; the
static-half fallback fires on the same case as the reference's; warm hints,
duals and root iterates engage only when every scenario has them.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from distilp_torch.common import load_model_profile  # noqa: E402
from distilp_torch.profiler import profile_model  # noqa: E402
from distilp_torch.solver import halda_solve_scenarios  # noqa: E402
from distilp_torch.solver import standard_form as SF  # noqa: E402
from distilp_torch.solver.api import _build_instance  # noqa: E402
from distilp_torch.solver.backend_torch import pack_static  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402
from distilp_tpu.solver import api as japi  # noqa: E402
from distilp_tpu.solver import backend_jax as BJ  # noqa: E402


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


def _online(profiles_dir, jax_side=False):
    path = profiles_dir / "llama_3_70b" / "online" / "model_profile.json"
    if jax_side:
        from distilp_tpu.common import load_model_profile as jload

        return jload(path)
    return load_model_profile(path)


def _drifted(make, M, seed, rng_seed, lo, hi, S):
    """S copies of one fleet (``make``: either package's fleet maker), each
    under its own t_comm drift drawn from ``default_rng(rng_seed)``."""
    rng = np.random.default_rng(rng_seed)
    out = []
    for _ in range(S):
        devs = make(M, seed=seed)
        for d in devs:
            d.t_comm = max(0.0, d.t_comm * float(rng.uniform(lo, hi)))
        out.append(devs)
    return out


def _both(profiles_dir, M, seed, rng_seed, lo=0.5, hi=2.0, S=4):
    from distilp_tpu.utils import make_synthetic_fleet as jfleet

    return (_drifted(make_synthetic_fleet, M, seed, rng_seed, lo, hi, S),
            _drifted(jfleet, M, seed, rng_seed, lo, hi, S))


def _held(port, ref, gap=GAP):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert p.certified and r.certified
        assert p.k == r.k
        assert abs(p.obj_value - r.obj_value) <= 2 * gap * abs(r.obj_value) + 1e-9


def test_scenarios_match_reference(profiles_dir):
    """Four t_comm futures of one 5-device fleet, one search of four lanes
    on one shared A, each scenario at the reference's k and objective."""
    ours, theirs = _both(profiles_dir, 5, 31, 31)
    tm = {}
    port = halda_solve_scenarios(ours, _online(profiles_dir), kv_bits="4bit", mip_gap=GAP,
                                 timings=tm, device="cpu")
    ref = japi.halda_solve_scenarios(theirs, _online(profiles_dir, True), kv_bits="4bit",
                                     mip_gap=GAP)
    assert tm["scenarios"] == 4.0 and "scenario_fallback" not in tm
    _held(port, ref)
    for r in port:
        assert sum(r.w) * r.k == 80


def test_static_half_is_the_reference_bytes(profiles_dir):
    """The shared-A test is the reference's: ``pack_static`` gives
    ``_pack_static``'s bytes (dense and MoE)."""
    from distilp_tpu.common import load_model_profile as jload
    from distilp_tpu.utils import make_synthetic_fleet as jfleet

    path = profiles_dir / "llama_3_70b" / "online" / "model_profile.json"
    Ks, _, coeffs, arrays = _build_instance(make_synthetic_fleet(5, seed=31),
                                            load_model_profile(path), None, "4bit", None, None)
    _, _, jc, ja = japi._build_instance(jfleet(5, seed=31), jload(path), None, "4bit", None,
                                        None)
    kWs = [(k, 80 // k) for k in Ks if 80 // k >= 5]
    ours = pack_static(SF.build_standard_form(arrays, coeffs, kWs))
    theirs = BJ._pack_static(BJ.build_standard_form(ja, jc, kWs))
    assert ours.tobytes() == theirs.tobytes()


def _cpu_doubled(devs):
    """The fleet with device 0's CPU throughput table scaled by 2 (moves A:
    out of the profile-drift class)."""
    bad = [d.model_copy(deep=True) for d in devs]
    for q in bad[0].scpu:
        bad[0].scpu[q] = {col: v * 2.0 for col, v in bad[0].scpu[q].items()}
    return bad


def test_static_half_fallback_fires_like_reference(profiles_dir):
    """A device whose CPU table doubles moves A: the port, like the
    reference, falls back to the batch layout (each scenario its own A, one
    search) and still matches; a different fleet size raises."""
    ours, theirs = _both(profiles_dir, 5, 31, 31, S=1)
    ours.append(_cpu_doubled(ours[0]))
    theirs.append(_cpu_doubled(theirs[0]))
    tm, jtm = {}, {}
    port = halda_solve_scenarios(ours, _online(profiles_dir), kv_bits="4bit", mip_gap=GAP,
                                 timings=tm, device="cpu")
    ref = japi.halda_solve_scenarios(theirs, _online(profiles_dir, True), kv_bits="4bit",
                                     mip_gap=GAP, timings=jtm)
    assert tm.get("scenario_fallback") == 1.0 == jtm.get("scenario_fallback")
    _held(port, ref)
    with pytest.raises(ValueError, match="shape family"):
        halda_solve_scenarios([ours[0], make_synthetic_fleet(6, seed=31)],
                              _online(profiles_dir), kv_bits="4bit", mip_gap=GAP,
                              device="cpu")


def test_scenarios_on_the_pdhg_engine_share_one_a(profiles_dir):
    """Scenarios share their A, so at fleet scale they run on the PDHG
    engine (K5 takes one A for the batch); forced here at 5 devices, each
    scenario matches its own single solve on that engine."""
    from distilp_torch.solver import halda_solve

    ours, _ = _both(profiles_dir, 5, 31, 31, S=2)
    model = _online(profiles_dir)
    kw = dict(kv_bits="4bit", mip_gap=GAP, device="cpu", lp_backend="pdhg", pdhg_iters=400)
    tm = {}
    port = halda_solve_scenarios(ours, model, timings=tm, **kw)
    assert tm["lp_backend"] == "pdhg" and "scenario_fallback" not in tm
    for devs, r in zip(ours, port):
        own = halda_solve(devs, model, **kw)
        assert r.certified and r.k == own.k
        assert abs(r.obj_value - own.obj_value) <= 2 * GAP * abs(own.obj_value) + 1e-9


def test_warm_seeds_both_or_cold(profiles_dir):
    """Warm seeds engage only when every scenario has one: warm results
    match the cold ones within the gap, and a batch with one missing seed
    runs cold, bit for bit the cold batch."""
    ours, _ = _both(profiles_dir, 4, 43, 43, lo=0.6, hi=1.7, S=3)
    model = _online(profiles_dir)
    kw = dict(kv_bits="4bit", mip_gap=GAP, device="cpu")
    cold_tm = {}
    cold = halda_solve_scenarios(ours, model, timings=cold_tm, **kw)
    warm = halda_solve_scenarios(ours, model, warms=cold, **kw)
    for c, w in zip(cold, warm):
        assert w.certified
        assert abs(w.obj_value - c.obj_value) <= 2 * GAP * abs(c.obj_value) + 1e-9
    mixed_tm = {}
    mixed = halda_solve_scenarios(ours, model, warms=[cold[0], None, cold[2]],
                                  timings=mixed_tm, **kw)
    for c, m in zip(cold, mixed):
        assert (m.k, m.w, m.n, m.obj_value) == (c.k, c.w, c.n, c.obj_value)
    assert mixed_tm["bnb_rounds"] == cold_tm["bnb_rounds"]


def test_moe_load_factor_scenarios_match_reference_and_warm_rule():
    """Mixtral over 4 devices under two expert-load regimes: one search of
    two lanes with one decomposition ascent over both (K7's instance
    axis), at the reference's k and objective. Seeded with those results
    (duals and incumbents in every lane) the batch only re-evaluates the
    bound (decomp_steps 0); with one seed missing it runs the full ascent."""
    from distilp_tpu.profiler.api import profile_model as jprofile
    from distilp_tpu.utils import make_synthetic_fleet as jfleet

    cfg = "tests/configs/mixtral_8x7b.json"
    model = profile_model(cfg, batch_sizes=[1], sequence_length=128).to_model_profile()
    devs = make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9))
    regimes = [None, [1.5, 0.8, 1.0, 0.9]]
    kw = dict(kv_bits="8bit", mip_gap=GAP, load_factors_list=regimes, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tm = {}
        cold = halda_solve_scenarios([devs, devs], model, timings=tm, **kw)
        assert tm["decomp_steps"] == SF.DECOMP_STEPS_COLD
        jm = jprofile(cfg, batch_sizes=[1], sequence_length=128).to_model_profile()
        jdevs = jfleet(4, seed=7, pool_bytes=int(64e9))
        ref = japi.halda_solve_scenarios([jdevs, jdevs], jm, kv_bits="8bit", mip_gap=GAP,
                                         load_factors_list=regimes)
        _held(cold, ref)
        for r in cold:
            assert sum(r.y) == model.n_routed_experts and r.duals is not None
        tm = {}
        warm = halda_solve_scenarios([devs, devs], model, warms=cold, timings=tm, **kw)
        assert tm["decomp_steps"] == SF.DECOMP_STEPS_WARM
        for c, w in zip(cold, warm):
            assert w.certified
            assert abs(w.obj_value - c.obj_value) <= 2 * GAP * abs(c.obj_value) + 1e-9
        tm = {}
        halda_solve_scenarios([devs, devs], model, warms=[cold[0], None], timings=tm, **kw)
        assert tm["decomp_steps"] == SF.DECOMP_STEPS_COLD
