"""The port's ``halda_solve`` as a whole (``device='cpu'``: the kernels'
plain versions) against the JAX package and the pinned golden objectives.

Tolerances: same k as JAX and the objective within rel 1e-9 when (k, w, n)
agree, else within 2 x mip_gap (both certify the same gap); goldens within
rel 2e-4 of their pinned objective; synthetic fleets within 2 x gap of the
port's own HiGHS oracle.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from distilp_torch.common import load_from_profile_folder, load_model_profile  # noqa: E402
from distilp_torch.interop import from_jax_arrays  # noqa: E402
from distilp_torch.solver import halda_solve  # noqa: E402
from distilp_torch.solver.result import HALDAResult  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402

GOLDEN = [
    ("hermes_70b", 40, 29.643569),
    ("llama_3_70b/4bit", 8, 12.834690),
    ("llama_3_70b/online", 2, 1.934942),
    ("qwen3_32b/bf16", 16, 12.072837),
]


def _online_model(profiles_dir):
    return load_model_profile(profiles_dir / "llama_3_70b" / "online" / "model_profile.json")


@pytest.mark.parametrize("folder,k_star,obj", GOLDEN)
def test_golden_fixtures(profiles_dir, folder, k_star, obj):
    devs, model = load_from_profile_folder(profiles_dir / folder)
    r = halda_solve(devs, model, mip_gap=1e-4, kv_bits="4bit", device="cpu")
    assert r.k == k_star
    assert r.obj_value == pytest.approx(obj, rel=2e-4)
    assert r.certified
    assert sum(r.w) * r.k == model.L
    assert all(0 <= n <= w for w, n in zip(r.w, r.n))


def _assert_agrees(got, ref, gap):
    assert got.k == ref.k
    if (got.w, got.n) == (ref.w, ref.n):
        assert got.obj_value == pytest.approx(ref.obj_value, rel=1e-9)
    else:
        assert got.obj_value == pytest.approx(ref.obj_value, rel=2 * gap)
    assert got.certified == ref.certified


@pytest.mark.parametrize("gap", [1e-3, 1e-4])
def test_north_star_matches_jax(profiles_dir, gap):
    from distilp_tpu.common import load_model_profile as jload_model
    from distilp_tpu.solver import halda_solve as jax_solve
    from distilp_tpu.utils import make_synthetic_fleet as jfleet

    model = _online_model(profiles_dir)
    got = halda_solve(make_synthetic_fleet(16, seed=123), model, mip_gap=gap,
                      kv_bits="4bit", device="cpu")
    jmodel = jload_model(profiles_dir / "llama_3_70b" / "online" / "model_profile.json")
    ref = jax_solve(jfleet(16, seed=123), jmodel, mip_gap=gap, kv_bits="4bit",
                    backend="jax")
    _assert_agrees(got, ref, gap)
    assert got.obj_value == pytest.approx(-38.374803, rel=2 * gap)


def test_online_golden_matches_jax(profiles_dir):
    from distilp_tpu.common import load_from_profile_folder as jload
    from distilp_tpu.solver import halda_solve as jax_solve

    devs, model = load_from_profile_folder(profiles_dir / "llama_3_70b" / "online")
    jdevs, jmodel = jload(profiles_dir / "llama_3_70b" / "online")
    got = halda_solve(devs, model, mip_gap=1e-4, kv_bits="4bit", device="cpu")
    ref = jax_solve(jdevs, jmodel, mip_gap=1e-4, kv_bits="4bit", backend="jax")
    _assert_agrees(got, ref, 1e-4)
    assert got.w == [13, 27]


@pytest.mark.parametrize("M", [4, 8])
def test_synthetic_fleet_matches_own_highs_oracle(profiles_dir, M):
    model = _online_model(profiles_dir)
    devs = make_synthetic_fleet(M, seed=M)
    gap = 1e-3
    ref = halda_solve(devs, model, mip_gap=gap, kv_bits="4bit", backend="cpu")
    got = halda_solve(devs, model, mip_gap=gap, kv_bits="4bit", device="cpu")
    assert got.obj_value == pytest.approx(ref.obj_value, rel=2 * gap)
    assert got.certified and got.gap is not None and got.gap <= gap
    assert sum(got.w) * got.k == model.L


def test_infeasible_raises(profiles_dir):
    devs = make_synthetic_fleet(6, seed=1)
    _, model = load_from_profile_folder(profiles_dir / "hermes_70b")
    with pytest.raises(RuntimeError, match="No feasible"):
        halda_solve(devs, model, k_candidates=[20], kv_bits="4bit", device="cpu")


def test_default_device_needs_a_gpu(profiles_dir, monkeypatch):
    """device=None means CUDA; without a GPU the call raises instead of
    dropping to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    devs, model = load_from_profile_folder(profiles_dir / "llama_3_70b" / "online")
    with pytest.raises(RuntimeError, match="CUDA"):
        halda_solve(devs, model, kv_bits="4bit")


def test_moe_instance_is_a_later_slice(profiles_dir):
    """MoE co-assignment, once a later slice, now solves: the Mixtral
    fixture certifies at the JAX package's objective (-82.67733552697693,
    k=4, y=[2, 3, 2, 1]: ``distilp_tpu.solver.halda_solve(*load_from_
    profile_folder(tests/profiles/mixtral_8x7b), kv_bits="4bit",
    backend="jax")``); tests/test_torch_moe_solver.py holds the rest."""
    devs, model = load_from_profile_folder(profiles_dir / "mixtral_8x7b")
    r = halda_solve(devs, model, kv_bits="4bit", device="cpu")
    assert r.certified and r.k == 4 and sum(r.y) == 8
    assert abs(r.obj_value - -82.67733552697693) <= 2e-4 * 82.67733552697693


def test_max_rounds_warns_when_certificate_missed(profiles_dir):
    model = _online_model(profiles_dir)
    devs = make_synthetic_fleet(16, seed=123)
    with pytest.warns(RuntimeWarning, match="certificate NOT met"):
        r = halda_solve(devs, model, mip_gap=1e-6, kv_bits="4bit", device="cpu",
                        max_rounds=1)
    assert not r.certified and r.gap > 1e-6


def test_escalation_ladder_reruns_warm(profiles_dir, monkeypatch):
    """A default-budget solve that misses its certificate retries once at
    the escalated budget, warm-seeded with the uncertified incumbent."""
    from distilp_torch.solver import api

    calls = []
    real = api.solve_sweep_torch

    def spy(*a, **k):
        calls.append(k)
        if len(calls) == 1:
            k = dict(k, max_rounds=1)
        return real(*a, **k)

    monkeypatch.setattr(api, "solve_sweep_torch", spy)
    model = _online_model(profiles_dir)
    tm = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        r = halda_solve(make_synthetic_fleet(16, seed=123), model, mip_gap=1e-5,
                        kv_bits="4bit", device="cpu", timings=tm)
    assert len(calls) == 2 and tm["escalated"] == 1
    assert calls[1]["warm"] is not None and calls[1]["beam"] == 16
    assert calls[1]["ipm_iters"] == calls[1]["ipm_warm_iters"] == 26
    assert r.obj_value <= calls[1]["warm"].obj_value + 1e-12


def test_warm_resolve_keeps_the_answer_and_carries_root_iterates(profiles_dir):
    model = _online_model(profiles_dir)
    devs = make_synthetic_fleet(16, seed=123)
    first = halda_solve(devs, model, mip_gap=1e-3, kv_bits="4bit", device="cpu")
    assert first.ipm_state is not None and first.ipm_state["ok"].all()
    tm = {}
    again = halda_solve(devs, model, mip_gap=1e-3, kv_bits="4bit", device="cpu",
                        warm=first, timings=tm)
    assert again.obj_value == pytest.approx(first.obj_value, rel=1e-12)
    assert again.certified


def test_jax_result_seeds_the_port(profiles_dir):
    """A warm HALDAResult from the JAX package (its assignment and its root
    IPM iterates, carried through interop) seeds the port's solve."""
    from distilp_tpu.common import load_model_profile as jmodel
    from distilp_tpu.solver import halda_solve as jax_solve
    from distilp_tpu.utils import make_synthetic_fleet as jfleet

    jm = jmodel(profiles_dir / "llama_3_70b" / "online" / "model_profile.json")
    jres = jax_solve(jfleet(16, seed=123), jm, mip_gap=1e-3, kv_bits="4bit",
                     backend="jax")
    warm = HALDAResult(
        **jres.model_dump(exclude={"ipm_state"}),
        ipm_state=from_jax_arrays(jres.ipm_state),
    )
    got = halda_solve(make_synthetic_fleet(16, seed=123), _online_model(profiles_dir),
                      mip_gap=1e-3, kv_bits="4bit", device="cpu", warm=warm)
    assert got.obj_value <= jres.obj_value + 1e-12
    assert got.certified
    assert np.asarray(warm.ipm_state["v"]).dtype == np.float64


def test_unported_options_raise(profiles_dir):
    devs, model = load_from_profile_folder(profiles_dir / "llama_3_70b" / "online")
    with pytest.raises(NotImplementedError):
        halda_solve(devs, model, kv_bits="4bit", device="cpu", lp_backend="pdhg",
                    mesh_shards=2)
    with pytest.raises(NotImplementedError):
        halda_solve(devs, model, kv_bits="4bit", device="cpu", convergence={})


def _perturb_fleet(devs, rng):
    """The dense fuzz of tests/test_fuzz_backends.py: random multiplicative
    noise on the load-bearing fleet coefficients."""
    for d in devs:
        d.t_comm = max(0.0, d.t_comm * float(rng.uniform(0.3, 3.0)))
        d.s_disk = max(1e6, d.s_disk * float(rng.uniform(0.3, 3.0)))
        d.d_avail_ram = max(int(1e9), int(d.d_avail_ram * rng.uniform(0.5, 2.0)))
        if d.d_avail_cuda is not None:
            d.d_avail_cuda = max(int(1e9), int(d.d_avail_cuda * rng.uniform(0.5, 2.0)))
        if d.d_avail_metal is not None:
            d.d_avail_metal = max(int(1e9), int(d.d_avail_metal * rng.uniform(0.5, 2.0)))
    return devs


@pytest.mark.parametrize("seed", [11, 23, 37, 59, 71, 97])
def test_fuzz_dense_matches_own_highs_oracle(profiles_dir, seed):
    rng = np.random.default_rng(seed)
    model = _online_model(profiles_dir)
    M = int(rng.choice([3, 5, 8]))
    devs = _perturb_fleet(make_synthetic_fleet(M, seed=seed), rng)
    kv = str(rng.choice(["4bit", "8bit", "fp16"]))
    gap = 1e-3
    ref = halda_solve(devs, model, mip_gap=gap, kv_bits=kv, backend="cpu")
    got = halda_solve(devs, model, mip_gap=gap, kv_bits=kv, device="cpu")
    assert abs(got.obj_value - ref.obj_value) <= 2 * gap * abs(ref.obj_value) + 1e-9
    assert sum(got.w) * got.k == model.L
