"""The port's ``halda_solve`` on the PDHG engine (``device='cpu'``: the
kernels' plain versions) against the JAX package and the pinned objectives.

Tolerances: goldens within rel 2e-4 of their pinned objective (the gap they
certify at is 1e-4); engines and packages within 2 x mip_gap of each other
(each certifies its own incumbent to the gap, and the two incumbents may be
different assignments); the fleet-scale instance within rel 2e-3 of the JAX
package's result (gap 1e-3). Search-parameter resolution and the escalation
ladder are integer/string bookkeeping and are held exactly.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from distilp_torch import kernels  # noqa: E402
from distilp_torch.common import load_from_profile_folder, load_model_profile  # noqa: E402
from distilp_torch.solver import halda_solve  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet, stretch_model_for_fleet  # noqa: E402

GAP = 1e-3
GOLDEN = [
    ("hermes_70b", 40, 29.643569),
    ("llama_3_70b/4bit", 8, 12.834690),
    ("llama_3_70b/online", 2, 1.934942),
    ("qwen3_32b/bf16", 16, 12.072837),
]
# distilp_tpu.solver.halda_solve(make_synthetic_fleet(128, seed=123),
# stretch_model_for_fleet(llama_3_70b/online, 128), mip_gap=1e-3,
# kv_bits="4bit", backend="jax") on the CPU: engine 'pdhg', k=1, certified.
FLEET128_OBJ = -312.9522665906968


def _online_model(profiles_dir):
    return load_model_profile(profiles_dir / "llama_3_70b" / "online" / "model_profile.json")


@pytest.mark.parametrize("folder,k_star,obj", GOLDEN)
def test_pdhg_backend_matches_golden(profiles_dir, folder, k_star, obj):
    devs, model = load_from_profile_folder(profiles_dir / folder)
    tm = {}
    r = halda_solve(devs, model, mip_gap=1e-4, kv_bits="4bit", device="cpu",
                    lp_backend="pdhg", timings=tm)
    assert tm["lp_backend"] == "pdhg" and tm["mesh_shards"] == 1
    assert r.k == k_star
    assert r.obj_value == pytest.approx(obj, rel=2e-4)
    assert r.certified
    assert sum(r.w) * r.k == model.L
    assert all(0 <= n <= w for w, n in zip(r.w, r.n))


def test_pdhg_north_star_matches_jax_and_ipm(profiles_dir):
    from distilp_tpu.common import load_model_profile as jload_model
    from distilp_tpu.solver import halda_solve as jax_solve
    from distilp_tpu.utils import make_synthetic_fleet as jfleet

    model = _online_model(profiles_dir)
    tm = {}
    got = halda_solve(make_synthetic_fleet(16, seed=123), model, mip_gap=GAP,
                      kv_bits="4bit", device="cpu", lp_backend="pdhg", timings=tm)
    ipm = halda_solve(make_synthetic_fleet(16, seed=123), model, mip_gap=GAP,
                      kv_bits="4bit", device="cpu", lp_backend="ipm")
    jmodel = jload_model(profiles_dir / "llama_3_70b" / "online" / "model_profile.json")
    ref = jax_solve(jfleet(16, seed=123), jmodel, mip_gap=GAP, kv_bits="4bit",
                    backend="jax", lp_backend="pdhg")
    assert tm["lp_backend"] == "pdhg"
    assert got.certified and ref.certified and ipm.certified
    assert got.k == ref.k
    assert got.obj_value == pytest.approx(ref.obj_value, rel=2 * GAP)
    assert got.obj_value == pytest.approx(ipm.obj_value, rel=2 * GAP)
    assert got.obj_value == pytest.approx(-38.374803, rel=2 * GAP)
    assert sum(got.w) * got.k == model.L


def test_fleet_scale_default_solve_takes_pdhg(profiles_dir):
    """The M=128 fleet with every knob at its default: 'auto' resolves to the
    PDHG engine, and on CPU tensors no kernel is launched."""
    model = stretch_model_for_fleet(_online_model(profiles_dir), 128)
    kernels.reset_launch_counts()
    tm = {}
    r = halda_solve(make_synthetic_fleet(128, seed=123), model, mip_gap=GAP,
                    kv_bits="4bit", device="cpu", timings=tm)
    assert tm["lp_backend"] == "pdhg"
    assert r.k == 1 and r.certified
    assert r.obj_value == pytest.approx(FLEET128_OBJ, rel=2 * GAP)
    assert sum(r.w) * r.k == model.L
    assert set(kernels.LAUNCHES.values()) == {0}


def test_fleet_scale_default_device_needs_a_gpu(profiles_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = stretch_model_for_fleet(_online_model(profiles_dir), 128)
    with pytest.raises(RuntimeError, match="CUDA"):
        halda_solve(make_synthetic_fleet(128, seed=123), model, kv_bits="4bit")


def test_pdhg_iters_knob_plumbed(profiles_dir):
    """A starved first-order budget loosens the bound into an uncertified
    return (with the warning); the default budget certifies."""
    model = _online_model(profiles_dir)
    devs = make_synthetic_fleet(8, seed=8)
    with pytest.warns(RuntimeWarning, match="certificate NOT met"):
        short = halda_solve(devs, model, mip_gap=1e-4, kv_bits="4bit", device="cpu",
                            lp_backend="pdhg", pdhg_iters=20, max_rounds=1)
    assert not short.certified
    full = halda_solve(devs, model, mip_gap=1e-4, kv_bits="4bit", device="cpu",
                       lp_backend="pdhg")
    assert full.certified


def test_pdhg_knobs_need_the_pdhg_engine(profiles_dir):
    devs, model = load_from_profile_folder(profiles_dir / "llama_3_70b" / "online")
    with pytest.raises(ValueError, match="pdhg-engine knob"):
        halda_solve(devs, model, kv_bits="4bit", device="cpu", lp_backend="ipm",
                    pdhg_dtype="f64")
    with pytest.raises(ValueError, match="pdhg_dtype"):
        halda_solve(devs, model, kv_bits="4bit", device="cpu", lp_backend="pdhg",
                    pdhg_dtype="bf16")


# ------------------------------------------------ parity of the bookkeeping

_SEARCH_CASES = [
    (M, lb, it, dt, sh)
    for M in (16, 128, 512)
    for lb in (None, "ipm", "pdhg")
    for it, dt, sh in ((None, None, None), (3000, None, None), (None, "f32", None),
                       (500, "f64", None), (None, None, 2))
]


@pytest.mark.parametrize("M,lp_backend,pdhg_iters,pdhg_dtype,mesh_shards", _SEARCH_CASES)
def test_resolve_search_params_matches_jax(M, lp_backend, pdhg_iters, pdhg_dtype,
                                           mesh_shards):
    from distilp_torch.solver.standard_form import resolve_search_params
    from distilp_tpu.solver.backend_jax import _resolve_search_params

    args = (False, 5, None, None, None, None)
    kw = dict(lp_backend=lp_backend, pdhg_iters=pdhg_iters, M=M,
              mesh_shards=mesh_shards, pdhg_dtype=pdhg_dtype)
    try:
        ref = _resolve_search_params(*args, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            resolve_search_params(*args, **kw)
        assert str(got.value) == str(e)
        return
    assert resolve_search_params(*args, **kw) == ref


def test_default_pdhg_iters_matches_jax():
    from distilp_torch.solver import standard_form as sf
    from distilp_tpu.solver import backend_jax as bj

    assert (sf.PDHG_ITERS, sf.PDHG_WARM_FLOOR, sf.PDHG_AUTO_M) == (
        bj.PDHG_ITERS, bj.PDHG_WARM_FLOOR, bj.PDHG_AUTO_M)
    for M in (1, 16, 127, 128, 255, 256, 512, 2048):
        assert sf.default_pdhg_iters(M) == bj.default_pdhg_iters(M)


def _ladder_kwargs(monkeypatch, module, attr, solve):
    """Run ``solve`` with ``module.attr`` (the sweep) spied: the first sweep
    is starved (one round, 20 first-order steps) so the certificate is
    missed; every sweep is capped at one short round. Returns the keyword
    arguments of each sweep call."""
    calls = []
    real = getattr(module, attr)

    def spy(*a, **k):
        calls.append(dict(k))
        return real(*a, **dict(k, max_rounds=1, pdhg_iters=20 if len(calls) == 1 else 64))

    monkeypatch.setattr(module, attr, spy)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        solve()
    return calls


def test_escalation_pdhg_rung_matches_jax(profiles_dir, monkeypatch):
    """The PDHG rung of the escalation ladder: an uncertified default-budget
    solve retries warm at 4x the size-aware budget and, after an 'f32' run,
    in float64, exactly as the JAX package's ladder does."""
    from distilp_torch.solver import api
    from distilp_torch.solver.standard_form import default_pdhg_iters
    from distilp_tpu.common import load_model_profile as jload_model
    from distilp_tpu.solver import backend_jax
    from distilp_tpu.solver import halda_solve as jax_solve
    from distilp_tpu.utils import make_synthetic_fleet as jfleet

    kw = dict(mip_gap=1e-5, kv_bits="4bit", lp_backend="pdhg", pdhg_dtype="f32")
    model = _online_model(profiles_dir)
    tm = {}
    got = _ladder_kwargs(monkeypatch, api, "solve_sweep_torch", lambda: halda_solve(
        make_synthetic_fleet(16, seed=123), model, device="cpu", timings=tm, **kw))
    jmodel = jload_model(profiles_dir / "llama_3_70b" / "online" / "model_profile.json")
    ref = _ladder_kwargs(monkeypatch, backend_jax, "solve_sweep_jax", lambda: jax_solve(
        jfleet(16, seed=123), jmodel, backend="jax", **kw))
    assert len(got) == len(ref) == 2 and tm["escalated"] == 1
    keys = ("pdhg_iters", "pdhg_dtype", "mesh_shards", "lp_backend", "max_rounds",
            "beam", "node_cap", "pdhg_restart_tol")
    assert {k: got[1].get(k) for k in keys} == {k: ref[1].get(k) for k in keys}
    assert got[1]["pdhg_iters"] == 4 * default_pdhg_iters(16)
    assert got[1]["pdhg_dtype"] == "f64"
    assert got[1]["warm"] is not None
    assert "ipm_iters" not in got[1] and "ipm_iters" not in ref[1]


def test_cast_lp_result_matches_jax():
    """After a float64 PDHG solve the result is cast back to the float32
    search dtype; ``reduced`` is rounded through float32 (and held in float64
    for the epilogue), so reduced-cost tightening sees the reference's
    values."""
    import jax.numpy as jnp

    from distilp_torch.ops.ipm import IPMResult
    from distilp_torch.solver.search import cast_lp_result
    from distilp_tpu.ops.ipm import IPMResult as JResult
    from distilp_tpu.solver.backend_jax import _cast_lp_result

    rng = np.random.default_rng(5)
    B, m, n = 3, 4, 7
    vals = dict(
        v=rng.normal(size=(B, n)), bound=rng.normal(size=B), obj=rng.normal(size=B),
        rp_norm=rng.random(B), rd_norm=rng.random(B), mu=rng.random(B),
        converged=rng.random(B) < 0.5, reduced=rng.normal(size=(B, n)) / 3.0,
        y_dual=rng.normal(size=(B, m)), z_dual=rng.random((B, n)),
        f_dual=rng.random((B, n)), iters_run=rng.integers(0, 900, B).astype(np.float64),
    )
    got = cast_lp_result(IPMResult(**{k: torch.tensor(v) for k, v in vals.items()}),
                         torch.float32)
    ref = _cast_lp_result(JResult(**{k: jnp.asarray(v) for k, v in vals.items()},
                                  trace_buf=None), jnp.float32)
    for f in IPMResult._fields:
        g = getattr(got, f).numpy()
        r = np.asarray(getattr(ref, f))
        if f == "reduced":
            assert g.dtype == np.float64 and r.dtype == np.float32
        else:
            assert g.dtype == r.dtype, f
        np.testing.assert_array_equal(g, r.astype(g.dtype), err_msg=f)
