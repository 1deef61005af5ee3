"""The port's PDHG engine (plain PyTorch version of kernel K5) and its
mixed-precision entry (K6a) against the JAX package.

Mirrors ``tests/test_pdhg.py`` (kernel level) and the single-device part of
``tests/test_meshlp.py`` on the port's CPU path, then holds the port field by
field against ``distilp_tpu.ops.pdhg_solve_batch`` on the root batches of the
HALDA LP family, with inputs made by numpy from a seed.

Tolerances (first-order engine: PDHG trades the IPM's quadratic tail for
factorization-free steps, so optimality agreement is 1e-5/1e-6 where the
IPM's tests hold 1e-8; bound validity is exact, the float64 certificate
holds for any dual):

- float64 against JAX: ``bound`` within 1e-7 relative (both take the same
  steps; only summation order differs, and the certificate is a float64 sum
  of float64 products); ``v``/``y_dual`` within 1e-5 relative to the field's
  scale (the primal and dual iterates carry the roundoff that summation order
  leaves in the adaptive restart's decisions, damped by the contraction);
  ``iters_run`` within one convergence chunk (the exit test fires at a chunk
  boundary, and a residual that crosses the tolerance a step later moves it
  by one chunk).
- float32 against JAX: ``bound`` within 1e-3 relative. A float32 run's
  restart branch and exit chunk depend on the summation order, so only the
  certificate is held.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from distilp_torch.ops import (  # noqa: E402
    IPMWarmState,
    LPBatch,
    PDHGWarmState,
    ipm_solve_batch,
    pdhg_solve_batch,
    pdhg_solve_batch_mp,
    pdhg_solve_batch_reference,
)
from distilp_torch.ops.pdhg import PDHG_DEFAULT_CHUNK  # noqa: E402
from distilp_tpu.ops import LPBatch as JBatch  # noqa: E402
from distilp_tpu.ops import PDHGWarmState as JWarm  # noqa: E402
from distilp_tpu.ops import pdhg_solve_batch as j_pdhg  # noqa: E402


def _random_feasible(rng, m, n, B, fix_frac=0.2):
    """B feasible boxed LPs sharing one A, with their HiGHS optima."""
    from scipy.optimize import linprog

    A = rng.normal(size=(m, n))
    bs, cs, ls, us, refs = [], [], [], [], []
    for _ in range(B):
        l = rng.uniform(-2, 0, n)
        u = l + rng.uniform(0.5, 3, n)
        u = np.where(rng.random(n) < fix_frac, l, u)
        x = l + rng.uniform(0, 1, n) * (u - l)
        b = A @ x
        c = rng.normal(size=n)
        r = linprog(c, A_eq=A, b_eq=b, bounds=np.stack([l, u], 1), method="highs")
        assert r.status == 0
        refs.append(r.fun)
        bs.append(b)
        cs.append(c)
        ls.append(l)
        us.append(u)
    return (A, np.array(bs), np.array(cs), np.array(ls), np.array(us)), np.array(refs)


def _port(arrs, dtype=torch.float64):
    return LPBatch(*(torch.tensor(np.asarray(a), dtype=dtype) for a in arrs))


def _jax(arrs, dtype=jnp.float64):
    return JBatch(*(jnp.asarray(np.asarray(a), dtype) for a in arrs))


def _halda_roots(M: int):
    """The root batch (one LP per feasible k) of the M-device north-star
    family: the standard form the branch-and-bound sweep solves."""
    from pathlib import Path

    from distilp_torch.common import load_model_profile
    from distilp_torch.solver.api import _build_instance
    from distilp_torch.solver.backend_torch import device_arrays
    from distilp_torch.solver.standard_form import build_standard_form
    from distilp_torch.utils import make_synthetic_fleet

    model = load_model_profile(
        Path(__file__).parent / "profiles" / "llama_3_70b" / "online" / "model_profile.json"
    )
    devs = make_synthetic_fleet(M, seed=123)
    Ks, _, coeffs, arrays = _build_instance(devs, model, None, "4bit", None, None)
    feasible = [(k, model.L // k) for k in Ks if model.L // k >= M]
    host = device_arrays(build_standard_form(arrays, coeffs, feasible))
    return tuple(
        np.asarray(host[k], np.float64) for k in ("A", "b_k", "c_k", "lo_k", "hi_k")
    )


# ---------------------------------------------------------------- kernel level


def test_matches_scipy_on_random_lps():
    arrs, refs = _random_feasible(np.random.default_rng(42), m=10, n=25, B=16)
    res = pdhg_solve_batch(_port(arrs), iters=40000, tol=1e-9)
    assert res.converged.all()
    np.testing.assert_allclose(res.obj.numpy(), refs, rtol=1e-6, atol=1e-6)
    assert np.all(res.bound.numpy() <= refs + 1e-6)
    np.testing.assert_allclose(res.bound.numpy(), refs, rtol=1e-5, atol=1e-5)
    assert res.bound.dtype == res.reduced.dtype == torch.float64


def test_all_columns_fixed():
    rng = np.random.default_rng(3)
    n, m = 8, 3
    A = rng.normal(size=(m, n))
    l = rng.uniform(0, 1, size=(1, n))
    b = (A @ l[0])[None, :]
    c = rng.normal(size=(1, n))
    res = pdhg_solve_batch(_port((A, b, c, l, l.copy())), iters=50)
    assert np.isfinite(float(res.obj[0]))
    assert float(res.obj[0]) == pytest.approx(float(c[0] @ l[0]))


def test_warm_start_matches_cold_and_exits_early():
    arrs, refs = _random_feasible(np.random.default_rng(11), m=10, n=25, B=12)
    batch = _port(arrs)
    cold = pdhg_solve_batch(batch, iters=20000, tol=1e-8)
    assert cold.converged.all()
    warm = pdhg_solve_batch(
        batch, iters=20000, tol=1e-8,
        warm=PDHGWarmState(cold.v, cold.y_dual, cold.z_dual, cold.f_dual,
                           torch.ones(12, dtype=torch.bool)),
    )
    assert warm.converged.all()
    np.testing.assert_allclose(warm.obj.numpy(), cold.obj.numpy(), rtol=1e-5, atol=1e-6)
    assert np.all(warm.bound.numpy() <= refs + 1e-6)
    assert warm.iters_run.max() < cold.iters_run.max()


@pytest.mark.parametrize("iters", [5, 20, 100, 500])
def test_truncated_budget_bound_stays_sound(iters):
    arrs, refs = _random_feasible(np.random.default_rng(21), m=10, n=25, B=12)
    b = pdhg_solve_batch(_port(arrs), iters=iters, chunk=5).bound.numpy()
    assert np.all(np.isfinite(b) | np.isneginf(b))
    assert np.all(b <= refs + 1e-6), f"unsound bound at iters={iters}"


def test_garbage_warm_state_degrades_to_cold():
    B = 8
    arrs, refs = _random_feasible(np.random.default_rng(33), m=10, n=25, B=B)
    batch = _port(arrs)
    cold = pdhg_solve_batch(batch, iters=20000, tol=1e-8)
    ones = torch.ones(B, dtype=torch.bool)
    bad = PDHGWarmState(
        torch.full_like(cold.v, float("nan")), torch.full_like(cold.y_dual, float("inf")),
        cold.z_dual, cold.f_dual, ones,
    )
    res = pdhg_solve_batch(batch, iters=20000, tol=1e-8, warm=bad)
    np.testing.assert_allclose(res.obj.numpy(), cold.obj.numpy(), rtol=1e-6, atol=1e-7)
    absurd = PDHGWarmState(
        1e6 * torch.ones_like(cold.v), -1e5 * torch.ones_like(cold.y_dual),
        1e9 * torch.ones_like(cold.z_dual), 1e-12 * torch.ones_like(cold.f_dual), ones,
    )
    res2 = pdhg_solve_batch(batch, iters=40000, tol=1e-8, warm=absurd)
    assert res2.converged.all()
    np.testing.assert_allclose(res2.obj.numpy(), cold.obj.numpy(), rtol=1e-5, atol=1e-6)
    assert np.all(res2.bound.numpy() <= refs + 1e-6)
    off = absurd._replace(ok=torch.zeros(B, dtype=torch.bool))
    res3 = pdhg_solve_batch(batch, iters=20000, tol=1e-8, warm=off)
    np.testing.assert_allclose(res3.obj.numpy(), cold.obj.numpy(), rtol=1e-9, atol=1e-10)


def test_skip_mask_freezes_elements():
    B = 6
    arrs, _ = _random_feasible(np.random.default_rng(44), m=8, n=18, B=B)
    sk = torch.zeros(B, dtype=torch.bool)
    sk[2] = True
    res = pdhg_solve_batch(_port(arrs), iters=40000, tol=1e-8, skip=sk)
    runs = res.iters_run.numpy()
    assert runs[2] == 0
    live = np.delete(np.arange(B), 2)
    assert np.all(runs[live] > 0)
    assert np.all(res.converged.numpy()[live])


def test_infeasible_bound_grows():
    arrs = (np.array([[1.0, 1.0]]), np.array([[10.0]]), np.array([[1.0, 1.0]]),
            np.zeros((1, 2)), np.ones((1, 2)))
    res = pdhg_solve_batch(_port(arrs), iters=5000)
    assert float(res.bound[0]) > 2.0


def test_warm_states_interchange_between_engines():
    B = 8
    arrs, refs = _random_feasible(np.random.default_rng(55), m=10, n=25, B=B)
    batch = _port(arrs)
    ones = torch.ones(B, dtype=torch.bool)
    ipm_res = ipm_solve_batch(batch, iters=60)
    assert ipm_res.converged.all()
    p_from_i = pdhg_solve_batch(
        batch, iters=20000, tol=1e-8,
        warm=PDHGWarmState(ipm_res.v, ipm_res.y_dual, ipm_res.z_dual, ipm_res.f_dual, ones),
    )
    assert p_from_i.converged.all()
    np.testing.assert_allclose(p_from_i.obj.numpy(), refs, rtol=1e-5, atol=1e-5)
    pdhg_res = pdhg_solve_batch(batch, iters=20000, tol=1e-8)
    i_from_p = ipm_solve_batch(
        batch, iters=60,
        warm=IPMWarmState(pdhg_res.v, pdhg_res.y_dual, pdhg_res.z_dual, pdhg_res.f_dual,
                          ones),
    )
    assert i_from_p.converged.all()
    np.testing.assert_allclose(i_from_p.obj.numpy(), refs, rtol=1e-7, atol=1e-7)
    cold_ipm = ipm_solve_batch(batch, iters=60)
    assert i_from_p.iters_run.max() <= cold_ipm.iters_run.max()


def test_route_follows_the_tensors_device():
    arrs, _ = _random_feasible(np.random.default_rng(1), m=4, n=9, B=2)
    batch = _port(arrs)
    a = pdhg_solve_batch(batch, iters=64)
    b = pdhg_solve_batch_reference(batch, iters=64)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    with pytest.raises(ValueError, match="mixed"):
        pdhg_solve_batch(batch._replace(A=batch.A.to("meta")), iters=2)
    with pytest.raises(NotImplementedError, match="A9"):
        pdhg_solve_batch(batch, iters=2, trace=True)


# ------------------------------------------------------- against the JAX engine


def _assert_matches_jax_f64(got, ref):
    b_ref = np.asarray(ref.bound)
    np.testing.assert_allclose(got.bound.numpy(), b_ref, rtol=1e-7,
                               atol=1e-7 * max(1.0, float(np.abs(b_ref).max())))
    for f in ("v", "y_dual"):
        r = np.asarray(getattr(ref, f))
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(getattr(got, f).numpy(), r, rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=f)
    d_it = np.abs(got.iters_run.numpy().astype(np.int64) - np.asarray(ref.iters_run))
    assert d_it.max() <= PDHG_DEFAULT_CHUNK


@pytest.mark.parametrize("M", [4, 16])
def test_f64_matches_jax_on_halda_roots(M):
    arrs = _halda_roots(M)
    got = pdhg_solve_batch(_port(arrs), iters=2000)
    ref = j_pdhg(_jax(arrs), iters=2000)
    _assert_matches_jax_f64(got, ref)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))


@pytest.mark.parametrize("M", [4, 16])
def test_f64_warm_and_skip_match_jax_on_halda_roots(M):
    arrs = _halda_roots(M)
    B = arrs[1].shape[0]
    cold = j_pdhg(_jax(arrs), iters=300)
    rng = np.random.default_rng(M)
    noisy = [np.asarray(getattr(cold, f)) * (1.0 + 0.01 * rng.standard_normal())
             for f in ("v", "y_dual", "z_dual", "f_dual")]
    ok = np.arange(B) != 0
    skip = np.arange(B) == B - 1
    ref = j_pdhg(_jax(arrs), iters=1000, skip=jnp.asarray(skip),
                 warm=JWarm(*(jnp.asarray(a) for a in noisy), ok=jnp.asarray(ok)))
    got = pdhg_solve_batch(
        _port(arrs), iters=1000, skip=torch.tensor(skip),
        warm=PDHGWarmState(*(torch.tensor(a) for a in noisy), ok=torch.tensor(ok)),
    )
    _assert_matches_jax_f64(got, ref)
    assert int(got.iters_run[B - 1]) == 0


@pytest.mark.parametrize("M", [4, 16])
def test_f32_bound_matches_jax_on_halda_roots(M):
    arrs = _halda_roots(M)
    got = pdhg_solve_batch(_port(arrs), iters=2000, dtype="f32")
    ref = j_pdhg(_jax(arrs), iters=2000, dtype="f32")
    assert got.v.dtype == torch.float32 and got.bound.dtype == torch.float64
    b_ref = np.asarray(ref.bound)
    np.testing.assert_allclose(got.bound.numpy(), b_ref, rtol=1e-3,
                               atol=1e-3 * max(1.0, float(np.abs(b_ref).max())))


# ------------------------------------------- mixed precision (single device)


def test_mp_f32_sound_vs_f64_vs_highs():
    arrs, refs = _random_feasible(np.random.default_rng(21), m=10, n=25, B=8)
    batch = _port(arrs)
    rep32 = {}
    r32 = pdhg_solve_batch_mp(batch, iters=40000, dtype="f32", fallback_report=rep32)
    r64 = pdhg_solve_batch_mp(batch, iters=40000, dtype="f64")
    assert rep32["n_fallback"] == 0
    assert r32.converged.all() and r64.converged.all()
    assert np.all(r32.bound.numpy() <= refs + 1e-5)
    assert np.all(r64.bound.numpy() <= refs + 1e-6)
    np.testing.assert_allclose(r32.obj.numpy(), refs, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(r64.obj.numpy(), refs, rtol=1e-5, atol=1e-5)


def test_mp_nonfinite_f32_falls_back_to_f64():
    B = 4
    arrs, _ = _random_feasible(np.random.default_rng(33), m=8, n=18, B=B)
    A, b, c, l, u = arrs
    b_bad = b.copy()
    b_bad[0] *= 1e39  # float32(1e39) is inf: the float32 run cannot be finite
    poisoned = _port((A, b_bad, c, l, u))
    rep = {}
    res = pdhg_solve_batch_mp(poisoned, iters=4000, dtype="f32", fallback_report=rep)
    assert rep["n_fallback"] >= 1
    r32 = pdhg_solve_batch_mp(poisoned, iters=4000, dtype="f32", f64_fallback=False)
    r64 = pdhg_solve_batch_mp(poisoned, iters=4000, dtype="f64")
    bad = ~r32.converged | ~torch.isfinite(r32.bound)
    assert bad[0]
    assert torch.equal(res.obj[bad], r64.obj.to(res.obj.dtype)[bad])
    assert torch.equal(res.obj[~bad], r32.obj[~bad])
    assert torch.isfinite(res.bound[~bad]).all()


def test_mp_rejects_unknown_dtype_and_shards():
    arrs, _ = _random_feasible(np.random.default_rng(3), m=6, n=12, B=2)
    with pytest.raises(ValueError, match="pdhg_dtype"):
        pdhg_solve_batch_mp(_port(arrs), dtype="bf16")
    with pytest.raises(NotImplementedError, match="A13"):
        pdhg_solve_batch_mp(_port(arrs), mesh_shards=2)
