"""The port's IPM (plain PyTorch version of kernel K1) against the JAX IPM.

Same numpy-seeded batches go through ``distilp_tpu.ops.ipm_solve_batch`` and
``distilp_torch.ops.ipm_solve_batch`` on CPU tensors (the plain version).
Tolerances: float64 every field within rtol 1e-8 (atol 1e-8 times the
field's scale, for entries that converge to zero) with equal iteration
counts; float32 bound/obj within rtol 1e-4 and the bound valid.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from distilp_torch.ops.ipm import (  # noqa: E402
    IPMWarmState,
    LPBatch,
    ipm_solve_batch,
    ipm_solve_batch_reference,
)
from distilp_tpu.ops import IPMWarmState as JWarm  # noqa: E402
from distilp_tpu.ops import LPBatch as JBatch  # noqa: E402
from distilp_tpu.ops import ipm_solve_batch as j_ipm  # noqa: E402


def _random_feasible(rng, m, n, B, fix_frac=0.2):
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
    return LPBatch(*(torch.tensor(a, dtype=dtype) for a in arrs))


def _jax(arrs, dtype=jnp.float64):
    return JBatch(*(jnp.asarray(a, dtype) for a in arrs))


def _warm_np(res):
    return [np.asarray(getattr(res, f)) for f in ("v", "y_dual", "z_dual", "f_dual")]


def _assert_fields_match(got, ref, rtol=1e-8):
    for f in got._fields:
        g = getattr(got, f).numpy()
        r = np.asarray(getattr(ref, f))
        if f in ("converged", "iters_run"):
            np.testing.assert_array_equal(g, r, err_msg=f)
        else:
            scale = max(1.0, float(np.max(np.abs(r[np.isfinite(r)]), initial=0.0)))
            np.testing.assert_allclose(g, r, rtol=rtol, atol=rtol * scale, err_msg=f)


def test_f64_cold_matches_jax_field_by_field():
    arrs, refs = _random_feasible(np.random.default_rng(42), m=10, n=25, B=6)
    got = ipm_solve_batch(_port(arrs), iters=30)
    ref = j_ipm(_jax(arrs), iters=30)
    _assert_fields_match(got, ref)
    assert np.all(got.converged.numpy())
    np.testing.assert_allclose(got.obj.numpy(), refs, rtol=1e-8, atol=1e-8)


def test_f64_warm_and_skip_match_jax_field_by_field():
    arrs, _ = _random_feasible(np.random.default_rng(7), m=8, n=20, B=5)
    cold = j_ipm(_jax(arrs), iters=6)
    v, y, z, f = _warm_np(cold)
    ok = np.array([True, False, True, True, True])
    skip = np.array([False, False, True, False, False])
    ref = j_ipm(
        _jax(arrs), iters=14, chunk=4, skip=jnp.asarray(skip),
        warm=JWarm(*(jnp.asarray(a) for a in (v, y, z, f)), ok=jnp.asarray(ok)),
    )
    got = ipm_solve_batch(
        _port(arrs), iters=14, chunk=4, skip=torch.tensor(skip),
        warm=IPMWarmState(*(torch.tensor(a) for a in (v, y, z, f)), ok=torch.tensor(ok)),
    )
    _assert_fields_match(got, ref)
    assert got.iters_run[2] == 0


@pytest.mark.parametrize("chunk", [1, 4, 26])
def test_f64_chunking_matches_jax(chunk):
    """The loop runs ceil(iters/chunk)*chunk steps at most and stops at the
    first chunk boundary after convergence, like the vmapped while_loop."""
    arrs, _ = _random_feasible(np.random.default_rng(3), m=6, n=14, B=4)
    got = ipm_solve_batch(_port(arrs), iters=26, chunk=chunk)
    ref = j_ipm(_jax(arrs), iters=26, chunk=chunk)
    _assert_fields_match(got, ref)


def test_f32_bound_and_obj_match_jax_and_bound_is_valid():
    arrs, refs = _random_feasible(np.random.default_rng(9), m=10, n=25, B=6)
    got = ipm_solve_batch(_port(arrs, torch.float32), iters=30)
    ref = j_ipm(_jax(arrs, jnp.float32), iters=30)
    np.testing.assert_allclose(got.bound.numpy(), np.asarray(ref.bound), rtol=1e-4)
    np.testing.assert_allclose(got.obj.numpy(), np.asarray(ref.obj), rtol=1e-4)
    assert got.bound.dtype == torch.float64
    assert np.all(got.bound.numpy() <= refs + 1e-6)


def test_matches_scipy_on_random_lps():
    arrs, refs = _random_feasible(np.random.default_rng(42), m=10, n=25, B=16)
    res = ipm_solve_batch(_port(arrs), iters=50)
    assert np.all(res.converged.numpy())
    np.testing.assert_allclose(res.obj.numpy(), refs, rtol=1e-8, atol=1e-8)
    assert np.all(res.bound.numpy() <= refs + 1e-8)
    np.testing.assert_allclose(res.bound.numpy(), refs, rtol=1e-6, atol=1e-6)


def test_warm_start_matches_cold_and_exits_early():
    arrs, refs = _random_feasible(np.random.default_rng(11), m=10, n=25, B=12)
    batch = _port(arrs)
    cold = ipm_solve_batch(batch, iters=50)
    warm = ipm_solve_batch(
        batch, iters=50,
        warm=IPMWarmState(cold.v, cold.y_dual, cold.z_dual, cold.f_dual,
                          torch.ones(12, dtype=torch.bool)),
    )
    assert np.all(warm.converged.numpy())
    np.testing.assert_allclose(warm.obj.numpy(), cold.obj.numpy(), rtol=1e-6, atol=1e-8)
    assert np.all(warm.bound.numpy() <= refs + 1e-8)
    assert warm.iters_run.max() < cold.iters_run.max()


def test_early_exit_stops_before_budget():
    arrs, _ = _random_feasible(np.random.default_rng(5), m=8, n=20, B=6)
    res = ipm_solve_batch(_port(arrs), iters=200)
    assert np.all(res.converged.numpy())
    assert int(res.iters_run.max()) < 40


@pytest.mark.parametrize("iters", [2, 3, 5, 8])
def test_truncated_budget_bound_stays_sound(iters):
    arrs, refs = _random_feasible(np.random.default_rng(21), m=10, n=25, B=12)
    b = ipm_solve_batch(_port(arrs), iters=iters, chunk=2).bound.numpy()
    assert np.all(np.isfinite(b) | np.isneginf(b))
    assert np.all(b <= refs + 1e-8)


def test_garbage_warm_state_degrades_to_cold():
    B = 8
    arrs, refs = _random_feasible(np.random.default_rng(33), m=10, n=25, B=B)
    batch = _port(arrs)
    cold = ipm_solve_batch(batch, iters=60)
    ones = torch.ones(B, dtype=torch.bool)
    bad = IPMWarmState(
        torch.full_like(cold.v, float("nan")), torch.full_like(cold.y_dual, float("inf")),
        cold.z_dual, cold.f_dual, ones,
    )
    res = ipm_solve_batch(batch, iters=60, warm=bad)
    np.testing.assert_allclose(res.obj.numpy(), cold.obj.numpy(), rtol=1e-7, atol=1e-8)
    absurd = IPMWarmState(
        1e6 * torch.ones_like(cold.v), -1e5 * torch.ones_like(cold.y_dual),
        1e9 * torch.ones_like(cold.z_dual), 1e-12 * torch.ones_like(cold.f_dual), ones,
    )
    res2 = ipm_solve_batch(batch, iters=60, warm=absurd)
    assert np.all(res2.converged.numpy())
    np.testing.assert_allclose(res2.obj.numpy(), cold.obj.numpy(), rtol=1e-6, atol=1e-7)
    assert np.all(res2.bound.numpy() <= refs + 1e-8)
    off = absurd._replace(ok=torch.zeros(B, dtype=torch.bool))
    res3 = ipm_solve_batch(batch, iters=60, warm=off)
    np.testing.assert_allclose(res3.obj.numpy(), cold.obj.numpy(), rtol=1e-9, atol=1e-10)


def test_skip_mask_freezes_elements():
    B = 6
    arrs, _ = _random_feasible(np.random.default_rng(44), m=8, n=18, B=B)
    sk = torch.zeros(B, dtype=torch.bool)
    sk[2] = True
    res = ipm_solve_batch(_port(arrs), iters=50, skip=sk)
    runs = res.iters_run.numpy()
    assert runs[2] == 0
    live = np.delete(np.arange(B), 2)
    assert np.all(runs[live] > 0)
    assert np.all(res.converged.numpy()[live])


def test_all_columns_fixed():
    rng = np.random.default_rng(3)
    n, m = 8, 3
    A = rng.normal(size=(m, n))
    l = rng.uniform(0, 1, size=(1, n))
    b = (A @ l[0])[None, :]
    c = rng.normal(size=(1, n))
    arrs = (A, b, c, l, l.copy())
    res = ipm_solve_batch(_port(arrs), iters=20)
    assert np.isfinite(float(res.obj[0]))
    assert float(res.obj[0]) == pytest.approx(float(c[0] @ l[0]))
    ref = j_ipm(_jax(arrs), iters=20)
    np.testing.assert_array_equal(res.v.numpy(), np.asarray(ref.v))
    assert res.bound.numpy() == pytest.approx(np.asarray(ref.bound), rel=1e-8)


def test_infeasible_bound_grows():
    arrs = (np.array([[1.0, 1.0]]), np.array([[10.0]]), np.array([[1.0, 1.0]]),
            np.zeros((1, 2)), np.ones((1, 2)))
    res = ipm_solve_batch(_port(arrs), iters=60)
    assert float(res.bound[0]) > 2.0


def test_non_pd_normal_matrix_gives_zero_steps_like_jax():
    """A zero row of A with reg=0 puts a 0 pivot in the normal matrix: the
    factor is all-NaN (as jax.scipy.linalg.cho_factor returns), so every
    direction is non-finite, the finite guard zeroes the step, and the
    iterate stays at the cold start for the whole budget."""
    rng = np.random.default_rng(8)
    n = 6
    A = np.vstack([rng.normal(size=(2, n)), np.zeros((1, n))])
    l = np.zeros((2, n))
    u = np.ones((2, n))
    x = rng.uniform(0.2, 0.8, size=(2, n))
    b = x @ A.T
    c = rng.normal(size=(2, n))
    arrs = (A, b, c, l, u)
    got = ipm_solve_batch(_port(arrs), iters=8, reg=0.0)
    ref = j_ipm(_jax(arrs), iters=8, reg=0.0)
    np.testing.assert_array_equal(got.v.numpy(), np.full((2, n), 0.5))
    assert got.iters_run.tolist() == [8, 8]
    assert not got.converged.any()
    _assert_fields_match(got, ref)


def test_route_follows_the_tensors_device():
    arrs, _ = _random_feasible(np.random.default_rng(1), m=4, n=9, B=2)
    batch = _port(arrs)
    a = ipm_solve_batch(batch, iters=10)
    b = ipm_solve_batch_reference(batch, iters=10)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    mixed = batch._replace(A=batch.A.to("meta"))
    with pytest.raises(ValueError, match="mixed"):
        ipm_solve_batch(mixed, iters=2)


@pytest.mark.parametrize("M,dtype,route", [
    (16, torch.float32, "shared"),
    (128, torch.float32, "shared"),
    (172, torch.float32, "shared"),
    (173, torch.float32, "global"),
    (192, torch.float32, "global"),
    (86, torch.float64, "shared"),
    (87, torch.float64, "global"),
])
def test_workspace_route_follows_the_shapes(monkeypatch, M, dtype, route):
    """K1 keeps each LP's (24 n + 4 m + 32) vector elements in shared memory
    while they fit, beside its 256 bytes of static shared memory, the
    232448 bytes an H100 block can opt into, and in a per-block global
    workspace above that (m = 6M+1, n = 13M+1 for an M-device fleet). The
    kernel library answers the route query on the card (``chip_smoke.py``
    holds its answers to this table); here a stand-in library answers with
    the H100 figures, and the wrapper is driven to see what it hands the
    kernel: a null vector workspace on the shared route, B slices of the
    vector length on the global one."""
    from distilp_torch import kernels
    from distilp_torch.kernels import build
    from distilp_torch.ops import ipm

    m, n = 6 * M + 1, 13 * M + 1
    vec_bytes = dtype.itemsize * (24 * n + 4 * m + 32)
    assert vec_bytes == (1344 * M + 240) * (dtype.itemsize // 4)
    f64 = int(dtype == torch.float64)
    seen = {}

    class Lib:
        def dtk_ipm_vec_ws_bytes(self, device, B, m_, n_, is_f64, out):
            assert (m_, n_, is_f64) == (m, n, f64)
            out._obj.value = 0 if vec_bytes + 256 <= 232448 else B * vec_bytes
            return 0

        def launcher(self, *args):
            seen["vec_ws"] = args[21].value  # after A..skip, B..reg and ws
            return 0

        dtk_ipm_f32 = dtk_ipm_f64 = launcher

    monkeypatch.setattr(build, "library", lambda name: Lib())
    monkeypatch.setattr(kernels, "on_cuda", lambda *t: True)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)
    assert ipm.ipm_workspace_route(m, n, dtype, torch.device("cpu")) == route
    allocs = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        allocs.append(t.numel())
        return t

    monkeypatch.setattr(torch, "empty", empty)
    B = 2
    z = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
    ipm.ipm_solve_batch(LPBatch(z(m, n), z(B, m), z(B, n), z(B, n), z(B, n) + 1), iters=1)
    vec_len = vec_bytes // dtype.itemsize
    if route == "shared":
        assert seen["vec_ws"] is None
        assert B * vec_len not in allocs
    else:
        assert seen["vec_ws"] is not None
        assert B * vec_len in allocs
