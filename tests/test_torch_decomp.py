"""The port's Lagrangian decomposition bound (plain version of kernel K7)
against the JAX package's ``_decomp_terms`` / ``_decomp_bound_roots``.

- float32 evaluation: the bound and its gradient (``DecompBound32``, a
  ``torch.autograd.Function``) against ``jax.value_and_grad`` of the
  reference's ``neg_bound32`` at random multipliers, within 1e-5 relative
  (scale max(1, |ref|)): the two sum the same float32 values in another
  order, and JAX spreads a tie's cotangent as 1/count per cell where the
  port averages the tied values; a constructed tie case included;
- float64 evaluation at given multipliers against
  ``_decomp_bound_roots(steps=0)`` (bound, m_y) within 1e-12 relative, the
  feasibility flags equal, and the Lagrangian-primal hint (w*, n*, y*) equal
  to the reference's streamed per-w argmin fold and n reconstruction;
- a 30-step ascent against the reference's: per-k bounds within 1e-4
  relative (Adam normalizes each gradient entry, so an entry the reference
  computes as 1e-7 where the port computes 0 moves it by the learning rate:
  the multipliers drift apart, the bounds barely).

Instances: Mixtral 8x7B and Qwen3-30B-A3B on 4 devices.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from distilp_torch.ops import decomp as D  # noqa: E402
from distilp_torch.profiler import profile_model  # noqa: E402
from distilp_torch.solver.api import _build_instance  # noqa: E402
from distilp_torch.solver.rounding import rounding_data  # noqa: E402
from distilp_torch.solver.standard_form import rounding_arrays_np  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402
from distilp_tpu.solver import backend_jax as BJ  # noqa: E402

TOL_F32 = 1e-5
TOL_F64 = 1e-12
TOL_ASCENT = 1e-4
CASES = {
    "mixtral_M4": ("mixtral_8x7b", 4, 7, 64e9),
    "qwen3_30b_a3b_M4": ("qwen3_30b_a3b_8bit", 4, 7, 64e9),
}


class Inst:
    def __init__(self, name):
        cfg, M, seed, pool = CASES[name]
        model = profile_model(
            f"tests/configs/{cfg}.json", batch_sizes=[1], sequence_length=128
        ).to_model_profile()
        devs = make_synthetic_fleet(M, seed=seed, pool_bytes=int(pool))
        Ks, _, coeffs, arrays = _build_instance(devs, model, None, "8bit", None, None)
        feas = [(k, model.L // k) for k in Ks if model.L // k >= M]
        self.M = M
        self.rd_np = rounding_arrays_np(coeffs, arrays.moe)
        self.ks = np.array([k for k, _ in feas], np.float64)
        self.Ws = np.array([W for _, W in feas], np.float64)
        self.w_max, self.e_max = int(self.Ws.max()), int(self.rd_np["E"])
        self.p32, self.p64 = (
            D.decomp_problem(self.rd_np, self.ks, self.Ws, self.w_max, self.e_max, dt, "cpu")
            for dt in (torch.float32, torch.float64)
        )
        self.jrd = BJ.RoundingData(
            **{k: jnp.asarray(v, jnp.float64) for k, v in self.rd_np.items()}
        )
        self.jks, self.jWs = jnp.asarray(self.ks), jnp.asarray(self.Ws)

    def neg_bound32(self):
        """The reference's float32 objective of the ascent
        (``_decomp_bound_roots``' ``neg_bound32``) on its own cell tensors."""
        lin32, cyc32, ok, w_vals, y_vals = BJ._decomp_terms(
            self.jrd, self.jks, self.jWs, self.w_max, self.e_max, jnp.float32
        )
        wv = w_vals[None, None, :, None]
        yv = y_vals[None, None, None, :]
        ks32, Ws32 = self.jks.astype(jnp.float32), self.jWs.astype(jnp.float32)
        E32 = self.jrd.E.astype(jnp.float32)

        def f(params):
            lam, mu, tau = params
            theta = (ks32 - 1.0)[:, None] * jax.nn.softmax(tau, axis=1)
            term = (
                lin32
                + theta[None, :, :, None, None] * cyc32
                - lam[None, :, None, None, None] * wv[None]
                - mu[None, :, None, None, None] * yv[None]
            )
            term = jnp.where(ok, term, jnp.asarray(3.4e37, jnp.float32))
            per_dev = jnp.min(term, axis=(0, 3, 4))
            b = per_dev.sum(axis=1) + lam * Ws32 + mu * E32
            return -jnp.sum(b), b

        return f

    def multipliers(self, seed):
        rng = np.random.default_rng(seed)
        n_k = len(self.ks)
        return (
            rng.normal(0.0, 1.0, n_k).astype(np.float32),
            rng.normal(0.0, 0.3, n_k).astype(np.float32),
            rng.normal(0.0, 1.0, (n_k, self.M)).astype(np.float32),
        )


_INST = {}


def inst(name) -> Inst:
    if name not in _INST:
        _INST[name] = Inst(name)
    return _INST[name]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))))


def _value_and_grads(I, params):
    (_, jb), jg = jax.value_and_grad(I.neg_bound32(), has_aux=True)(
        tuple(jnp.asarray(p) for p in params)
    )
    t = [torch.tensor(p, requires_grad=True) for p in params]
    b = D.DecompBound32.apply(*t, I.p32)
    (-b.sum()).backward()
    return (np.asarray(jb), [np.asarray(g) for g in jg]), (
        b.detach().numpy(), [x.grad.numpy() for x in t]
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", list(CASES))
def test_float32_bound_and_gradient_match_jax(name, seed):
    I = inst(name)
    (jb, jg), (tb, tg) = _value_and_grads(I, I.multipliers(seed))
    assert _rel(tb, jb) <= TOL_F32
    for g_port, g_ref in zip(tg, jg):
        assert g_port.shape == g_ref.shape
        assert _rel(g_port, g_ref) <= TOL_F32


@pytest.mark.parametrize("name", list(CASES))
def test_float32_gradient_splits_ties_like_jax(name):
    """At zero multipliers a device without a GPU (every n candidate is 0)
    and a zero RAM kink make candidates coincide, so many (k, device) minima
    are attained by several cells: the gradient averages them."""
    I = inst(name)
    n_k = len(I.ks)
    params = (np.zeros(n_k, np.float32), np.zeros(n_k, np.float32),
              np.zeros((n_k, I.M), np.float32))
    lin, _, ok = D.decomp_cells(I.p32)
    term = torch.where(ok, lin, D.BIG32)
    mn = term.amin(dim=(0, 3, 4))
    ties = (ok & (term == mn[None, :, :, None, None])).sum(dim=(0, 3, 4))
    assert int(ties.max()) > 1, "the instance has no tied minimum"
    (jb, jg), (tb, tg) = _value_and_grads(I, params)
    assert _rel(tb, jb) <= TOL_F32
    for g_port, g_ref in zip(tg, jg):
        assert _rel(g_port, g_ref) <= TOL_F32


def _reference_hint(I, lam, mu, tau):
    """The reference's float64 hint fold (``_decomp_bound_roots`` with a
    tracked hint): per w ascending, the first (candidate, y) argmin of the
    slice, taken when strictly below the best so far; then n* from the
    chosen candidate. Built on the reference's own cell pricing."""
    lam, mu, tau = (jnp.asarray(x, jnp.float64) for x in (lam, mu, tau))
    theta = (I.jks - 1.0)[:, None] * jax.nn.softmax(tau, axis=1)
    n_k, M, Y = len(I.ks), I.M, I.e_max + 1
    best = np.full((n_k, M), np.inf)
    best_flat = np.zeros((n_k, M), np.int64)
    best_w = np.ones((n_k, M))
    y64 = jnp.arange(0, Y, dtype=jnp.float64)
    for w in range(1, I.w_max + 1):
        lin, cyc, ok, _ = BJ._decomp_terms_for_w(
            I.jrd, I.jks, I.jWs, jnp.asarray([float(w)]), I.e_max, jnp.float64
        )
        term = (lin + theta[None, :, :, None, None] * cyc
                - lam[None, :, None, None, None] * float(w)
                - mu[None, :, None, None, None] * y64[None, None, None, None, :])
        term = np.asarray(jnp.where(ok, term, jnp.inf))[:, :, :, 0, :]
        t2 = np.transpose(term, (1, 2, 0, 3)).reshape(n_k, M, -1)
        smin = t2.min(axis=2)
        better = smin < best
        best_flat = np.where(better, t2.argmin(axis=2), best_flat)
        best_w = np.where(better, float(w), best_w)
        best = np.minimum(best, smin)
    c_star = best_flat // Y
    y_star = (best_flat % Y).astype(np.float64)
    r = {k: np.asarray(v) for k, v in I.rd_np.items()}
    hg, rm, bp = r["has_gpu"][None], r["ram_minus_n"][None], r["bprime"]
    with np.errstate(invalid="ignore", over="ignore"):
        vram = np.minimum(r["cuda_rhs"][None] - r["eb_vram"][None] * y_star,
                          r["metal_rhs"][None] - r["eb_metal"][None] * y_star)
        n_bnd = np.minimum(np.maximum(np.floor(vram / bp), 0.0), best_w) * hg
        n_bnd = np.where(np.isfinite(n_bnd), n_bnd, best_w * hg)
        kink = np.minimum(np.maximum(np.ceil(
            (bp * best_w + r["eb_ram"][None] * y_star - r["ram_rhs"][None]) / bp - 1e-9),
            0.0), best_w) * hg * rm
        kink = np.where(np.isfinite(kink), kink, 0.0)
        smin_n = np.minimum(np.maximum(np.ceil(
            (r["eb_ram"][None] * y_star - r["ram_rhs"][None]) / bp - 1e-9), 0.0),
            best_w) * hg * rm
        smin_n = np.where(np.isfinite(smin_n), smin_n, 0.0)
    n_star = np.select([c_star == 0, c_star == 1, c_star == 2, c_star == 3],
                       [0.0, best_w * hg, n_bnd, kink], smin_n)
    return best_w, n_star, y_star


@pytest.mark.parametrize("name", list(CASES))
def test_float64_evaluation_matches_jax(name):
    I = inst(name)
    lam, mu, tau = I.multipliers(5)
    jout = BJ._decomp_bound_roots(
        I.jrd, I.jks, I.jWs, I.w_max, I.e_max, steps=0, moe=True,
        init_params=(jnp.asarray(lam), jnp.asarray(mu), jnp.asarray(tau)),
    )
    # steps=0 keeps the float32 multipliers, cast to float64.
    lam64, mu64, tau64 = (torch.tensor(x).double() for x in (lam, mu, tau))
    bound, m_y, any_ok, hint_w, hint_flat = D.eval64(I.p64, lam64, mu64, tau64, True)
    assert _rel(bound.numpy(), np.asarray(jout[0])) <= TOL_F64
    jm = np.asarray(jout[5])
    assert np.array_equal(np.isfinite(jm), np.isfinite(m_y.numpy()))
    fin = np.isfinite(jm)
    assert _rel(m_y.numpy()[fin], jm[fin]) <= TOL_F64
    assert np.array_equal(any_ok.numpy(), np.isfinite(jm).any(axis=2))
    for x, y in zip(jout[4], (lam64, mu64, tau64)):
        assert np.array_equal(np.asarray(x), y.numpy())
    # The hint at the same multipliers, as the reference folds it.
    w_ref, n_ref, y_ref = _reference_hint(I, lam, mu, tau)
    out = D.decomp_bound_roots(I.p32, I.p64, rounding_data(I.rd_np, "cpu"), 0,
                               init_params=(lam, mu, tau))
    assert np.array_equal(out[0].numpy(), bound.numpy())
    Y = I.e_max + 1
    flat = hint_flat.numpy().astype(np.int64)
    assert np.array_equal(hint_w.numpy(), w_ref)
    assert np.array_equal((flat % Y).astype(np.float64), y_ref)
    # n* through the port's reconstruction, at the same multipliers (a
    # one-step ascent would move them).
    _, n_port, _ = D.primal_hint(rounding_data(I.rd_np, "cpu"), hint_w, hint_flat, Y)
    assert np.array_equal(n_port.numpy(), n_ref)


@pytest.mark.parametrize("name", list(CASES))
def test_thirty_step_ascent_matches_jax(name):
    I = inst(name)
    jout = BJ._decomp_bound_roots(I.jrd, I.jks, I.jWs, I.w_max, I.e_max, steps=30, moe=True)
    out = D.decomp_bound_roots(I.p32, I.p64, rounding_data(I.rd_np, "cpu"), 30)
    jb, tb = np.asarray(jout[0]), out[0].numpy()
    assert np.all(np.isfinite(tb)) == np.all(np.isfinite(jb))
    assert np.max(np.abs(tb - jb) / np.abs(jb)) <= TOL_ASCENT
    # The ascent only improves on the initial (zero) multipliers.
    zero = D.eval64(I.p64, *(torch.zeros_like(x) for x in out[4]), False)[0]
    assert np.all(tb >= zero.numpy() - 1e-9 * np.abs(zero.numpy()))


def test_ascent_reads_nothing_back_and_evaluates_once_per_step(monkeypatch):
    """One float32 evaluation per step plus the initial point."""
    I = inst("mixtral_M4")
    calls = []
    real = D.eval32

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(D, "eval32", counting)
    D.ascend(I.p32, 7)
    assert len(calls) == 8
