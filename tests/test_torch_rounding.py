"""The port's host-side standard form and its rounding (plain version of
kernel K2) against the JAX package.

Standard form: every numpy field byte-equal to ``backend_jax``'s, and the
float32 device arrays equal to the reference's in-trace materialization.
Rounding: identical w/n and the float64 objective within rtol 1e-12 on
random near-feasible LP rows of golden fixtures and the north star.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from distilp_torch.common import load_from_profile_folder, load_model_profile  # noqa: E402
from distilp_torch.solver import rounding as R  # noqa: E402
from distilp_torch.solver import standard_form as SF  # noqa: E402
from distilp_torch.solver.api import _build_instance  # noqa: E402
from distilp_torch.solver.backend_torch import device_arrays  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402
from distilp_tpu.solver import api as japi  # noqa: E402
from distilp_tpu.solver import backend_jax as BJ  # noqa: E402

INSTANCES = ["hermes_70b", "llama_3_70b/4bit", "llama_3_70b/online",
             "qwen3_32b/bf16", "north_star"]


def _instances(profiles_dir, name):
    """(port (Ks, coeffs, arrays), reference (coeffs, arrays), kWs)."""
    if name == "north_star":
        model = load_model_profile(
            profiles_dir / "llama_3_70b" / "online" / "model_profile.json"
        )
        devs = make_synthetic_fleet(16, seed=123)
    else:
        devs, model = load_from_profile_folder(profiles_dir / name)
    Ks, _, coeffs, arrays = _build_instance(devs, model, None, "4bit", None, None)
    # The reference builds from its own schema objects.
    from distilp_tpu.common import load_from_profile_folder as jload
    from distilp_tpu.common import load_model_profile as jmodel
    from distilp_tpu.utils import make_synthetic_fleet as jfleet

    if name == "north_star":
        jdevs = jfleet(16, seed=123)
        jm = jmodel(profiles_dir / "llama_3_70b" / "online" / "model_profile.json")
    else:
        jdevs, jm = jload(profiles_dir / name)
    _, _, jcoeffs, jarrays = japi._build_instance(jdevs, jm, None, "4bit", None, None)
    kWs = [(k, model.L // k) for k in Ks if model.L // k >= len(devs)]
    return (coeffs, arrays), (jcoeffs, jarrays), kWs


@pytest.mark.parametrize("name", INSTANCES)
def test_standard_form_is_byte_equal(profiles_dir, name):
    (coeffs, arrays), (jcoeffs, jarrays), kWs = _instances(profiles_dir, name)
    sf = SF.build_standard_form(arrays, coeffs, kWs)
    ref = BJ.build_standard_form(jarrays, jcoeffs, kWs)
    for f in ("A", "b_k", "c_k", "lo_k", "hi_k", "int_mask", "A_base", "smin_k", "C_ub_k"):
        a, b = getattr(sf, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert (sf.ks, sf.Ws, sf.M, sf.obj_const, sf.moe) == (
        ref.ks, ref.Ws, ref.M, ref.obj_const, ref.moe
    )
    rd, jrd = SF.rounding_arrays_np(coeffs), BJ._rounding_arrays_np(jcoeffs)
    assert set(rd) == set(jrd)
    for k in rd:
        assert np.asarray(rd[k]).tobytes() == np.asarray(jrd[k]).tobytes(), k


@pytest.mark.parametrize("name", ["llama_3_70b/online", "north_star"])
def test_device_arrays_match_reference_materialization(profiles_dir, name):
    """The float32 family equals what the reference's device program builds
    from its packed blobs (``_solve_packed_impl``): slack and cycle boxes
    recomputed in float32 from smin_k and C_ub_k."""
    (coeffs, arrays), _, kWs = _instances(profiles_dir, name)
    sf = SF.build_standard_form(arrays, coeffs, kWs)
    got = device_arrays(sf)
    lay = arrays.layout
    N, C = lay.n_vars, lay.C
    m, nf = sf.A.shape[1:]
    m_ub = m - lay.n_eq
    static = jnp.asarray(BJ._pack_static(sf))
    off = m * nf
    A_base = static[:off].reshape(m, nf)
    n_k = len(kWs)
    c_k = static[off : off + n_k * nf].reshape(n_k, nf)
    off += n_k * nf
    lo_k = static[off : off + n_k * nf].reshape(n_k, nf)
    off += n_k * nf
    hi_k = static[off : off + n_k * nf].reshape(n_k, nf)
    off += n_k * nf
    smin_k = static[off : off + n_k * m_ub].reshape(n_k, m_ub)
    b_k = jnp.asarray(np.asarray(sf.b_k, np.float32))
    C_ub_k = jnp.asarray(sf.C_ub_k, jnp.float64)
    aC = A_base[:m_ub, C]
    cmin = jnp.minimum(aC[None, :] * lo_k[:, C][:, None],
                       aC[None, :] * C_ub_k[:, None].astype(jnp.float32))
    hi_k = hi_k.at[:, N:].set(jnp.maximum(b_k[:, :m_ub] - (smin_k + cmin), 0.0))
    hi_k = hi_k.at[:, C].set(C_ub_k.astype(jnp.float32))
    for f, ref in (("A", A_base), ("c_k", c_k), ("lo_k", lo_k), ("hi_k", hi_k),
                   ("b_k", b_k)):
        assert got[f].tobytes() == np.asarray(ref).tobytes(), f


def _near_feasible_rows(rng, M, nf, W, B):
    """LP-like points: w a noisy split of W layers, n <= w fractional."""
    v = rng.uniform(0.0, 3.0, size=(B, nf))
    w = rng.dirichlet(np.ones(M), size=B) * W + rng.normal(0, 0.3, size=(B, M))
    v[:, :M] = np.clip(w, 0.6, W)
    v[:, M : 2 * M] = v[:, :M] * rng.uniform(0, 1, size=(B, M))
    v[: B // 4, M : 2 * M] = np.round(v[: B // 4, M : 2 * M] * 2) / 2  # .5 ties
    return v.astype(np.float32)


@pytest.mark.parametrize("name", ["hermes_70b", "llama_3_70b/online", "north_star"])
def test_rounding_matches_reference_rows(profiles_dir, name):
    (coeffs, arrays), (jcoeffs, _), kWs = _instances(profiles_dir, name)
    M = arrays.layout.M
    nf = 13 * M + 1
    rng = np.random.default_rng(len(name))
    B = 24
    kidx = rng.integers(0, len(kWs), B)
    W = np.array([kWs[j][1] for j in kidx], np.float64)
    k = np.array([kWs[j][0] for j in kidx], np.float64)
    v = _near_feasible_rows(rng, M, nf, W[:, None], B)
    rd = R.rounding_data(SF.rounding_arrays_np(coeffs), "cpu")
    obj, w, n = R.round_to_incumbent(torch.tensor(v), torch.tensor(W), torch.tensor(k), rd)
    jrd = BJ.rounding_data(jcoeffs)
    jobj, jw, jn, _ = jax.vmap(
        lambda vv, WW, kk: BJ._round_to_incumbent(vv, M, WW, kk, jrd)
    )(jnp.asarray(v), jnp.asarray(W), jnp.asarray(k))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_allclose(obj.numpy(), np.asarray(jobj), rtol=1e-12)
    assert np.isfinite(obj.numpy()).sum() >= B // 4


def test_rounding_all_blocked_step_moves_device_zero():
    """jnp.argmax of an all -inf score is index 0: a scan step that cannot
    move anywhere still adds to device 0 (and the row then fails the sum
    test). The port keeps that rule."""
    M = 3
    rd = R.RoundingData(*([torch.zeros(M, dtype=torch.float64)] * 16),
                        torch.tensor(1.0, dtype=torch.float64),
                        torch.tensor(0.0, dtype=torch.float64))
    rd = rd._replace(w_active=torch.ones(M, dtype=torch.float64),
                     s_disk=torch.ones(M, dtype=torch.float64))
    v = torch.tensor([[2.0, 2.0, 2.0, 0, 0, 0]], dtype=torch.float64)
    W = torch.tensor([2.0], dtype=torch.float64)
    obj, w, _ = R.round_to_incumbent(v, W, torch.tensor([2.0], dtype=torch.float64), rd)
    # Every device sits at its cap W=2, the sum 6 > 2: moves go down by
    # smallest remainder (all 0 -> first index) until the scan runs out.
    jrd = BJ.RoundingData(*(jnp.asarray(t.numpy()) for t in rd))
    jobj, jw, _, _ = BJ._round_to_incumbent(
        jnp.asarray(v[0].numpy()), M, jnp.asarray(2.0), jnp.asarray(2.0), jrd
    )
    np.testing.assert_array_equal(w[0].numpy(), np.asarray(jw))
    assert float(obj[0]) == float(jobj)


def test_warm_hint_row_matches_reference(profiles_dir):
    """The single-row re-pricing of a warm integer assignment (float64 v)."""
    (coeffs, arrays), (jcoeffs, _), kWs = _instances(profiles_dir, "north_star")
    M = arrays.layout.M
    w = np.ones(M)
    w[5] = 20
    w[9] = 80 // kWs[0][0] - w.sum() + 1
    n = np.minimum(w, 3) * (np.arange(M) % 2)
    v = np.zeros(13 * M + 1)
    v[:M], v[M : 2 * M] = w, n
    rd = R.rounding_data(SF.rounding_arrays_np(coeffs), "cpu")
    W, k = float(kWs[0][1]), float(kWs[0][0])
    obj, wr, nr = R.round_to_incumbent(
        torch.tensor(v)[None], torch.tensor([W], dtype=torch.float64),
        torch.tensor([k], dtype=torch.float64), rd,
    )
    jobj, jw, jn, _ = BJ._round_to_incumbent(
        jnp.asarray(v), M, jnp.asarray(W), jnp.asarray(k), BJ.rounding_data(jcoeffs)
    )
    np.testing.assert_array_equal(wr[0].numpy(), np.asarray(jw))
    np.testing.assert_array_equal(nr[0].numpy(), np.asarray(jn))
    assert float(obj[0]) == pytest.approx(float(jobj), rel=1e-12)
