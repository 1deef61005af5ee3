"""K5 with a per-element A (the reference's ``pdhg_solve_batch`` with
``a_axis = 0``) on the port's CPU path, and the search paths that run it:
MoE nodes and lanes with an A each on the PDHG engine.

The port gives the kernel each element's values on one union sparse
structure (``ops.pdhg.ElemA``); its plain version, held here against the
JAX package, makes them dense again and solves with batched products.
Inputs are made by numpy from a seed. Tolerances are K5's float64 parity
tolerances of ``tests/test_torch_pdhg.py`` (bound 1e-7 relative, v and
y_dual 1e-5 of the field's scale), with ``iters_run`` equal: the two take
the same steps in another summation order.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from distilp_torch.ops import LPBatch, pdhg_solve_batch  # noqa: E402
from distilp_torch.ops.ipm import ipm_sparsity  # noqa: E402
from distilp_torch.ops.pdhg import ElemA, elem_a  # noqa: E402
from distilp_tpu.ops import LPBatch as JBatch  # noqa: E402
from distilp_tpu.ops import pdhg_solve_batch as j_pdhg  # noqa: E402


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
ONLINE = "tests/profiles/llama_3_70b/online"


def _quiet(fn, *a, **k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **k)


def _assert_matches_jax_f64(got, ref):
    b_ref = np.asarray(ref.bound)
    np.testing.assert_allclose(got.bound.numpy(), b_ref, rtol=1e-7,
                               atol=1e-7 * max(1.0, float(np.abs(b_ref).max())))
    for f in ("v", "y_dual"):
        r = np.asarray(getattr(ref, f))
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(getattr(got, f).numpy(), r, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=f)
    np.testing.assert_array_equal(got.iters_run.numpy(), np.asarray(ref.iters_run))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))


def _against_jax(A3, b, c, l, u, iters=2000, sparsity=None):
    got = pdhg_solve_batch(LPBatch(*(torch.tensor(a) for a in (A3, b, c, l, u))),
                           iters=iters, sparsity=sparsity)
    ref = j_pdhg(JBatch(*(jnp.asarray(a) for a in (A3, b, c, l, u))), iters=iters)
    _assert_matches_jax_f64(got, ref)
    return got


def _sweep(devs, model, kv_bits, k_candidates=None, moe=None):
    """The prepared lane data of one sweep on the CPU (PDHG engine)."""
    from distilp_torch.solver.api import _build_instance
    from distilp_torch.solver.backend_torch import _prepare, _search_params, lane_input

    Ks, _, coeffs, arrays = _build_instance(devs, model, k_candidates, kv_bits, moe, None)
    kWs = [(k, model.L // k) for k in Ks]
    feasible = [(k, W) for k, W in kWs if W >= len(devs)]
    lane = lane_input(arrays, coeffs, kWs, feasible)
    params = _search_params(lane.sf, None, None, None, None, None, "pdhg", None, None, None,
                            False)
    return _prepare([lane], params, GAP, torch.device("cpu"), shared_A=True)


def _north_star_roots():
    from distilp_torch.common import load_model_profile
    from distilp_torch.utils import make_synthetic_fleet

    model = load_model_profile(f"{ONLINE}/model_profile.json")
    prep = _sweep(make_synthetic_fleet(16, seed=123), model, "4bit")
    d, st = prep.data, prep.state
    n_k = d.ks.shape[1]
    return tuple(t.double().numpy() for t in (d.A, d.b_k[0], d.c_k[0],
                                              st.node_lo[0, :n_k], st.node_hi[0, :n_k]))


@pytest.fixture(scope="module")
def mixtral_prep():
    from distilp_torch.profiler import profile_model
    from distilp_torch.utils import make_synthetic_fleet

    model = profile_model("tests/configs/mixtral_8x7b.json", batch_sizes=[1],
                          sequence_length=128).to_model_profile()
    devs = make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9))
    return devs, model, _sweep(devs, model, "8bit")


# -------------------------------------------------- per-element K5 vs JAX


def test_perturbed_north_star_roots_match_jax():
    """Four north-star root LPs, each with its own seeded perturbation of
    A's nonzeros (one pattern, four value sets)."""
    A, b, c, l, u = _north_star_roots()
    rng = np.random.default_rng(8)
    B = b.shape[0]
    A3 = np.stack([A * (1.0 + 0.05 * rng.standard_normal(A.shape)) for _ in range(B)])
    x = l + rng.uniform(0.2, 0.8, l.shape) * (u - l)
    b3 = np.einsum("bmn,bn->bm", A3, x)  # keep every perturbed LP feasible
    _against_jax(A3, b3, c, l, u)


def test_mixtral_node_a_matches_jax(mixtral_prep):
    """Mixtral M=4's per-node A's (each root k's expert-busy entries
    scattered onto the base), as the MoE search builds them."""
    from distilp_torch.solver.search import node_A

    _, _, prep = mixtral_prep
    d, st = prep.data, prep.state
    n_k = d.ks.shape[1]
    kidx = torch.arange(n_k)
    A3 = node_A(d, kidx, st.inc_w.shape[-1], torch.zeros(n_k, dtype=torch.long))
    arrs = [t.double().numpy() for t in (A3, d.b_k[0], d.c_k[0], st.node_lo[0, :n_k],
                                         st.node_hi[0, :n_k])]
    _against_jax(*arrs, iters=1000, sparsity=d.A_sparsity)


def test_union_pattern_with_an_explicit_zero_matches_jax():
    """One element has a zero where the others have a nonzero: the union
    structure carries it as an explicit zero value."""
    rng = np.random.default_rng(3)
    B, m, n = 4, 7, 16
    A0 = rng.normal(size=(m, n)) * (rng.random((m, n)) < 0.45)
    A0[np.arange(m), np.arange(m)] = 1.5
    A3 = np.stack([A0 * (1.0 + 0.1 * rng.standard_normal((m, n))) for _ in range(B)])
    i, j = np.argwhere((A0 != 0) & (np.arange(n)[None, :] != np.arange(m)[:, None]))[0]
    A3[1, i, j] = 0.0
    x = rng.uniform(0.2, 0.8, (B, n))
    l, u = np.zeros((B, n)), np.ones((B, n))
    got = _against_jax(A3, np.einsum("bmn,bn->bm", A3, x), rng.normal(size=(B, n)), l, u,
                       iters=1500)
    sp = elem_a(torch.tensor(A3)).sparsity
    assert sp.nnz == int((A0 != 0).sum())  # the zero stays in the structure
    assert got.bound.dtype == torch.float64


def test_per_element_equals_shared_when_every_a_is_the_same():
    A, b, c, l, u = _north_star_roots()
    shared = pdhg_solve_batch(LPBatch(*(torch.tensor(a) for a in (A, b, c, l, u))),
                              iters=1000)
    A3 = torch.tensor(A).expand(b.shape[0], *A.shape).contiguous()
    per = pdhg_solve_batch(LPBatch(A3, *(torch.tensor(a) for a in (b, c, l, u))), iters=1000)
    for f in ("v", "bound", "y_dual", "reduced"):
        a, r = getattr(per, f), getattr(shared, f)
        assert float(((a - r).abs() / r.abs().clamp(min=1.0)).max()) <= 1e-6, f
    assert torch.equal(per.iters_run, shared.iters_run)


def test_a_structure_missing_a_nonzero_is_refused():
    rng = np.random.default_rng(1)
    A3 = torch.tensor(rng.normal(size=(2, 3, 5)))
    pattern = torch.ones(3, 5, dtype=torch.bool)
    pattern[1, 2] = False
    f64 = dict(dtype=torch.float64)
    batch = LPBatch(A3, torch.zeros(2, 3, **f64), torch.zeros(2, 5, **f64),
                    torch.zeros(2, 5, **f64), torch.ones(2, 5, **f64))
    with pytest.raises(ValueError, match="outside the sparsity pattern"):
        pdhg_solve_batch(batch, iters=4, sparsity=ipm_sparsity(pattern))
    with pytest.raises(ValueError, match="outside the sparsity pattern"):
        pdhg_solve_batch(batch._replace(A=A3[0]), iters=4, sparsity=ipm_sparsity(pattern))


# ------------------------------------------------------ the search's values


def test_values_path_equals_the_dense_node_a_path(mixtral_prep, monkeypatch):
    """The values the search hands K5 (each row's lane values with its k's
    expert-busy entries written in) describe exactly ``node_A``'s matrices,
    for MoE nodes and for lanes with an A each; and a MoE solve on the PDHG
    sends ElemA batches."""
    from distilp_torch.common import load_model_profile
    from distilp_torch.solver import halda_solve
    from distilp_torch.solver import search as S
    from distilp_torch.solver.backend_torch import _prepare
    from distilp_torch.utils import make_synthetic_fleet

    devs, model, prep = mixtral_prep
    d = prep.data
    M = prep.state.inc_w.shape[-1]
    kidx = torch.tensor([0, 2, 1, 2, 0])
    lane = torch.zeros(5, dtype=torch.long)
    vals = S.node_values(d, kidx, lane)
    assert torch.equal(ElemA(vals, d.A_sparsity).dense(), S.node_A(d, kidx, M, lane))
    assert torch.equal(d.A_values[0], d.A.reshape(-1)[d.A_sparsity.src])  # not written to
    params = dict(cap=8, beam=4, ipm_iters=64, ipm_warm_iters=64, max_rounds=1,
                  lp_backend="pdhg", pdhg_dtype=None, pdhg_restart_tol=None)
    # Scenario lanes share one A (one value set), each with its own gky.
    sd = _prepare([prep.lanes[0]] * 2, params, GAP, torch.device("cpu"), shared_A=True).data
    lane2 = torch.tensor([0, 1, 1, 0, 1])
    assert sd.A_values.shape[0] == 1
    assert torch.equal(ElemA(S.node_values(sd, kidx, lane2), sd.A_sparsity).dense(),
                       S.node_A(sd, kidx, M, lane2))

    online = load_model_profile(f"{ONLINE}/model_profile.json")
    lanes = [_sweep(make_synthetic_fleet(4, seed=s), online, "4bit", [8, 10]).lanes[0]
             for s in (1, 2)]
    ld = _prepare(lanes, params, GAP, torch.device("cpu")).data
    assert ld.A.dim() == 3 and ld.gky_pos is None
    rows = torch.tensor([0, 1, 1, 0])
    got = ElemA(S.node_values(ld, torch.zeros(4, dtype=torch.long), rows), ld.A_sparsity)
    assert torch.equal(got.dense(), S.node_A(ld, torch.zeros(4, dtype=torch.long), 4, rows))

    seen = []
    real = S.pdhg_solve_batch
    monkeypatch.setattr(S, "pdhg_solve_batch",
                        lambda batch, **kw: seen.append(type(batch.A)) or real(batch, **kw))
    r = _quiet(halda_solve, devs, model, mip_gap=GAP, kv_bits="8bit", lp_backend="pdhg",
               device="cpu")
    assert seen and set(seen) == {ElemA}
    assert r.certified and abs(r.obj_value + 132.93320566181376) <= 2 * GAP * 132.94


# ----------------------------------------- lanes on the PDHG against JAX


def _jax_and_port_lanes(seeds, k_candidates):
    from distilp_torch.solver.api import _build_instance as p_build
    from distilp_torch.solver.batchlayout import pack_instance as p_pack
    from distilp_torch.solver.batchlayout import solve_batch as p_solve
    from distilp_torch.utils import make_synthetic_fleet as p_fleet
    from distilp_tpu.common import load_model_profile as j_load
    from distilp_tpu.solver.api import _build_instance as j_build
    from distilp_tpu.solver.batchlayout import pack_instance as j_pack
    from distilp_tpu.solver.batchlayout import solve_batch as j_solve
    from distilp_tpu.utils import make_synthetic_fleet as j_fleet
    from distilp_torch.common import load_model_profile as p_load

    out = []
    for build, pack, solve, fleet, load, kw in (
            (j_build, j_pack, j_solve, j_fleet, j_load, {}),
            (p_build, p_pack, p_solve, p_fleet, p_load, {"device": "cpu"})):
        model = load(f"{ONLINE}/model_profile.json")
        insts = []
        for s in seeds:
            Ks, _, coeffs, arrays = build(fleet(4, seed=s), model, k_candidates, "4bit", False,
                                          None, 1)
            insts.append(pack(arrays, [(k, model.L // k) for k in Ks], mip_gap=GAP,
                              coeffs=coeffs, lp_backend="pdhg"))
        out.append([best for _, best in _quiet(solve, insts, **kw)])
    return out


def test_two_pdhg_lanes_match_jax_solve_batch():
    ref, got = _jax_and_port_lanes((1, 2), [8, 10])
    for r, g in zip(ref, got):
        assert (g.k, g.certified) == (r.k, r.certified)
        assert abs(g.obj_value - r.obj_value) <= 2 * GAP * abs(r.obj_value)
        assert abs(g.gap - r.gap) <= 1e-3


def test_scenario_fallback_on_the_pdhg_matches_jax():
    """A future whose first device's CPU table doubles cannot share the
    fleet's A: halda_solve_scenarios takes the batch-layout fallback, two
    lanes with an A each on K5's per-element entry."""
    from distilp_torch.common import load_model_profile as p_load
    from distilp_torch.solver import halda_solve_scenarios as p_scen
    from distilp_torch.utils import make_synthetic_fleet as p_fleet
    from distilp_tpu.common import load_model_profile as j_load
    from distilp_tpu.solver import halda_solve_scenarios as j_scen
    from distilp_tpu.utils import make_synthetic_fleet as j_fleet

    res = []
    for scen, fleet, load, kw in ((j_scen, j_fleet, j_load, {}),
                                  (p_scen, p_fleet, p_load, {"device": "cpu"})):
        model = load(f"{ONLINE}/model_profile.json")
        base = fleet(4, seed=5)
        bad = [d.model_copy(deep=True) for d in base]
        for q in bad[0].scpu:
            bad[0].scpu[q] = {col: v * 2.0 for col, v in bad[0].scpu[q].items()}
        tm = {}
        res.append((_quiet(scen, [base, bad], model, k_candidates=[8, 10], kv_bits="4bit",
                           mip_gap=GAP, lp_backend="pdhg", timings=tm, **kw), tm))
    (ref, jtm), (got, tm) = res
    assert tm["scenario_fallback"] == jtm["scenario_fallback"] == 1.0
    assert tm["lp_backend"] == "pdhg"
    for r, g in zip(ref, got):
        assert (g.k, g.certified) == (r.k, r.certified)
        assert abs(g.obj_value - r.obj_value) <= 2 * GAP * abs(r.obj_value)
