"""Per-k optima in the port (K3's per-k mode and ``halda_solve_per_k``)
against the JAX package.

- One branch-and-bound round at a time in per-k mode, fed the same fixed LP
  result as the JAX package's ``_bnb_round(per_k=True)`` (the JAX one
  through ``backend_jax.ipm_solve_batch`` monkeypatched, the port's through
  ``search.ipm_solve_batch``), on the hermes_70b root and with a forced small
  ``node_cap`` so that the frontier spills and the k-fair re-rank decides
  what is kept: the per-k incumbents, assignments and overflow floors, the
  kept rows and their k's are equal bit for bit; the bounds within float64
  rtol 1e-12.
- ``halda_solve_per_k`` on the port's plain path (``device='cpu'``): every k
  certified and within 2x gap of the JAX package's per-k objective and of
  the HiGHS oracle (hermes_70b, a 5-device synthetic fleet, Mixtral 8x7B on
  4 devices), and a one-round budget warns and certifies nothing unearned.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from distilp_torch.common import load_from_profile_folder, load_model_profile  # noqa: E402
from distilp_torch.interop import from_jax_arrays  # noqa: E402
from distilp_torch.ops.ipm import (  # noqa: E402
    IPMResult,
    IPMWarmState,
    LPBatch,
    ipm_solve_batch_reference,
)
from distilp_torch.solver import halda_solve_per_k  # noqa: E402
from distilp_torch.solver import search as S  # noqa: E402
from distilp_torch.solver import standard_form as SF  # noqa: E402
from distilp_torch.solver.api import _build_instance  # noqa: E402
from distilp_torch.solver.backend_cpu import solve_fixed_k_cpu  # noqa: E402
from distilp_torch.solver.backend_torch import device_arrays  # noqa: E402
from distilp_torch.solver.rounding import pack_rounding_data, rounding_data  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402
from distilp_tpu.ops.ipm import IPMResult as JResult  # noqa: E402
from distilp_tpu.solver import backend_jax as BJ  # noqa: E402
from torch_lanes import lane_data, lane_state, unlane_state  # noqa: E402

PER_K_FIELDS = ("per_k_best", "per_k_w", "per_k_n", "per_k_y", "per_k_dropped", "node_kidx",
                "active")


def _setup(profiles_dir, name, cap):
    if name == "north_star":
        model = load_model_profile(
            profiles_dir / "llama_3_70b" / "online" / "model_profile.json"
        )
        devs = make_synthetic_fleet(16, seed=123)
    else:
        devs, model = load_from_profile_folder(profiles_dir / name)
    Ks, _, coeffs, arrays = _build_instance(devs, model, None, "4bit", None, None)
    M = len(devs)
    kWs = [(k, model.L // k) for k in Ks if model.L // k >= M]
    sf = SF.build_standard_form(arrays, coeffs, kWs)
    host = device_arrays(sf)
    rd_np = SF.rounding_arrays_np(coeffs)
    rd = rounding_data(rd_np, "cpu")
    t = {k: torch.as_tensor(v) for k, v in host.items()}
    pdata = S.SweepData(
        A=t["A"], b_k=t["b_k"], c_k=t["c_k"], int_mask=t["int_mask"],
        ks=torch.tensor(sf.ks, dtype=torch.float64),
        Ws=torch.tensor(sf.Ws, dtype=torch.float64),
        obj_const=float(sf.obj_const), rd=rd, rd_packed=pack_rounding_data(rd),
    )
    jdata = BJ.SweepData(
        A=jnp.asarray(host["A"]), b_k=jnp.asarray(host["b_k"]),
        c_k=jnp.asarray(host["c_k"]), int_mask=jnp.asarray(host["int_mask"]),
        ks=jnp.asarray(sf.ks, jnp.float64), Ws=jnp.asarray(sf.Ws, jnp.float64),
        obj_const=jnp.asarray(sf.obj_const, jnp.float64),
        rd=BJ.RoundingData(**{k: jnp.asarray(v, jnp.float64) for k, v in rd_np.items()}),
    )
    n_k = len(kWs)
    if cap is None:
        cap, *_ = SF.resolve_search_params(False, n_k, None, None, None, None, M=M,
                                           per_k=True)
    jstate = BJ._root_state(
        jnp.asarray(host["lo_k"]), jnp.asarray(host["hi_k"]), M, cap, host["A"].shape[0]
    )
    return pdata, jdata, jstate, n_k


def _fixed_result(pdata, pstate, B, iters, chunk):
    kidx = pstate.node_kidx[:B].long()
    res = ipm_solve_batch_reference(
        LPBatch(pdata.A, pdata.b_k[kidx], pdata.c_k[kidx],
                pstate.node_lo[:B], pstate.node_hi[:B]),
        iters=iters, chunk=chunk, skip=~pstate.active[:B],
        warm=IPMWarmState(pstate.node_v[:B], pstate.node_y[:B], pstate.node_z[:B],
                          pstate.node_f[:B], pstate.node_warm[:B]),
    )
    return {f: getattr(res, f).numpy() for f in IPMResult._fields if f != "trace_buf"}


def _assert_states_match(got, ref):
    for f in S.SearchState._fields:
        g = getattr(got, f).numpy()
        r = np.asarray(getattr(ref, f))
        assert g.shape == r.shape, f
        if r.dtype == np.float64 and f not in PER_K_FIELDS:
            np.testing.assert_allclose(g, r, rtol=1e-12, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(g, r, err_msg=f)


@pytest.mark.parametrize("name,gap,cap,beam", [
    ("hermes_70b", 1e-4, None, None),
    ("hermes_70b", 1e-9, 12, 12),
    ("north_star", 1e-3, 6, 5),
])
def test_per_k_round_matches_jax_bnb_round(profiles_dir, monkeypatch, name, gap, cap, beam):
    pdata, jdata, jstate, n_k = _setup(profiles_dir, name, cap)
    spilled = False
    for rnd in range(5):
        B = n_k if rnd == 0 else (beam or 4 * n_k)
        B = min(B, jstate.node_lo.shape[0])
        iters, chunk = (8, 8) if rnd == 0 else (6, 4)
        pstate = from_jax_arrays(jstate)
        fixed = _fixed_result(pdata, pstate, B, iters, chunk)
        jres = JResult(**{f: jnp.asarray(v) for f, v in fixed.items()})
        pres = IPMResult(**{f: torch.as_tensor(v) for f, v in fixed.items()})
        monkeypatch.setattr(BJ, "ipm_solve_batch", lambda *a, **k: jres)
        monkeypatch.setattr(S, "ipm_solve_batch", lambda *a, **k: pres)
        jnext = BJ._bnb_round(jdata, jstate, gap, ipm_iters=iters, beam=B, ipm_chunk=chunk,
                              per_k=True)
        pnext, _ = S.bnb_round(lane_data(pdata), lane_state(pstate), gap, ipm_iters=iters,
                               beam=B, ipm_chunk=chunk, per_k=True)
        pnext = unlane_state(pnext)
        _assert_states_match(pnext, jnext)
        np.testing.assert_array_equal(S.per_k_bound(pnext).numpy(),
                                      np.asarray(BJ._per_k_bound(jnext)))
        assert bool(S.certified_per_k(pnext, gap)) == bool(BJ._certified_per_k(jnext, gap))
        spilled |= bool(np.isfinite(np.asarray(jnext.per_k_dropped)).any())
        jstate = jnext
        if not bool(jnp.any(jstate.active)) or bool(BJ._certified_per_k(jstate, gap)):
            break
    if cap is not None:
        assert spilled, "the forced capacity never spilled a node"
    else:
        assert rnd >= 1


def test_fair_rank_keeps_each_k_its_best_rows():
    """The plain rank entry on a hand-made frontier: k 0 has the three best
    bounds, k 1 one; with cap 2 the fair order keeps each k's best row and
    floors k 0 at its second bound (the first it spilled)."""
    bound = torch.tensor([1.0, 2.0, 3.0, 4.0, 9.0], dtype=torch.float64)
    kidx = torch.tensor([0, 0, 0, 1, 1], dtype=torch.int32)
    active = torch.tensor([True, True, True, True, False])
    order = torch.argsort(torch.where(active, bound, np.inf), stable=True)
    dropped = torch.full((2,), np.inf, dtype=torch.float64)
    key, floor = (x[0] for x in S.per_k_fair_rank(order[None], kidx[None], active[None],
                                                   bound[None], 2, dropped[None]))
    kept = order[torch.argsort(key, stable=True)][:2]
    assert kept.tolist() == [0, 3]
    assert floor.tolist() == [2.0, np.inf]


def _jax_per_k(devs_fn, model_fn, gap, kv_bits):
    import distilp_tpu.solver.api as japi

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return {r.k: r for r in japi.halda_solve_per_k(devs_fn(), model_fn(), mip_gap=gap,
                                                       kv_bits=kv_bits)}


def test_per_k_hermes_matches_jax_and_highs(profiles_dir):
    from distilp_tpu.common import load_from_profile_folder as jload

    devs, model = load_from_profile_folder(profiles_dir / "hermes_70b")
    gap = 1e-4
    got = halda_solve_per_k(devs, model, mip_gap=gap, kv_bits="4bit", device="cpu")
    ref = _jax_per_k(lambda: jload(profiles_dir / "hermes_70b")[0],
                     lambda: jload(profiles_dir / "hermes_70b")[1], gap, "4bit")
    assert len(got) >= 8 and sorted(r.k for r in got) == sorted(ref)
    _, _, _, arrays = _build_instance(devs, model, None, "4bit", None, None)
    for r in got:
        assert r.certified and r.gap is not None and r.gap <= gap
        assert sum(r.w) * r.k == model.L
        assert all(0 <= n <= w for w, n in zip(r.w, r.n))
        oracle = solve_fixed_k_cpu(arrays, r.k, model.L // r.k, mip_gap=gap).obj_value
        for other in (ref[r.k].obj_value, oracle):
            assert abs(r.obj_value - other) <= 2 * gap * abs(other) + 1e-9, (r.k, other)


def test_per_k_multi_device_matches_jax(profiles_dir):
    from distilp_tpu.common import load_model_profile as jload
    from distilp_tpu.utils import make_synthetic_fleet as jfleet

    path = profiles_dir / "llama_3_70b" / "online" / "model_profile.json"
    model = load_model_profile(path)
    gap = 1e-3
    got = halda_solve_per_k(make_synthetic_fleet(5, seed=11), model, mip_gap=gap,
                            kv_bits="4bit", device="cpu")
    ref = _jax_per_k(lambda: jfleet(5, seed=11), lambda: jload(path), gap, "4bit")
    assert len(got) >= 2 and sorted(r.k for r in got) == sorted(ref)
    for r in got:
        assert r.certified and sum(r.w) * r.k == model.L
        other = ref[r.k].obj_value
        assert abs(r.obj_value - other) <= 2 * gap * abs(other) + 1e-9, r.k


def test_per_k_truncated_budget_never_fabricates_certificates(profiles_dir):
    devs, model = load_from_profile_folder(profiles_dir / "hermes_70b")
    with pytest.warns(RuntimeWarning, match="per-k sweep"):
        got = halda_solve_per_k(devs, model, mip_gap=1e-9, kv_bits="4bit", max_rounds=1,
                                device="cpu")
    assert any(not r.certified for r in got)
    for r in got:
        if not r.certified:
            assert r.gap is None or r.gap > 1e-9


def test_per_k_moe_mixtral_matches_jax_and_highs():
    from distilp_torch.profiler import profile_model
    from distilp_tpu.profiler.api import profile_model as jprofile
    from distilp_tpu.utils import make_synthetic_fleet as jfleet

    cfg = "tests/configs/mixtral_8x7b.json"
    model = profile_model(cfg, batch_sizes=[1], sequence_length=128).to_model_profile()
    devs = make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9))
    gap = 1e-3
    got = halda_solve_per_k(devs, model, mip_gap=gap, kv_bits="8bit", device="cpu")
    ref = _jax_per_k(lambda: jfleet(4, seed=7, pool_bytes=int(64e9)),
                     lambda: jprofile(cfg, batch_sizes=[1],
                                      sequence_length=128).to_model_profile(),
                     gap, "8bit")
    oracle = {r.k: r.obj_value for r in halda_solve_per_k(
        devs, model, mip_gap=gap, kv_bits="8bit", backend="cpu")}
    assert sorted(r.k for r in got) == sorted(ref) == sorted(oracle)
    for r in got:
        assert r.certified and sum(r.y) == model.n_routed_experts
        for other in (ref[r.k].obj_value, oracle[r.k]):
            assert abs(r.obj_value - other) <= 2 * gap * abs(other) + 1e-9, (r.k, other)


def test_per_k_plot_and_unknown_backend_raise(profiles_dir, monkeypatch):
    from distilp_torch.solver import plotter

    devs, model = load_from_profile_folder(profiles_dir / "llama_3_70b" / "online")
    drawn = []
    monkeypatch.setattr(plotter, "plot_k_curve",
                        lambda objs, k_star=None, **kw: drawn.append((objs, k_star)))
    got = halda_solve_per_k(devs, model, plot=True, device="cpu")
    assert drawn == [([(r.k, r.obj_value) for r in got],
                      min(got, key=lambda r: r.obj_value).k)]
    with pytest.raises(ValueError, match="backend"):
        halda_solve_per_k(devs, model, backend="jax", device="cpu")
