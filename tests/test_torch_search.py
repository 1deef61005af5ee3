"""The port's branch-and-bound round (plain version of kernel K3 and the
tensor code around it) against the JAX package's ``_bnb_round``.

Both rounds are fed the same fixed LP result: the JAX one through
``backend_jax.ipm_solve_batch`` monkeypatched in the test, the port's
through ``search.ipm_solve_batch``. Every field of the next search state
must match: exactly for int/bool/float32 fields, within rtol 1e-12 for
float64 ones.
"""

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
from distilp_torch.solver import search as S  # noqa: E402
from distilp_torch.solver import standard_form as SF  # noqa: E402
from distilp_torch.solver.api import _build_instance  # noqa: E402
from distilp_torch.solver.backend_torch import device_arrays  # noqa: E402
from distilp_torch.solver.rounding import pack_rounding_data, rounding_data  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402
from distilp_tpu.ops.ipm import IPMResult as JResult  # noqa: E402
from distilp_tpu.solver import backend_jax as BJ  # noqa: E402
from torch_lanes import lane_data, lane_state, unlane_state  # noqa: E402


def _setup(profiles_dir, name):
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
    cap = max(64, 2 * n_k)
    jstate = BJ._root_state(
        jnp.asarray(host["lo_k"]), jnp.asarray(host["hi_k"]), M, cap, host["A"].shape[0]
    )
    return pdata, jdata, jstate, n_k


def _fixed_result(pdata, pstate, B, iters, chunk):
    """A real LP result for the state's first B rows (plain version), as
    numpy arrays both packages can wrap."""
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
        if r.dtype == np.float64:
            np.testing.assert_allclose(g, r, rtol=1e-12, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(g, r, err_msg=f)


@pytest.mark.parametrize(
    "name,gap", [("north_star", 1e-3), ("llama_3_70b/online", 1e-4), ("hermes_70b", 1e-4)]
)
def test_round_matches_jax_bnb_round(profiles_dir, monkeypatch, name, gap):
    pdata, jdata, jstate, n_k = _setup(profiles_dir, name)
    for rnd, (B, iters, chunk) in enumerate([(n_k, 8, 8), (6, 6, 4), (6, 6, 4)]):
        pstate = from_jax_arrays(jstate)
        fixed = _fixed_result(pdata, pstate, B, iters, chunk)
        jres = JResult(**{f: jnp.asarray(v) for f, v in fixed.items()})
        pres = IPMResult(**{f: torch.as_tensor(v) for f, v in fixed.items()})
        monkeypatch.setattr(BJ, "ipm_solve_batch", lambda *a, **k: jres)
        monkeypatch.setattr(S, "ipm_solve_batch", lambda *a, **k: pres)
        jnext = BJ._bnb_round(jdata, jstate, gap, ipm_iters=iters, beam=B, ipm_chunk=chunk)
        pnext, _ = S.bnb_round(lane_data(pdata), lane_state(pstate), gap, ipm_iters=iters,
                               beam=B, ipm_chunk=chunk)
        pnext = unlane_state(pnext)
        _assert_states_match(pnext, jnext)
        assert float(S.best_bound(pnext)) == pytest.approx(
            float(BJ._best_bound(jnext)), rel=1e-12
        )
        assert bool(S.certified(pnext, gap)) == bool(BJ._certified(jnext, gap))
        jstate = jnext
        if not bool(jnp.any(jstate.active)):
            break
    assert rnd >= 1 or bool(BJ._certified(jstate, gap))


def test_epilogue_handles_inactive_and_diverged_rows():
    """Rows not processed get +inf bounds and never survive; a -inf LP bound
    folds to the parent's; a NaN LP bound counts as -inf."""
    rng = np.random.default_rng(2)
    B, nf, m = 4, 12, 5
    lo = torch.zeros((B, nf))
    hi = torch.full((B, nf), 3.0)
    v = torch.tensor(rng.uniform(0, 3, (B, nf)), dtype=torch.float32)
    res = IPMResult(
        v=v, bound=torch.tensor([0.5, -np.inf, np.nan, 0.0], dtype=torch.float64),
        obj=torch.zeros(B), rp_norm=torch.zeros(B), rd_norm=torch.zeros(B),
        mu=torch.zeros(B), converged=torch.zeros(B, dtype=torch.bool),
        reduced=torch.zeros((B, nf), dtype=torch.float64),
        y_dual=torch.zeros((B, m)), z_dual=torch.zeros((B, nf)), f_dual=torch.zeros((B, nf)),
        iters_run=torch.zeros(B, dtype=torch.int32),
    )
    parent = torch.tensor([0.0, 0.25, 0.75, 0.0], dtype=torch.float64)
    active = torch.tensor([True, True, True, False])
    out = S.bnb_epilogue(
        lo, hi, res, parent, active, torch.full((B,), np.inf, dtype=torch.float64),
        torch.full((B,), 10.0, dtype=torch.float64), torch.ones((1, nf), dtype=torch.bool),
        torch.zeros(1, dtype=torch.float64), torch.zeros((B, nf)), torch.zeros((B, m)),
        torch.zeros((B, nf)), torch.zeros((B, nf)), torch.zeros(B, dtype=torch.bool),
        torch.zeros(B, dtype=torch.int64),
    )
    assert out.bound.tolist() == [0.5, 0.25, 0.75, np.inf]
    assert out.survive.tolist() == [True, True, True, False]
    assert out.warm_new.tolist() == [True, True, True, False]
    # The branch splits the most fractional column: floor/ceil of v there.
    j = int((v[0] - v[0].round()).abs().argmax())
    assert float(out.hi_a[0, j]) == float(torch.floor(v[0, j]))
    assert float(out.lo_b[0, j]) == float(torch.floor(v[0, j])) + 1.0


def test_interop_roundtrips_search_state(profiles_dir):
    _, _, jstate, _ = _setup(profiles_dir, "llama_3_70b/online")
    pstate = from_jax_arrays(jstate)
    _assert_states_match(pstate, jstate)
    assert pstate.node_kidx.dtype == torch.int32
    assert pstate.active.dtype == torch.bool
