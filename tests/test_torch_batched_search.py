"""The batched search (B12): per-instance K2, K2 MoE, K3 and K7, and the
search of several lanes at once, on the CPU through the plain versions.

- K2 (dense and MoE) with a stack of rounding instances and a per-row
  instance index, against the JAX package's ``_round_to_incumbent`` vmapped
  over each instance's rows (a padded instance with phantom devices among
  them: its own ``w_active``);
- one branch-and-bound round of two lanes (K2 and K3 through their
  per-instance entries, K3's per-k entries through their lane grid) against
  the JAX package's ``_bnb_round`` on each lane, with the LP result fixed;
  a frozen lane comes back unchanged;
- K7's instance axis: the float32 and float64 evaluations and a short
  ascent of two Mixtral instances in lockstep, against the reference's per
  instance;
- whole searches: each lane of ``solve_batch`` ends where the port's own
  single solve of that instance ends (same k, w, n, round count, objective
  within 1e-9 relative), with one lane settling in its first round while
  another runs on.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from distilp_torch.common import load_model_profile  # noqa: E402
from distilp_torch.interop import from_jax_arrays  # noqa: E402
from distilp_torch.ops import decomp as D  # noqa: E402
from distilp_torch.ops.ipm import (  # noqa: E402
    IPMResult,
    IPMWarmState,
    LPBatch,
    ipm_solve_batch_reference,
)
from distilp_torch.profiler import profile_model  # noqa: E402
from distilp_torch.solver import rounding as R  # noqa: E402
from distilp_torch.solver import search as S  # noqa: E402
from distilp_torch.solver import standard_form as SF  # noqa: E402
from distilp_torch.solver.api import _build_instance  # noqa: E402
from distilp_torch.solver.backend_torch import device_arrays, solve_sweep_torch  # noqa: E402
from distilp_torch.solver.batchlayout import pack_instance, pad_instance, solve_batch  # noqa: E402
from distilp_torch.solver.coeffs import valid_factors_of_L  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402
from distilp_tpu.ops.ipm import IPMResult as JResult  # noqa: E402
from distilp_tpu.solver import api as japi  # noqa: E402
from distilp_tpu.solver import backend_jax as BJ  # noqa: E402
from distilp_tpu.solver import batchlayout as JBL  # noqa: E402
from torch_lanes import lane_data, unlane_state  # noqa: E402

DENSE_SEEDS = (123, 5)
MIXTRAL_LOADS = (None, [1.5, 0.8, 1.0, 0.9])


def _online(profiles_dir):
    return load_model_profile(profiles_dir / "llama_3_70b" / "online" / "model_profile.json")


def _dense_pair(profiles_dir, M, seed, M_pad=None):
    """(port (coeffs, arrays), reference (coeffs, arrays), kWs) of a fleet
    on the online model, padded to ``M_pad`` devices when given."""
    from distilp_tpu.common import load_model_profile as jmodel
    from distilp_tpu.utils import make_synthetic_fleet as jfleet

    model = _online(profiles_dir)
    _, _, coeffs, arrays = _build_instance(make_synthetic_fleet(M, seed=seed), model, None,
                                           "4bit", None, None)
    jm = jmodel(profiles_dir / "llama_3_70b" / "online" / "model_profile.json")
    _, _, jcoeffs, jarrays = japi._build_instance(jfleet(M, seed=seed), jm, None, "4bit",
                                                  None, None)
    if M_pad is not None:
        coeffs, arrays = pad_instance(coeffs, arrays, M_pad)
        jcoeffs, jarrays = JBL.pad_instance(jcoeffs, jarrays, M_pad)
    kWs = [(k, model.L // k) for k in valid_factors_of_L(model.L) if model.L // k >= M]
    return (coeffs, arrays), (jcoeffs, jarrays), kWs


def _mixtral_pair(factors):
    from distilp_tpu.profiler.api import profile_model as jprofile
    from distilp_tpu.utils import make_synthetic_fleet as jfleet

    cfg = "tests/configs/mixtral_8x7b.json"
    model = profile_model(cfg, batch_sizes=[1], sequence_length=128).to_model_profile()
    jm = jprofile(cfg, batch_sizes=[1], sequence_length=128).to_model_profile()
    _, _, coeffs, arrays = _build_instance(make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9)),
                                           model, None, "8bit", None, factors)
    _, _, jc, ja = japi._build_instance(jfleet(4, seed=7, pool_bytes=int(64e9)), jm, None,
                                        "8bit", None, factors)
    kWs = [(k, model.L // k) for k in valid_factors_of_L(model.L) if model.L // k >= 4]
    return (coeffs, arrays), (jc, ja), kWs


def _rows(rng, M, nf, W, B, moe_E=0):
    """LP-like points: w a noisy split of W layers, n <= w, y a noisy split
    of E experts (MoE)."""
    v = rng.uniform(0.0, 3.0, size=(B, nf))
    w = rng.dirichlet(np.ones(M), size=B) * W[:, None] + rng.normal(0, 0.3, size=(B, M))
    v[:, :M] = np.clip(w, 0.6, W[:, None])
    v[:, M : 2 * M] = v[:, :M] * rng.uniform(0, 1, size=(B, M))
    if moe_E:
        v[:, 2 * M : 3 * M] = rng.dirichlet(np.ones(M), size=B) * moe_E + \
            rng.normal(0, 0.4, size=(B, M))
    return v


def _round_case(insts, rng, B, moe):
    """Rows of several instances: (v, W, k, inst) numpy, the port's stack
    and the reference's per-instance rounding data."""
    kWs = insts[0][2]
    inst = rng.integers(0, len(insts), B)
    kidx = rng.integers(0, len(kWs), B)
    W = np.array([kWs[j][1] for j in kidx], np.float64)
    k = np.array([kWs[j][0] for j in kidx], np.float64)
    M = insts[0][0][1].layout.M
    nf = insts[0][0][1].layout.n_vars + 8
    E = int(insts[0][0][1].moe.E) if moe else 0
    v = _rows(rng, M, nf, W, B, E)
    rds = [R.rounding_data(SF.rounding_arrays_np(c, a.moe), "cpu") for (c, a), _, _ in insts]
    jrds = [BJ.rounding_data(jc, ja.moe) for _, (jc, ja), _ in insts]
    return v, W, k, inst, R.stack_rounding_data(rds), jrds, M


def _jax_rows(jrds, v, W, k, inst, M, moe, **kw):
    """The reference's rounding vmapped over the rows, each row with its own
    instance's rounding data (one vmap over the stacked data)."""
    rows_rd = BJ.RoundingData(*[jnp.stack([jnp.asarray(getattr(jrds[q], f)) for q in inst])
                                for f in BJ.RoundingData._fields])
    got = jax.vmap(lambda vv, WW, kk, rd: BJ._round_to_incumbent(
        vv, M, WW, kk, rd, moe=moe, **kw))(
        jnp.asarray(v), jnp.asarray(W), jnp.asarray(k), rows_rd)
    return [np.asarray(g) for g in got]


def test_dense_rounding_per_instance_matches_jax(profiles_dir):
    """Three instances in one call, one of them a 6-device fleet padded to
    8 (phantom devices pinned to w = 0 by its own w_active)."""
    insts = [_dense_pair(profiles_dir, 8, s) for s in DENSE_SEEDS]
    insts.append(_dense_pair(profiles_dir, 6, 9, M_pad=8))
    rng = np.random.default_rng(4)
    v, W, k, inst, rd, jrds, M = _round_case(insts, rng, 48, moe=False)
    obj, w, n = R.round_to_incumbent(torch.tensor(v, dtype=torch.float32), torch.tensor(W),
                                     torch.tensor(k), rd, inst=torch.tensor(inst))
    jobj, jw, jn, _ = _jax_rows(jrds, v.astype(np.float32), W, k, inst, M, moe=False)
    np.testing.assert_array_equal(w.numpy(), jw)
    np.testing.assert_array_equal(n.numpy(), jn)
    # The objective sums the devices' costs in another order: 1e-12.
    np.testing.assert_allclose(obj.numpy(), jobj, rtol=1e-12)
    assert np.isfinite(jobj).sum() >= 12
    padded = inst == 2
    assert padded.any() and (w.numpy()[padded][:, 6:] == 0).all()


@pytest.mark.parametrize("y_steps", [None, 12])
def test_moe_rounding_per_instance_matches_jax(y_steps):
    """Mixtral over 4 devices under two expert-load regimes (their own
    g_raw), LP rows and (``y_steps``) hint rows."""
    insts = [_mixtral_pair(f) for f in MIXTRAL_LOADS]
    rng = np.random.default_rng(7 if y_steps is None else 8)
    v, W, k, inst, rd, jrds, M = _round_case(insts, rng, 16, moe=True)
    if y_steps is not None:
        v = np.round(v)
    got = R.round_to_incumbent(torch.tensor(v), torch.tensor(W), torch.tensor(k), rd,
                               moe=True, y_steps=y_steps, inst=torch.tensor(inst))
    ref = _jax_rows(jrds, v, W, k, inst, M, moe=True, y_steps=y_steps)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g.numpy(), r)
    np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=1e-12)
    assert np.isfinite(ref[0]).any()


def _lane_setup(profiles_dir, seeds, cap):
    """Two dense lanes (fleets of 8 devices): the port's lane data and each
    lane's reference data and root state."""
    pdatas, jdatas, jstates = [], [], []
    for seed in seeds:
        (coeffs, arrays), _, kWs = _dense_pair(profiles_dir, 8, seed)
        sf = SF.build_standard_form(arrays, coeffs, kWs)
        host = device_arrays(sf)
        rd_np = SF.rounding_arrays_np(coeffs)
        rd = R.rounding_data(rd_np, "cpu")
        t = {kk: torch.as_tensor(vv) for kk, vv in host.items()}
        pdatas.append(lane_data(S.SweepData(
            A=t["A"], b_k=t["b_k"], c_k=t["c_k"], int_mask=t["int_mask"],
            ks=torch.tensor(sf.ks, dtype=torch.float64),
            Ws=torch.tensor(sf.Ws, dtype=torch.float64),
            obj_const=float(sf.obj_const), rd=rd, rd_packed=R.pack_rounding_data(rd),
        )))
        jdatas.append(BJ.SweepData(
            A=jnp.asarray(host["A"]), b_k=jnp.asarray(host["b_k"]),
            c_k=jnp.asarray(host["c_k"]), int_mask=jnp.asarray(host["int_mask"]),
            ks=jnp.asarray(sf.ks, jnp.float64), Ws=jnp.asarray(sf.Ws, jnp.float64),
            obj_const=jnp.asarray(sf.obj_const, jnp.float64),
            rd=BJ.RoundingData(**{kk: jnp.asarray(vv, jnp.float64) for kk, vv in rd_np.items()}),
        ))
        jstates.append(BJ._root_state(jnp.asarray(host["lo_k"]), jnp.asarray(host["hi_k"]),
                                      8, cap, host["A"].shape[0]))
    cat = lambda f: torch.cat([getattr(d, f) for d in pdatas])  # noqa: E731
    data = pdatas[0]._replace(
        A=torch.stack([d.A for d in pdatas]), b_k=cat("b_k"), c_k=cat("c_k"),
        int_mask=cat("int_mask"), ks=cat("ks"), Ws=cat("Ws"), obj_const=cat("obj_const"),
        rd=R.RoundingData(*[torch.cat([getattr(d.rd, f) for d in pdatas])
                            for f in R.RoundingData._fields]),
        rd_packed=cat("rd_packed"),
    )
    return data, jdatas, jstates


def _fixed_lp(data, state, q, B, iters, chunk):
    """A real LP result for lane q's first B rows (plain IPM)."""
    kidx = state.node_kidx[:B].long()
    return ipm_solve_batch_reference(
        LPBatch(data.A[q], data.b_k[q][kidx], data.c_k[q][kidx], state.node_lo[:B],
                state.node_hi[:B]),
        iters=iters, chunk=chunk, skip=~state.active[:B],
        warm=IPMWarmState(state.node_v[:B], state.node_y[:B], state.node_z[:B],
                          state.node_f[:B], state.node_warm[:B]),
    )


def _assert_lane_matches(got, ref):
    for f in S.SearchState._fields:
        g, r = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        assert g.shape == r.shape, f
        if r.dtype == np.float64 and not f.startswith("per_k"):
            np.testing.assert_allclose(g, r, rtol=1e-12, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(g, r, err_msg=f)


@pytest.mark.parametrize("per_k", [False, True])
def test_two_lane_round_matches_jax_per_lane(profiles_dir, monkeypatch, per_k):
    """Each lane of one batched round (one K2, one K3 call over both lanes'
    rows; K3's per-k entries one block per lane) equals the reference's
    round of that lane alone; a frozen lane is carried through unchanged."""
    cap = 40
    data, jdatas, jstates = _lane_setup(profiles_dir, DENSE_SEEDS, cap)
    gap = 1e-3
    for rnd, (B, iters, chunk) in enumerate([(None, 8, 8), (6, 6, 4)]):
        lanes = [from_jax_arrays(js) for js in jstates]
        B = B or int(jstates[0].per_k_best.shape[0])
        fixed = [_fixed_lp(data, st, q, B, iters, chunk) for q, st in enumerate(lanes)]
        both = IPMResult(**{f: torch.cat([getattr(r, f) for r in fixed])
                            for f in IPMResult._fields if f != "trace_buf"})
        monkeypatch.setattr(S, "ipm_solve_batch", lambda *a, **k: both)
        state = S.SearchState(*[torch.stack(t) for t in zip(*lanes)])
        frozen = torch.tensor([False, rnd == 1])
        nxt, _ = S.bnb_round(data, state, gap, ipm_iters=iters, beam=B, ipm_chunk=chunk,
                             per_k=per_k, frozen=frozen)
        for q, (js, jd) in enumerate(zip(jstates, jdatas)):
            if bool(frozen[q]):
                _assert_lane_matches(unlane_state(nxt, q), js)
                continue
            jres = JResult(**{f: jnp.asarray(getattr(fixed[q], f).numpy())
                              for f in IPMResult._fields if f != "trace_buf"})
            monkeypatch.setattr(BJ, "ipm_solve_batch", lambda *a, **k: jres)
            jstates[q] = BJ._bnb_round(jd, js, gap, ipm_iters=iters, beam=B, ipm_chunk=chunk,
                                       per_k=per_k)
            _assert_lane_matches(unlane_state(nxt, q), jstates[q])
        np.testing.assert_array_equal(
            S.best_bound(nxt).numpy(), [float(BJ._best_bound(js)) for js in jstates])


def _mixtral_problems():
    insts = [_mixtral_pair(f) for f in MIXTRAL_LOADS]
    p32, p64, refs = [], [], []
    for (coeffs, arrays), (jc, ja), kWs in insts:
        rd_np = SF.rounding_arrays_np(coeffs, arrays.moe)
        ks = np.array([k for k, _ in kWs], np.float64)
        Ws = np.array([W for _, W in kWs], np.float64)
        w_max, e_max = int(Ws.max()), int(rd_np["E"])
        p32.append(D.decomp_problem(rd_np, ks, Ws, w_max, e_max, torch.float32, "cpu"))
        p64.append(D.decomp_problem(rd_np, ks, Ws, w_max, e_max, torch.float64, "cpu"))
        refs.append((BJ.rounding_data(jc, ja.moe), jnp.asarray(ks), jnp.asarray(Ws), w_max,
                     e_max, rd_np))
    return D.stack_problems(p32), D.stack_problems(p64), refs


def test_decomp_instance_axis_matches_jax():
    """K7 over two Mixtral instances in one evaluation: the float64 bound
    and y-profile of each equal the reference's evaluation of that instance
    at the same multipliers, the float32 bound agrees to 1e-6, and a
    20-step ascent of both in lockstep matches the reference's per
    instance."""
    b32, b64, refs = _mixtral_problems()
    S_, n_k = b64.ks.shape
    M = b64.rdv.shape[-1]
    rng = np.random.default_rng(3)
    lam = rng.normal(0, 1, (S_, n_k)).astype(np.float32)
    mu = rng.normal(0, 0.3, (S_, n_k)).astype(np.float32)
    tau = rng.normal(0, 1, (S_, n_k, M)).astype(np.float32)
    b, _ = D.eval32(b32, *(torch.tensor(x) for x in (lam, mu, tau)))
    bound, m_y, *_ = D.eval64(b64, *(torch.tensor(x).double() for x in (lam, mu, tau)), True)
    ascent = D.decomp_bound_roots(b32, b64, R.stack_rounding_data(
        [R.rounding_data(r[5], "cpu") for r in refs]), 20)
    for s, (jrd, jks, jWs, w_max, e_max, _) in enumerate(refs):
        jout = BJ._decomp_bound_roots(jrd, jks, jWs, w_max, e_max, steps=0, moe=True,
                                      init_params=tuple(jnp.asarray(x[s])
                                                        for x in (lam, mu, tau)))
        # Float64: 1e-12 relative (the per-device terms summed in another
        # order), infeasible cells at the same places.
        jm = np.asarray(jout[5])
        assert np.array_equal(np.isfinite(jm), np.isfinite(m_y[s].numpy()))
        fin = np.isfinite(jm)
        np.testing.assert_allclose(m_y[s].numpy()[fin], jm[fin], rtol=1e-12)
        np.testing.assert_allclose(bound[s].numpy(), np.asarray(jout[0]), rtol=1e-12)
        one = D.eval32(D.stack_problems([b32.instance(s)]),
                       *(torch.tensor(x[s:s + 1]) for x in (lam, mu, tau)))[0][0]
        np.testing.assert_allclose(b[s].numpy(), one.numpy(), rtol=1e-6)
        np.testing.assert_allclose(b[s].numpy(), np.asarray(jout[0]), rtol=1e-5)
        jasc = BJ._decomp_bound_roots(jrd, jks, jWs, w_max, e_max, steps=20, moe=True)
        np.testing.assert_allclose(ascent[0][s].numpy(), np.asarray(jasc[0]), rtol=1e-6)


def _pack(profiles_dir, M, seed, warm=None, **kw):
    model = _online(profiles_dir)
    Ks, _, coeffs, arrays = _build_instance(make_synthetic_fleet(M, seed=seed), model, None,
                                            "4bit", None, None)
    kWs = [(k, model.L // k) for k in Ks]
    return (arrays, kWs, coeffs), pack_instance(arrays, kWs, mip_gap=1e-3, coeffs=coeffs,
                                                warm=warm, **kw)


def _single(inst_args, warm=None, **kw):
    arrays, kWs, coeffs = inst_args
    tm = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, best = solve_sweep_torch(arrays, kWs, mip_gap=1e-3, coeffs=coeffs, warm=warm,
                                    timings=tm, device="cpu", **kw)
    return best, tm


def test_lanes_end_where_their_single_solves_end(profiles_dir):
    """Three 6-device fleets as lanes of one search: each lane's k, w, n and
    round count equal the port's single solve of that fleet, the objective
    within 1e-9 relative; one launch of K1 per round covers every lane."""
    from distilp_torch import kernels

    args, insts = zip(*[_pack(profiles_dir, 6, s) for s in (3, 4, 5)])
    stats = [{} for _ in insts]
    for inst, st in zip(insts, stats):
        inst.stats = st
    tm = {}
    out = solve_batch(list(insts), timings=tm, device="cpu")
    assert tm["batch_size"] == 3 and tm["lanes"] == 3
    for a, (_, best), st in zip(args, out, stats):
        ref, rtm = _single(a)
        assert (best.k, best.w, best.n) == (ref.k, ref.w, ref.n)
        assert best.obj_value == pytest.approx(ref.obj_value, rel=1e-9)
        assert best.certified and ref.certified
        assert st["bnb_rounds"] == rtm["bnb_rounds"]
    assert kernels.LAUNCHES["ipm"] == 0  # the plain versions on the CPU


def test_frozen_lane_settles_in_round_one_while_another_runs_on(profiles_dir):
    """Lane 0 is warm-seeded with its own optimum and settles in its first
    round; lane 1, seeded with a poor placement, runs on. Each ends where
    its single solve from the same seed ends."""
    a0, _ = _pack(profiles_dir, 6, 3)
    best0, _ = _single(a0)
    a1, _ = _pack(profiles_dir, 6, 4)
    W = _online(profiles_dir).L // best0.k
    poor = best0.model_copy(update={"w": [1] * 5 + [W - 5], "n": [0] * 6,
                                    "ipm_state": None, "duals": None})
    _, i0 = _pack(profiles_dir, 6, 3, warm=best0.model_copy(update={"ipm_state": None}))
    _, i1 = _pack(profiles_dir, 6, 4, warm=poor)
    s0, s1 = {}, {}
    i0.stats, i1.stats = s0, s1
    out = solve_batch([i0, i1], device="cpu")
    assert s0["bnb_rounds"] == 1.0 and s1["bnb_rounds"] > 1.0
    for a, warm, (_, best), st in ((a0, best0.model_copy(update={"ipm_state": None}), out[0],
                                    s0), (a1, poor, out[1], s1)):
        ref, rtm = _single(a, warm=warm)
        assert (best.k, best.w, best.n) == (ref.k, ref.w, ref.n)
        assert best.obj_value == pytest.approx(ref.obj_value, rel=1e-9)
        assert st["bnb_rounds"] == rtm["bnb_rounds"]
