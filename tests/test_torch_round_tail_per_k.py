"""The round tail's per-k mode (R8 with ``per_k``: a per-k round's
rounding, per-k incumbents, thresholds, epilogue, k-fair compaction and
per-k certificate in one launch of ``round_tail_kernel.cu`` on a card) on
the CPU, through its plain version ``search.round_tail_reference``.

- ``bnb_round(per_k=True)`` (which on CPU tensors takes the plain version)
  against the JAX package's ``_bnb_round(per_k=True)`` with the LP result
  fixed, round by round: hermes_70b, hermes_70b with a forced small
  ``node_cap`` so that rounds spill and ``per_k_dropped`` moves, Mixtral M=4
  (MoE rows, pre-rounded by K2's MoE mode), and two north-star lanes with
  one lane frozen in the last round. Integer fields and masks equal; the
  per-k fields equal on dense rounds (``tests/test_torch_per_k.py``'s rule);
  every other float64 field, and a MoE round's per-k bests and floors,
  within rtol 1e-12 (the rounding sums the devices' costs in another
  order); ``per_k_bound`` and ``certified_per_k`` as the JAX package's.
- The go flags the plain version writes in per-k mode equal
  ``active.any(-1) & ~certified_per_k(new)``, and ``run_bnb_loop(per_k=
  True)``, which reads them, ends where a loop that tests every state ends,
  with one lane settling first.
- The CUDA wrapper (a stand-in library records what it passes): a per-k
  round through ``bnb_round`` is one ``round_tail`` (or ``round_tail_lanes``)
  launch and no launch of K2 (``round``), K3 (``bnb_epilogue``) or B15
  (``bnb_per_k``); the per-k dim set; the per-k fields in fresh memory (the
  other mode passes them through and hands the kernel no per-k outputs); a
  shape past ``TAIL_SMEM_LIMIT`` refused before launch.
- A pure-Python emulation of the kernel's k-fair places (each active row's
  rank in its k by counting in the first order, then sum_k min(cnt_k, g)
  plus the rank-g rows of other k's before it; an inactive row after every
  active one) and of its per-k argmin, NaN rule included, against torch
  (``per_k_fair_rank_reference``, ``argmin``) on the adversarial values.

One process: ~40 s on a 2-core CPU.
"""

import ctypes
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from distilp_torch import kernels  # noqa: E402
from distilp_torch.interop import from_jax_arrays  # noqa: E402
from distilp_torch.kernels import build  # noqa: E402
from distilp_torch.ops.ipm import IPMResult  # noqa: E402
from distilp_torch.solver import search as S  # noqa: E402
from distilp_tpu.ops.ipm import IPMResult as JResult  # noqa: E402
from distilp_tpu.solver import backend_jax as BJ  # noqa: E402
from test_torch_per_k import _setup  # noqa: E402
from test_torch_round_tail import (  # noqa: E402
    ADVERSARIAL,
    RES_FIELDS,
    _fixed_lp,
    _kernel_argmin,
    _kernel_order,
    _kernel_scatter_min,
    _lanes,
    _sweep,
)
from torch_lanes import lane_data, lane_state, unlane_state  # noqa: E402

EXACT_DENSE = ("per_k_best", "per_k_w", "per_k_n", "per_k_y", "per_k_dropped")


def _assert_per_k_matches(got, ref, moe: bool):
    for f in S.SearchState._fields:
        g, r = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        assert g.shape == r.shape, f
        if r.dtype == np.float64 and (moe or f not in EXACT_DENSE) and \
                f not in ("per_k_w", "per_k_n", "per_k_y"):
            np.testing.assert_allclose(g, r, rtol=1e-12, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(g, r, err_msg=f)


def _spy_go(monkeypatch, gap):
    """Record each plain tail's per_k flag and whether its go flags are the
    loop's per-k test on the state it returns."""
    seen = []
    orig = S.round_tail_reference

    def spy(*a, **kw):
        out, go = orig(*a, **kw)
        per_k = a[7] if len(a) > 7 else kw.get("per_k", False)
        test = S.certified_per_k if per_k else S.certified
        seen.append((per_k, bool(torch.equal(go, out.active.any(-1) & ~test(out, gap)))))
        return out, go

    monkeypatch.setattr(S, "round_tail_reference", spy)
    return seen


@pytest.mark.parametrize("case,gap,cap,beam,rounds", [
    ("hermes_70b", 1e-4, None, None, 4),
    ("hermes_70b_cap12", 1e-9, 12, 12, 5),
    ("mixtral", 1e-3, None, 8, 2),
], ids=["hermes_70b", "hermes_70b_spill", "mixtral_moe"])
def test_per_k_tail_matches_jax_bnb_round(profiles_dir, monkeypatch, case, gap, cap, beam,
                                          rounds):
    if case == "mixtral":
        pdata, jdata, jstate, n_k = _sweep(profiles_dir, "mixtral")
    else:
        pdata, jdata, jstate, n_k = _setup(profiles_dir, "hermes_70b", cap)
    moe = pdata.gky is not None
    ldata = lane_data(pdata)
    seen = _spy_go(monkeypatch, gap)
    spilled = False
    for rnd in range(rounds):
        B = min(n_k if rnd == 0 else (beam or 4 * n_k), jstate.node_lo.shape[0])
        iters, chunk = (8, 8) if rnd == 0 else (6, 4)
        pstate = from_jax_arrays(jstate)
        fixed = _fixed_lp(pdata, pstate, B, iters, chunk)
        jres = JResult(**{f: jnp.asarray(getattr(fixed, f).numpy()) for f in RES_FIELDS})
        monkeypatch.setattr(BJ, "ipm_solve_batch", lambda *a, **k: jres)
        monkeypatch.setattr(S, "ipm_solve_batch", lambda *a, **k: fixed)
        jnext = BJ._bnb_round(jdata, jstate, gap, ipm_iters=iters, beam=B, moe=moe,
                              ipm_chunk=chunk, per_k=True)
        pnext, _ = S.bnb_round(ldata, lane_state(pstate), gap, ipm_iters=iters, beam=B,
                               ipm_chunk=chunk, per_k=True)
        pnext = unlane_state(pnext)
        _assert_per_k_matches(pnext, jnext, moe)
        np.testing.assert_allclose(S.per_k_bound(pnext).numpy(),
                                   np.asarray(BJ._per_k_bound(jnext)), rtol=1e-12, atol=0)
        assert bool(S.certified_per_k(pnext, gap)) == bool(BJ._certified_per_k(jnext, gap))
        spilled |= bool(np.isfinite(np.asarray(jnext.per_k_dropped)).any())
        jstate = jnext
        if not bool(jnp.any(jstate.active)) or bool(BJ._certified_per_k(jstate, gap)):
            break
    assert seen and all(per_k and ok for per_k, ok in seen) and len(seen) == rnd + 1
    if cap is not None:
        assert spilled, "the forced capacity never spilled a node"


def test_two_north_star_lanes_with_a_frozen_lane(profiles_dir, monkeypatch):
    """Each lane of one batched per-k round equals the reference's per-k
    round of that lane alone; the lane frozen in the last round comes back
    unchanged, its per-k fields included."""
    cap, gap = 40, 1e-3
    data, jdatas, jstates = _lanes(profiles_dir, (123, 5), cap)
    seen = _spy_go(monkeypatch, gap)
    plan = [(None, 8, 8), (6, 6, 4), (6, 6, 4)]
    for rnd, (B, iters, chunk) in enumerate(plan):
        lanes = [from_jax_arrays(js) for js in jstates]
        B = B or int(jstates[0].per_k_best.shape[0])
        fixed = []
        for q, st in enumerate(lanes):
            one = data._replace(A=data.A[q], b_k=data.b_k[q], c_k=data.c_k[q], gky=None)
            fixed.append(_fixed_lp(one, st, B, iters, chunk))
        both = IPMResult(**{f: torch.cat([getattr(r, f) for r in fixed]) for f in RES_FIELDS})
        monkeypatch.setattr(S, "ipm_solve_batch", lambda *a, **k: both)
        state = S.SearchState(*[torch.stack(t) for t in zip(*lanes)])
        frozen = torch.tensor([False, rnd == len(plan) - 1])
        nxt, _ = S.bnb_round(data, state, gap, ipm_iters=iters, beam=B, ipm_chunk=chunk,
                             frozen=frozen, per_k=True)
        for q, (js, jd) in enumerate(zip(jstates, jdatas)):
            if bool(frozen[q]):
                _assert_per_k_matches(unlane_state(nxt, q), js, moe=False)
                continue
            jres = JResult(**{f: jnp.asarray(getattr(fixed[q], f).numpy()) for f in RES_FIELDS})
            monkeypatch.setattr(BJ, "ipm_solve_batch", lambda *a, **k: jres)
            jstates[q] = BJ._bnb_round(jd, js, gap, ipm_iters=iters, beam=B, ipm_chunk=chunk,
                                       per_k=True)
            _assert_per_k_matches(unlane_state(nxt, q), jstates[q], moe=False)
    assert len(seen) == len(plan) and all(per_k and ok for per_k, ok in seen)


# ------------------------------------------------------------------ the go flags


def test_per_k_go_flags_equal_the_loop_test(profiles_dir, monkeypatch):
    """The flags the plain tail writes in per-k mode are the loop's per-k
    test on the new state, and run_bnb_loop(per_k=True), which reads them
    instead of testing each state, ends where a loop that tests every state
    ends, one lane settling first."""
    cap, gap = 40, 1e-3
    data, _, jstates = _lanes(profiles_dir, (123, 5), cap)
    state0 = S.SearchState(*[torch.stack(t) for t in zip(*[from_jax_arrays(js)
                                                           for js in jstates])])
    seen = _spy_go(monkeypatch, gap)
    end, _, _ = S.run_bnb_loop(data, state0, gap, ipm_iters=12, max_rounds=20, beam=6,
                               per_k=True)
    ran = len(seen)
    assert ran and all(per_k and ok for per_k, ok in seen)
    # The same search, testing every state (no flags read back).
    st, rounds, split = state0, 0, False
    while rounds < 20:
        go = st.active.any(-1) & ~S.certified_per_k(st, gap)
        if not bool(go.any()):
            break
        split |= not bool(go.all())
        st, _ = S.bnb_round(data, st, gap, ipm_iters=12,
                            beam=int(st.per_k_best.shape[1]) if rounds == 0 else 6,
                            ipm_chunk=12 if rounds == 0 else None,
                            frozen=None if bool(go.all()) else ~go, per_k=True)
        rounds += 1
    assert ran == rounds and split, (ran, rounds, split)
    for f in S.SearchState._fields:
        assert torch.equal(getattr(end, f), getattr(st, f)), f


# ----------------------------------------------------------- the CUDA wrapper


class _Lib:
    """Stands in for the built round tail library: records each launch and
    each shared-memory query."""

    def __init__(self, smem=1024):
        self.smem, self.launches, self.queries = smem, [], []

    def dtk_round_tail_smem_bytes(self, B, cap, M, pre, n_k, per_k):
        self.queries.append((B, cap, M, pre, n_k, per_k))
        return self.smem

    def dtk_round_tail_ws_bytes(self, L, B, cap, M):
        return 4096

    def dtk_round_tail(self, ptrs, dims, mip_gap, stream):
        self.launches.append((list((ctypes.c_longlong * 65).from_address(ptrs)),
                              list((ctypes.c_int * 13).from_address(dims)), mip_gap))
        return 0


class _Forbidden:
    """A kernel library no per-k round may touch."""

    def __init__(self, name):
        self.name = name

    def __getattr__(self, fn):
        raise AssertionError(f"a per-k round reached {self.name}.{fn}")


def _kernel_route(monkeypatch, lib):
    """Every wrapper takes its kernel route; the round tail's library is the
    stand-in, K2's, K2 MoE's and K3's (with B15) refuse to be touched."""
    monkeypatch.setattr(kernels, "on_cuda", lambda *t: True)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: ctypes.c_void_p(0))
    monkeypatch.setitem(build._LIBS, "round_tail", lib)
    for name in ("round", "round_moe", "bnb_epilogue"):
        monkeypatch.setitem(build._LIBS, name, _Forbidden(name))
    S._TAIL_PLANS.clear()


@pytest.mark.parametrize("L", [1, 2])
def test_a_per_k_round_is_one_tail_launch(profiles_dir, monkeypatch, L):
    data, _, jstates = _lanes(profiles_dir, (123, 5)[:L], 40)
    state = S.SearchState(*[torch.stack(t) for t in zip(*[from_jax_arrays(js)
                                                          for js in jstates])])
    B = 6
    one = data._replace(A=data.A[0], b_k=data.b_k[0], c_k=data.c_k[0])
    res = _fixed_lp(one, unlane_state(state), B, 2, 2)
    res = IPMResult(**{f: torch.cat([getattr(res, f)] * L) for f in RES_FIELDS})
    monkeypatch.setattr(S, "ipm_solve_batch", lambda *a, **k: res)
    lib = _Lib()
    _kernel_route(monkeypatch, lib)
    kernels.reset_launch_counts()
    out, _ = S.bnb_round(data, state, 1e-3, ipm_iters=2, beam=B, per_k=True)
    name = "round_tail_lanes" if L > 1 else "round_tail"
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {name: 1}
    (ptrs, dims, gap), = lib.launches
    _, cap, nf = state.node_lo.shape
    M, n_k = state.inc_w.shape[1], state.per_k_best.shape[1]
    assert dims[:8] == [L, B, cap, nf, state.node_y.shape[2], M, n_k, 0] and dims[12] == 1
    assert lib.queries == [(B, cap, M, 0, n_k, 1)] and gap == 1e-3
    # The per-k inputs after the state's, their outputs after the go flags,
    # all in the one allocation that holds the new state.
    assert ptrs[36:40] == [state.per_k_w.data_ptr(), state.per_k_n.data_ptr(),
                           state.per_k_y.data_ptr(), state.per_k_dropped.data_ptr()]
    base = out.node_lo.untyped_storage().data_ptr()
    span = (base, base + out.node_lo.untyped_storage().nbytes())
    for f in ("per_k_w", "per_k_n", "per_k_y", "per_k_dropped", "per_k_best"):
        t = getattr(out, f)
        assert t.untyped_storage().data_ptr() == base, f
        assert t.shape == getattr(state, f).shape and t.dtype == torch.float64, f
        assert not span[0] <= getattr(state, f).data_ptr() < span[1], f
    assert ptrs[60:64] == [out.per_k_w.data_ptr(), out.per_k_n.data_ptr(),
                           out.per_k_y.data_ptr(), out.per_k_dropped.data_ptr()]
    # The other mode hands the kernel no per-k outputs and passes them on.
    S._round_tail_kernel(data, state, res, 1e-3, B, None, None)
    ptrs, dims, _ = lib.launches[-1]
    assert dims[12] == 0 and ptrs[60:64] == [0] * 4 and ptrs[64] != 0


def test_a_per_k_shape_past_the_limit_is_refused(profiles_dir, monkeypatch):
    data, _, jstates = _lanes(profiles_dir, (123,), 40)
    state = S.SearchState(*[torch.stack(t) for t in zip(*[from_jax_arrays(js)
                                                          for js in jstates])])
    B = 6
    res = _fixed_lp(data._replace(A=data.A[0], b_k=data.b_k[0], c_k=data.c_k[0]),
                    unlane_state(state), B, 2, 2)
    monkeypatch.setattr(S, "ipm_solve_batch", lambda *a, **k: res)
    lib = _Lib(smem=S.TAIL_SMEM_LIMIT + 1)
    _kernel_route(monkeypatch, lib)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match=str(S.TAIL_SMEM_LIMIT)):
        S.bnb_round(data, state, 1e-3, ipm_iters=2, beam=B, per_k=True)
    assert not lib.launches and not any(kernels.LAUNCHES.values())
    assert lib.queries[-1][-1] == 1


# -------------------------------------- the kernel's fair places and per-k argmin


def _kernel_fair_places(bound, active, kidx, n_k):
    """round_tail_kernel.cu's fair_places over its first order: each child's
    place in the k-fair order."""
    total = len(bound)
    first = _kernel_order([b if a else math.inf for b, a in zip(bound, active)])
    r1 = [0] * total
    for place, c in enumerate(first):
        r1[c] = place
    group = [k if a else n_k for k, a in zip(kidx, active)]
    run, g = [0] * (n_k + 1), [0] * total
    for c in first:  # pk_ranks: a count per group in first-order position
        g[c] = run[group[c]]
        run[group[c]] += 1
    off = [sum(run[:k]) for k in range(n_k + 1)]
    tab = [0] * total
    for c in range(total):
        if group[c] < n_k:
            tab[off[group[c]] + g[c]] = r1[c]
    places = []
    for c in range(total):
        if group[c] == n_k:
            places.append(off[n_k] + g[c])
            continue
        places.append(sum(min(run[q], g[c]) + (run[q] > g[c] and tab[off[q] + g[c]] < r1[c])
                          for q in range(n_k)))
    return places


def _frontiers():
    for i, vals in enumerate(ADVERSARIAL):
        rng = np.random.default_rng(i)
        n = len(vals)
        yield vals, (rng.random(n) < 0.7).tolist(), rng.integers(0, 3, n).tolist(), 3, \
            max(1, n // 2)
    for s in range(6):
        rng = np.random.default_rng(100 + s)
        n, n_k = int(rng.integers(8, 60)), int(rng.integers(1, 7))
        vals = rng.choice([-1.0, -0.0, 0.0, 2.0, 2.5, np.inf, -np.inf, np.nan], n).tolist()
        yield vals, (rng.random(n) < rng.random()).tolist(), \
            rng.integers(0, n_k, n).tolist(), n_k, int(rng.integers(1, n))


@pytest.mark.parametrize("vals,active,kidx,n_k,cap", list(_frontiers()))
def test_kernel_fair_places_and_per_k_argmin_emulation_match_torch(vals, active, kidx, n_k,
                                                                    cap):
    bound = torch.tensor(vals, dtype=torch.float64)
    act = torch.tensor(active)
    kx = torch.tensor(kidx, dtype=torch.int32)
    order = torch.argsort(torch.where(act, bound, math.inf), stable=True)
    dropped = torch.full((n_k,), math.inf, dtype=torch.float64)
    key, floor = (x[0] for x in S.per_k_fair_rank_reference(
        order[None], kx[None], act[None], bound[None], cap, dropped[None]))
    fair = order[torch.argsort(key, stable=True)].tolist()
    places = _kernel_fair_places(vals, active, kidx, n_k)
    assert sorted(places) == list(range(len(vals)))
    assert [c for _, c in sorted(zip(places, range(len(vals))))] == fair
    # The per-k floor of the spilled live bounds, folded as the kernel folds.
    spilled = [c for c in range(len(vals)) if places[c] >= cap]
    got = _kernel_scatter_min([vals[c] if active[c] else math.inf for c in spilled],
                              [kidx[c] for c in spilled], n_k)
    np.testing.assert_array_equal(np.array(got), floor.numpy())
    # Each k's best row: the kernel's argmin over where(kidx == k, obj, inf).
    obj = torch.tensor(vals, dtype=torch.float64)
    mask = kx[:, None] == torch.arange(n_k)
    ref = torch.where(mask, obj[:, None], math.inf).argmin(0).tolist()
    for k in range(n_k):
        assert _kernel_argmin([v if kk == k else math.inf for v, kk in zip(vals, kidx)]) == \
            ref[k], k
