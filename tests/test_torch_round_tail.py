"""The round tail (R8: everything of a non-per-k branch-and-bound round
after its LP call, one launch of ``round_tail_kernel.cu`` on a card) on the
CPU, through its plain version ``search.round_tail_reference``.

- ``bnb_round`` (which on CPU tensors takes the plain version) against the
  JAX package's ``_bnb_round`` with the LP result fixed, field by field:
  integers, booleans, float32 boxes and iterates and the order exactly,
  float64 fields within rtol 1e-12 (``tests/test_torch_search.py``'s
  tolerance: the rounding sums the devices' costs in another order). On the
  north star's root round and a warm round, three lanes with one frozen,
  Mixtral M=4's MoE round (pre-rounded: K2's MoE mode first) and a forced
  ``node_cap`` small enough that the compaction spills.
- A torch emulation of the kernel's order and argmin (canonical keys,
  (key, index) rank by counting, first-index argmin with NaN first,
  NaN-propagating scatter-min) against ``torch.argsort(stable=True)``,
  ``argmin`` and ``scatter_reduce("amin")`` on adversarial keys.
- The go flags the plain version writes equal the loop's own test on the
  same state, and a search that reads them ends where one that tests every
  state ends.
- The CUDA wrapper (a stand-in library records what it passes): one
  launch and one count a round, the new state in one allocation apart from
  every input, a refused shape naming the limit, a failed launch raising.
"""

import ctypes
import math
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from distilp_torch import kernels  # noqa: E402
from distilp_torch.common import load_model_profile  # noqa: E402
from distilp_torch.interop import from_jax_arrays  # noqa: E402
from distilp_torch.kernels import build  # noqa: E402
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
from distilp_torch.solver.backend_torch import device_arrays  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402
from distilp_tpu.ops.ipm import IPMResult as JResult  # noqa: E402
from distilp_tpu.solver import backend_jax as BJ  # noqa: E402
from torch_lanes import lane_data, unlane_state  # noqa: E402

RES_FIELDS = [f for f in IPMResult._fields if f != "trace_buf"]


def _sweep(profiles_dir, case, seed=123, M=16, cap=None):
    """One sweep's port data (no lane axis), the reference's data and root
    state, and n_k: the north-star family (Llama-3-70B online, kv 4bit) or
    Mixtral 8x7B over 4 devices (kv 8bit, MoE)."""
    if case == "mixtral":
        model = profile_model(str(profiles_dir.parent / "configs" / "mixtral_8x7b.json"),
                              batch_sizes=[1], sequence_length=128).to_model_profile()
        devs, kv = make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9)), "8bit"
    else:
        model = load_model_profile(profiles_dir / "llama_3_70b" / "online" /
                                   "model_profile.json")
        devs, kv = make_synthetic_fleet(M, seed=seed), "4bit"
    M = len(devs)
    Ks, _, coeffs, arrays = _build_instance(devs, model, None, kv, None, None)
    kWs = [(k, model.L // k) for k in Ks if model.L // k >= M]
    sf = SF.build_standard_form(arrays, coeffs, kWs)
    rd_np = SF.rounding_arrays_np(coeffs, arrays.moe if sf.moe else None)
    host = device_arrays(sf, rd_np["g_raw"] if sf.moe else None)
    rd = R.rounding_data(rd_np, "cpu")
    t = {k: torch.as_tensor(v) for k, v in host.items()}
    gky = t["gky"] if sf.moe else None
    pdata = S.SweepData(
        A=t["A"], b_k=t["b_k"], c_k=t["c_k"], int_mask=t["int_mask"],
        ks=torch.tensor(sf.ks, dtype=torch.float64), Ws=torch.tensor(sf.Ws, dtype=torch.float64),
        obj_const=float(sf.obj_const), rd=rd, rd_packed=R.pack_rounding_data(rd), gky=gky,
    )
    jdata = BJ.SweepData(
        A=jnp.asarray(host["A"]), b_k=jnp.asarray(host["b_k"]), c_k=jnp.asarray(host["c_k"]),
        int_mask=jnp.asarray(host["int_mask"]), ks=jnp.asarray(sf.ks, jnp.float64),
        Ws=jnp.asarray(sf.Ws, jnp.float64), obj_const=jnp.asarray(sf.obj_const, jnp.float64),
        rd=BJ.RoundingData(**{k: jnp.asarray(v, jnp.float64) for k, v in rd_np.items()}),
        gky=None if gky is None else jnp.asarray(host["gky"]),
    )
    n_k = len(kWs)
    if cap is None:
        cap = 256 if sf.moe else max(64, 2 * n_k)
    jstate = BJ._root_state(jnp.asarray(host["lo_k"]), jnp.asarray(host["hi_k"]), M, cap,
                            host["A"].shape[0])
    return pdata, jdata, jstate, n_k


def _fixed_lp(data, state, B, iters, chunk):
    """A real LP result for the first B rows of a single sweep's state (the
    plain IPM; per-node A for MoE rows)."""
    kidx = state.node_kidx[:B].long()
    M = state.inc_w.shape[-1]
    lane = torch.zeros_like(kidx)
    A = S.node_A(lane_data(data), kidx, M, lane) if data.gky is not None else data.A
    return ipm_solve_batch_reference(
        LPBatch(A, data.b_k[kidx], data.c_k[kidx], state.node_lo[:B], state.node_hi[:B]),
        iters=iters, chunk=chunk, skip=~state.active[:B],
        warm=IPMWarmState(state.node_v[:B], state.node_y[:B], state.node_z[:B],
                          state.node_f[:B], state.node_warm[:B]),
    )


def _assert_matches(got, ref):
    for f in S.SearchState._fields:
        g, r = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        assert g.shape == r.shape, f
        if r.dtype == np.float64:
            np.testing.assert_allclose(g, r, rtol=1e-12, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(g, r, err_msg=f)


def _spy_reference(monkeypatch):
    """Count the plain tail's calls (``bnb_round`` must route through it)."""
    calls = []
    orig = S.round_tail_reference

    def spy(*a, **kw):
        calls.append(a[6] if len(a) > 6 else kw.get("frozen"))
        return orig(*a, **kw)

    monkeypatch.setattr(S, "round_tail_reference", spy)
    return calls


@pytest.mark.parametrize("case,kw,gap,rounds", [
    ("north_star", {}, 1e-3, [(None, 8, 8), (6, 6, 4)]),
    # 8 devices at capacity 6: the third round's children overflow it.
    ("spill", dict(M=8, cap=6), 1e-6, [(None, 8, 8), (6, 6, 4), (6, 6, 4), (6, 6, 4)]),
    ("mixtral", {}, 1e-3, [(None, 8, 8)]),
], ids=["north_star", "spill", "mixtral"])
def test_round_tail_matches_jax_bnb_round(profiles_dir, monkeypatch, case, kw, gap, rounds):
    pdata, jdata, jstate, n_k = _sweep(profiles_dir, case, **kw)
    ldata = lane_data(pdata)
    calls = _spy_reference(monkeypatch)
    moe = pdata.gky is not None
    spilled = False
    for rnd, (B, iters, chunk) in enumerate(rounds):
        B = B or n_k
        pstate = from_jax_arrays(jstate)
        fixed = _fixed_lp(pdata, pstate, B, iters, chunk)
        jres = JResult(**{f: jnp.asarray(getattr(fixed, f).numpy()) for f in RES_FIELDS})
        monkeypatch.setattr(BJ, "ipm_solve_batch", lambda *a, **k: jres)
        monkeypatch.setattr(S, "ipm_solve_batch", lambda *a, **k: fixed)
        jnext = BJ._bnb_round(jdata, jstate, gap, ipm_iters=iters, beam=B, moe=moe,
                              ipm_chunk=chunk)
        pnext, _ = S.bnb_round(ldata, S.SearchState(*[t[None] for t in pstate]), gap,
                               ipm_iters=iters, beam=B, ipm_chunk=chunk)
        _assert_matches(unlane_state(pnext), jnext)
        spilled |= bool(np.isfinite(np.asarray(jnext.dropped_bound)))
        jstate = jnext
        if not bool(jnp.any(jstate.active)):
            break
    assert len(calls) == rnd + 1
    if case == "spill":
        assert spilled, "the forced capacity never spilled a node"


def _lanes(profiles_dir, seeds, cap):
    """Dense lanes of 8 devices: the port's lane data, each lane's reference
    data and root state."""
    pdatas, jdatas, jstates = [], [], []
    for seed in seeds:
        pdata, jdata, jstate, _ = _sweep(profiles_dir, "north_star", seed=seed, M=8, cap=cap)
        pdatas.append(lane_data(pdata))
        jdatas.append(jdata)
        jstates.append(jstate)
    cat = lambda f: torch.cat([getattr(d, f) for d in pdatas])  # noqa: E731
    data = pdatas[0]._replace(
        A=torch.stack([d.A for d in pdatas]), b_k=cat("b_k"), c_k=cat("c_k"),
        int_mask=cat("int_mask"), ks=cat("ks"), Ws=cat("Ws"), obj_const=cat("obj_const"),
        rd=R.RoundingData(*[torch.cat([getattr(d.rd, f) for d in pdatas])
                            for f in R.RoundingData._fields]),
        rd_packed=cat("rd_packed"),
    )
    return data, jdatas, jstates


def test_three_lanes_with_a_frozen_lane(profiles_dir, monkeypatch):
    """Each lane of one batched round equals the reference's round of that
    lane alone; the frozen lane comes back unchanged."""
    cap, gap = 40, 1e-3
    seeds = (123, 5, 9)
    data, jdatas, jstates = _lanes(profiles_dir, seeds, cap)
    calls = _spy_reference(monkeypatch)
    for rnd, (B, iters, chunk) in enumerate([(None, 8, 8), (6, 6, 4)]):
        lanes = [from_jax_arrays(js) for js in jstates]
        B = B or int(jstates[0].per_k_best.shape[0])
        fixed = []
        for q, st in enumerate(lanes):
            one = data._replace(A=data.A[q], b_k=data.b_k[q], c_k=data.c_k[q], gky=None)
            fixed.append(_fixed_lp(one, st, B, iters, chunk))
        both = IPMResult(**{f: torch.cat([getattr(r, f) for r in fixed]) for f in RES_FIELDS})
        monkeypatch.setattr(S, "ipm_solve_batch", lambda *a, **k: both)
        state = S.SearchState(*[torch.stack(t) for t in zip(*lanes)])
        frozen = torch.tensor([False, rnd == 1, False])
        nxt, _ = S.bnb_round(data, state, gap, ipm_iters=iters, beam=B, ipm_chunk=chunk,
                             frozen=frozen)
        for q, (js, jd) in enumerate(zip(jstates, jdatas)):
            if bool(frozen[q]):
                _assert_matches(unlane_state(nxt, q), js)
                continue
            jres = JResult(**{f: jnp.asarray(getattr(fixed[q], f).numpy()) for f in RES_FIELDS})
            monkeypatch.setattr(BJ, "ipm_solve_batch", lambda *a, **k: jres)
            jstates[q] = BJ._bnb_round(jd, js, gap, ipm_iters=iters, beam=B, ipm_chunk=chunk)
            _assert_matches(unlane_state(nxt, q), jstates[q])
    assert [c.tolist() for c in calls] == [[False] * 3, [False, True, False]]


# -------------------------------------------------- the kernel's order and argmin


def _canonical_key(x: float) -> int:
    """round_tail_kernel.cu's sort_key: -0.0 as 0.0, every NaN one key above
    +inf, otherwise the order-preserving 64-bit image of the double."""
    if math.isnan(x):
        return 2 ** 64 - 1
    if x == 0.0:
        x = 0.0
    b = struct.unpack("<Q", struct.pack("<d", x))[0]
    return (~b & (2 ** 64 - 1)) if b >> 63 else b | (1 << 63)


def _kernel_order(vals):
    """Each key's place by counting the (key, index) pairs before it; the
    order lists the indices by place."""
    keys = [_canonical_key(float(v)) for v in vals]
    order = [0] * len(keys)
    for c, kc in enumerate(keys):
        rank = sum(1 for d, kd in enumerate(keys) if kd < kc or (kd == kc and d < c))
        order[rank] = c
    return order


def _kernel_argmin(vals):
    """argmin_combine's fold: the first NaN, else the first index of the
    minimum."""
    best, bi = math.inf, None
    for i, v in enumerate(vals):
        v = float(v)
        if math.isnan(v):
            if not (bi is not None and math.isnan(best)):
                return i
        elif bi is None or v < best:
            best, bi = v, i
    return 0 if bi is None else bi


def _kernel_scatter_min(vals, idx, n):
    out = [math.inf] * n
    for v, k in zip(vals, idx):
        v = float(v)
        cur = out[k]
        out[k] = cur if (math.isnan(cur) or cur < v) else v
    return out


ADVERSARIAL = [
    [1.0, 1.0, 1.0, 1.0],
    [0.0, -0.0, 0.0, -0.0, -1.0],
    [math.inf, -math.inf, math.inf, 2.0, -math.inf],
    [math.nan, 1.0, -math.nan, math.inf, -0.0, math.nan, 0.0],
    [-math.nan, -math.inf, math.nan, -math.nan],
    [math.inf] * 6,  # an all-inactive lane: where(active, bound, inf)
    [3.5, -2.25, 3.5, math.inf, -2.25, 0.0, -0.0, math.nan, 7.0, -math.inf],
]


@pytest.mark.parametrize("vals", ADVERSARIAL + [
    np.random.default_rng(s).choice([-1.0, -0.0, 0.0, 2.0, np.inf, -np.inf, np.nan, -np.nan],
                                    40).tolist() for s in range(4)])
def test_kernel_order_and_argmin_emulation_matches_torch(vals):
    t = torch.tensor(vals, dtype=torch.float64)
    assert _kernel_order(vals) == torch.argsort(t, stable=True).tolist()
    assert _kernel_argmin(vals) == int(torch.argmin(t))
    idx = [i % 3 for i in range(len(vals))]
    got = _kernel_scatter_min(vals, idx, 3)
    ref = torch.full((3,), math.inf, dtype=torch.float64).scatter_reduce(
        0, torch.tensor(idx), t, "amin")
    np.testing.assert_array_equal(np.array(got), ref.numpy())
    # The spilled bounds' minimum and best_bound's amin: NaN-propagating.
    folded = math.inf
    for v in vals:
        folded = folded if (math.isnan(folded) or folded < v) else v
    np.testing.assert_array_equal(np.array(folded), t.amin().numpy())


# ------------------------------------------------------------------ the go flags


def test_go_flags_equal_the_loop_test(profiles_dir, monkeypatch):
    """The flags the plain tail writes are the loop's go test on the new
    state, and run_bnb_loop, which reads them instead of testing each state,
    ends where a loop that tests every state ends (one lane settles first)."""
    cap, gap = 40, 1e-3
    data, _, jstates = _lanes(profiles_dir, (123, 5), cap)
    state0 = S.SearchState(*[torch.stack(t) for t in zip(*[from_jax_arrays(js)
                                                           for js in jstates])])
    seen = []
    orig = S.round_tail_reference

    def spy(*a, **kw):
        out, go = orig(*a, **kw)
        seen.append(bool(torch.equal(go, out.active.any(-1) & ~S.certified(out, gap))))
        return out, go

    monkeypatch.setattr(S, "round_tail_reference", spy)
    end, _, _ = S.run_bnb_loop(data, state0, gap, ipm_iters=12, max_rounds=20, beam=6)
    ran = len(seen)
    assert ran and all(seen)
    # The same search, testing every state (no flags read back).
    st, rounds = state0, 0
    while rounds < 20:
        go = st.active.any(-1) & ~S.certified(st, gap)
        if not bool(go.any()):
            break
        st, _ = S.bnb_round(data, st, gap, ipm_iters=12,
                            beam=int(st.per_k_best.shape[1]) if rounds == 0 else 6,
                            ipm_chunk=12 if rounds == 0 else None,
                            frozen=None if bool(go.all()) else ~go)
        rounds += 1
    assert ran == rounds
    for f in S.SearchState._fields:
        assert torch.equal(getattr(end, f), getattr(st, f)), f


# ----------------------------------------------------------- the CUDA wrapper


class _Lib:
    """Stands in for the built library: records each launch."""

    def __init__(self, smem=1024, fail=0):
        self.smem, self.fail, self.launches = smem, fail, []

    def dtk_round_tail_smem_bytes(self, B, cap, M, pre, n_k, per_k):
        return self.smem

    def dtk_round_tail_ws_bytes(self, L, B, cap, M):
        return 4096

    def dtk_round_tail(self, ptrs, dims, mip_gap, stream):
        self.launches.append((list((ctypes.c_longlong * 65).from_address(ptrs)),
                              list((ctypes.c_int * 13).from_address(dims)), mip_gap))
        return self.fail


def _wrapper_case(profiles_dir, L=2):
    data, _, jstates = _lanes(profiles_dir, (123, 5)[:L], 40)
    state = S.SearchState(*[torch.stack(t) for t in zip(*[from_jax_arrays(js)
                                                          for js in jstates])])
    B = 6
    one = data._replace(A=data.A[0], b_k=data.b_k[0], c_k=data.c_k[0])
    res = _fixed_lp(one, unlane_state(state), B, 2, 2)
    res = IPMResult(**{f: torch.cat([getattr(res, f)] * L) for f in RES_FIELDS})
    return data, state, res, B


def test_the_wrapper_launches_once_into_fresh_memory(profiles_dir, monkeypatch):
    lib = _Lib()
    monkeypatch.setitem(build._LIBS, "round_tail", lib)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: ctypes.c_void_p(0))
    data, state, res, B = _wrapper_case(profiles_dir)
    kernels.reset_launch_counts()
    out, go = S._round_tail_kernel(data, state, res, 1e-3, B, None, None)
    assert kernels.LAUNCHES["round_tail_lanes"] == 1 and kernels.LAUNCHES["round_tail"] == 0
    (ptrs, dims, gap), = lib.launches
    L, cap, nf = state.node_lo.shape
    M = state.inc_w.shape[1]
    assert dims == [L, B, cap, nf, state.node_y.shape[2], M, state.per_k_best.shape[1], 0, 0, 0,
                    L, R.PACKED_ROWS * M, 0] and gap == 1e-3
    assert go.shape == (L,) and go.dtype == torch.bool
    # The new state's fields share one allocation, which no input touches;
    # the per-k fields a non-per-k round leaves alone pass through.
    fresh = [f for f in S.SearchState._fields if not f.startswith("per_k_")
             or f == "per_k_best"]
    base = go.untyped_storage().data_ptr()
    for f in fresh:
        assert getattr(out, f).untyped_storage().data_ptr() == base, f
    span = (base, base + go.untyped_storage().nbytes())
    inputs = [t for t in (*state, *res[:-1], data.int_mask, data.obj_const, data.Ws, data.ks,
                          data.rd_packed) if isinstance(t, torch.Tensor)]
    for t in inputs:
        p = t.data_ptr()
        assert not span[0] <= p < span[1]
    assert ptrs[:7] == [t.data_ptr() for t in (res.v, res.reduced, res.y_dual, res.z_dual,
                                                  res.f_dual, res.bound, res.iters_run)]
    for f in ("per_k_w", "per_k_n", "per_k_y", "per_k_dropped"):
        assert getattr(out, f) is getattr(state, f)
    # Pre-rounded MoE-style rows: no rounding data passed, y rows flagged.
    rounded = tuple(torch.zeros((L * B, M) if i else (L * B,), dtype=torch.float64)
                    for i in range(4))
    S._round_tail_kernel(data._replace(gky=torch.zeros(1)), state, res, 1e-3, B, rounded,
                         torch.tensor([False, True]))
    ptrs, dims, _ = lib.launches[-1]
    assert dims[7:9] == [1, 1] and ptrs[7:10] == [0, 0, 0] and ptrs[16] != 0


def test_the_wrapper_refuses_and_raises(profiles_dir, monkeypatch):
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: ctypes.c_void_p(0))
    data, state, res, B = _wrapper_case(profiles_dir, L=1)
    monkeypatch.setitem(build._LIBS, "round_tail", _Lib(smem=S.TAIL_SMEM_LIMIT + 1))
    with pytest.raises(ValueError, match=str(S.TAIL_SMEM_LIMIT)):
        S._round_tail_kernel(data, state, res, 1e-3, B, None, None)
    monkeypatch.setitem(build._LIBS, "round_tail", _Lib(fail=700))
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="round_tail kernel launch failed with cudaError 700"):
        S._round_tail_kernel(data, state, res, 1e-3, B, None, None)
    assert kernels.LAUNCHES["round_tail"] == 0
