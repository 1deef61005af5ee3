"""A sweep's packed halves and its answer vector (``distilp_torch/solver/
packed.py``) on the CPU.

- The views ``_prepare`` hands the search (the static entry's A and
  structure, the dynamic blob's typed views) equal, field by field and bit
  for bit, the tensors it uploaded one by one before the blob: the four
  goldens, the north star (warm, with its hint and root iterates), S=8
  scenarios on one A, a batch of lanes with an A each and Mixtral M=4 (MoE,
  the expert-busy table).
- The static cache: a second solve of the same A is a hit (its structure
  built once, counted), a new right-hand side is a hit with a new blob, a
  new A is a miss, and the LRU holds at most ``STATIC_CAP`` entries.
- The answer vector decodes to the ``ILPResult``s the separate reads gave.
- The slice as a whole against the JAX package's ``halda_solve`` on the CPU
  (its ``_solve_packed_impl``): same k, w, n, the objective within
  ``mip_gap``, equal branch-and-bound rounds.

One process: ~25 s on an 8-core CPU (the JAX solves compile).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distilp_torch.common import load_from_profile_folder, load_model_profile  # noqa: E402
from distilp_torch.solver import packed as PK  # noqa: E402
from distilp_torch.solver import search as S  # noqa: E402
from distilp_torch.solver.api import _build_instance  # noqa: E402
from distilp_torch.solver.backend_torch import (  # noqa: E402
    _decode_sweep,
    _prepare,
    _search,
    _search_params,
    lane_input,
    seeded_state,
    solve_sweep_torch,
)
from distilp_torch.solver.rounding import RoundingData, pack_rounding_data  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402

CPU = torch.device("cpu")
GOLDEN = ("hermes_70b", "llama_3_70b/4bit", "llama_3_70b/online", "qwen3_32b/bf16")


def _online(profiles_dir):
    return load_model_profile(profiles_dir / "llama_3_70b" / "online" / "model_profile.json")


def _lanes(fleets, model, kv="4bit", warm=None, M_pad=None, ks=None):
    from distilp_torch.solver.batchlayout import pad_instance

    out = []
    for devs in fleets:
        Ks, _, coeffs, arrays = _build_instance(devs, model, ks, kv, None, None, 1)
        kWs = [(k, model.L // k) for k in Ks]
        feasible = [(k, W) for k, W in kWs if W >= len(devs)]
        if M_pad is not None:
            coeffs, arrays = pad_instance(coeffs, arrays, M_pad)
        out.append(lane_input(arrays, coeffs, kWs, feasible, warm=warm))
    return out


def _params(lanes, engine="ipm"):
    return _search_params(lanes[0].sf, None, None, None, None, None, engine, None, None, None,
                          False)


def _old_uploads(lanes, A_lanes=None, shared_A=True):
    """What ``_prepare`` uploaded field by field before the packed blob."""
    L = len(lanes)

    def stack(key):
        return torch.as_tensor(np.stack([ln.host[key] for ln in lanes]))

    if A_lanes is not None:
        A = A_lanes
    elif shared_A or L == 1:
        A = torch.as_tensor(lanes[0].host["A"])
    else:
        A = stack("A")
    rd_np = {f: np.stack([np.broadcast_to(np.asarray(ln.rd_np[f], np.float64),
                                          np.shape(lanes[0].rd_np[f])) for ln in lanes])
             for f in RoundingData._fields}
    rd = RoundingData(**{f: torch.as_tensor(v, dtype=torch.float64) for f, v in rd_np.items()})
    out = dict(A=A, b_k=stack("b_k"), c_k=stack("c_k"), int_mask=stack("int_mask"),
               ks=torch.as_tensor(np.stack([np.asarray(ln.sf.ks, np.float64) for ln in lanes])),
               Ws=torch.as_tensor(np.stack([np.asarray(ln.sf.Ws, np.float64) for ln in lanes])),
               obj_const=torch.as_tensor([float(ln.sf.obj_const) for ln in lanes],
                                         dtype=torch.float64),
               rd=rd, rd_packed=pack_rounding_data(rd), lo_k=stack("lo_k"), hi_k=stack("hi_k"))
    if lanes[0].sf.moe:
        out["gky"] = stack("gky")
    if all(ln.root_warm_tuple is not None for ln in lanes):
        parts = [torch.as_tensor(np.stack([ln.root_warm_tuple[i] for ln in lanes]))
                 for i in range(5)]
        out["root_warm"] = (parts[0] > 0.5, *parts[1:])
    if all(ln.warm_tuple is not None for ln in lanes):
        out["warm"] = (torch.as_tensor([int(ln.warm_tuple[0]) for ln in lanes]),
                       *(torch.as_tensor(np.stack([np.asarray(ln.warm_tuple[i], np.float64)
                                                   for ln in lanes])) for i in (1, 2, 3)))
    return out


def _same(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        it = torch.int64 if a.element_size() == 8 else torch.int32
        return torch.equal(a.contiguous().view(it), b.contiguous().view(it))
    return torch.equal(a, b)


def _assert_views_equal(prep, old):
    d = prep.data
    for f in ("A", "b_k", "c_k", "int_mask", "ks", "Ws", "obj_const", "rd_packed"):
        assert _same(getattr(d, f), old[f]), f
    for f in RoundingData._fields:
        assert _same(getattr(d.rd, f), getattr(old["rd"], f)), f
    assert _same(prep.views["lo_k"], old["lo_k"]) and _same(prep.views["hi_k"], old["hi_k"])
    if "gky" in old:
        assert _same(d.gky, old["gky"])
    for key, got in (("root_warm", prep.root_warm), ("warm", prep.warm)):
        if key in old:
            assert all(_same(a, b) for a, b in zip(got, old[key])), key
        else:
            assert got is None, key
    sp = S.node_sparsity(old["A"], prep.lanes[0].sf.M, prep.lanes[0].sf.moe)
    assert torch.equal(d.A_sparsity.index, sp.index) and torch.equal(d.A_sparsity.src, sp.src)
    root_old = S.root_state(old["lo_k"], old["hi_k"], prep.lanes[0].sf.M, prep.cap,
                            old["b_k"].shape[-1], old.get("root_warm"))
    assert all(_same(a, b) for a, b in zip(prep.state, root_old))


@pytest.mark.parametrize("folder", GOLDEN)
def test_goldens_views_equal_the_old_uploads(profiles_dir, folder):
    devs, model = load_from_profile_folder(profiles_dir / folder)
    lanes = _lanes([devs], model)
    prep = _prepare(lanes, _params(lanes), 1e-4, CPU, shared_A=True)
    _assert_views_equal(prep, _old_uploads(lanes))
    prep.release()


def test_north_star_warm_and_scenarios_views(profiles_dir):
    model = _online(profiles_dir)
    devs = make_synthetic_fleet(16, seed=123)
    Ks, _, coeffs, arrays = _build_instance(devs, model, None, "4bit", None, None, 1)
    _, best = solve_sweep_torch(arrays, [(k, model.L // k) for k in Ks], mip_gap=1e-3,
                                coeffs=coeffs, device="cpu")
    lanes = _lanes([devs], model, warm=best)
    prep = _prepare(lanes, _params(lanes), 1e-3, CPU, shared_A=True)
    assert prep.warm is not None and prep.root_warm is not None
    _assert_views_equal(prep, _old_uploads(lanes))
    prep.release()
    rng = np.random.default_rng(17)
    fleets = []
    for _ in range(8):
        snap = [d.model_copy(deep=True) for d in devs]
        for d in snap:
            d.t_comm = max(0.0, d.t_comm * float(rng.uniform(0.5, 2.0)))
        fleets.append(snap)
    lanes = _lanes(fleets, model, warm=best)
    prep = _prepare(lanes, _params(lanes), 1e-3, CPU, shared_A=True)
    _assert_views_equal(prep, _old_uploads(lanes))
    prep.release()


def test_lanes_with_an_A_each_views(profiles_dir):
    model = _online(profiles_dir)
    fleets = [make_synthetic_fleet(M, seed=s) for M, s in ((4, 4), (6, 7), (8, 8))]
    lanes = _lanes(fleets, model, M_pad=8, ks=[8, 10])
    A_lanes = torch.stack([torch.as_tensor(ln.host["A"]) for ln in lanes])
    prep = _prepare(lanes, _params(lanes), 1e-3, CPU, A_lanes=A_lanes)
    assert prep.entry.A.dim() == 3 and prep.plan is not None and prep.plan.sig.a_lanes
    _assert_views_equal(prep, _old_uploads(lanes, A_lanes=A_lanes))
    prep.release()


def test_mixtral_views(profiles_dir):
    from distilp_torch.profiler import profile_model

    model = profile_model("tests/configs/mixtral_8x7b.json", batch_sizes=[1],
                          sequence_length=128).to_model_profile()
    lanes = _lanes([make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9))], model, kv="8bit")
    assert lanes[0].sf.moe
    prep = _prepare(lanes, _params(lanes), 1e-3, CPU, shared_A=True)
    assert prep.plan is not None and prep.plan.sig.moe  # MoE sweeps take the graph route
    _assert_views_equal(prep, _old_uploads(lanes))
    prep.release()


def test_static_cache_hits_misses_and_bound(profiles_dir):
    PK.clear_static_cache()
    PK.reset_counts()
    model = _online(profiles_dir)
    lanes = _lanes([make_synthetic_fleet(16, seed=123)], model)
    params = _params(lanes)
    p1 = _prepare(lanes, params, 1e-3, CPU, shared_A=True)
    p2 = _prepare(lanes, params, 1e-3, CPU, shared_A=True)
    assert PK.STATIC_STATS == {"builds": 1, "hits": 1}
    assert p1.entry is p2.entry and p1.data.A_sparsity is p2.data.A_sparsity
    p1.release()
    p2.release()
    # A new right-hand side: the same static half, a new dynamic blob.
    host = dict(lanes[0].host)
    host["b_k"] = host["b_k"] * np.float32(1.01)
    moved = [lanes[0]._replace(host=host)]
    p3 = _prepare(moved, params, 1e-3, CPU, shared_A=True)
    assert PK.STATIC_STATS == {"builds": 1, "hits": 2}
    assert not torch.equal(p3.data.b_k, torch.as_tensor(lanes[0].host["b_k"])[None])
    p3.release()
    # New A's: misses, and the LRU keeps the last STATIC_CAP.
    for seed in range(1, PK.STATIC_CAP + 2):
        ln = _lanes([make_synthetic_fleet(16, seed=seed)], model)
        _prepare(ln, params, 1e-3, CPU, shared_A=True).release()
    assert PK.STATIC_STATS["builds"] == PK.STATIC_CAP + 2
    assert PK.static_cache_size() == PK.STATIC_CAP
    _prepare(lanes, params, 1e-3, CPU, shared_A=True).release()  # evicted: a miss
    assert PK.STATIC_STATS["builds"] == PK.STATIC_CAP + 3


def test_answer_decodes_as_the_separate_reads(profiles_dir):
    """The host loop's answer, split, against what ``_search`` read field
    by field before: the same head and root iterates, the same results."""
    model = _online(profiles_dir)
    fleets = [make_synthetic_fleet(16, seed=s) for s in (123, 5)]
    lanes = _lanes(fleets, model)
    params = _params(lanes)
    prep = _prepare(lanes, params, 1e-3, CPU, shared_A=True, _host_loop=True)
    data = prep.data
    L, n_k = data.ks.shape
    state, *_ = seeded_state(prep)
    state, root_iters, _ = S.run_bnb_loop(data, state, 1e-3, **prep.loop_kw)
    old_head = torch.cat([
        torch.stack([state.incumbent, S.best_bound(state), state.inc_kidx.to(S.BDTYPE),
                     state.stat_ipm_iters, state.stat_rounds], dim=1),
        state.inc_w, state.inc_n, state.inc_y, state.per_k_best], dim=1).numpy()
    old_root = [t[:, :n_k].to(S.BDTYPE).numpy() for t in root_iters]
    from distilp_torch.solver.device_loop import answer_rows

    sf = lanes[0].sf
    lay = PK.AnswerLayout(sf.M, n_k, sf.A.shape[1], sf.A.shape[2], False, False)
    out = PK.split_answer(answer_rows(state, root_iters, n_k, False).numpy(), lay)
    assert out["head"].tobytes() == old_head.tobytes()
    for a, b in zip(out["root"], old_root):
        assert a.tobytes() == np.ascontiguousarray(b.reshape(a.shape)).tobytes()
    old = {"head": old_head, "root": old_root, "stats": {"solve_ms": 0.0},
           "has_duals": False, "m_y": None, "conv": None}
    new = dict(out, stats={"solve_ms": 0.0}, has_duals=False)
    for q in range(L):
        a, b = _decode_sweep(prep, old, q), _decode_sweep(prep, new, q)
        assert a[1].model_dump(exclude={"ipm_state"}) == b[1].model_dump(exclude={"ipm_state"})
        for f in ("ok", "v", "y", "z", "f"):
            assert np.array_equal(a[1].ipm_state[f], b[1].ipm_state[f])
    prep.release()
    # And the search's own read: one answer through the graph route's plan.
    prep = _prepare(lanes, params, 1e-3, CPU, shared_A=True)
    got = _search(prep)
    assert got["head"].tobytes() == old_head.tobytes()


# (fixture, mip_gap, extra rounds the port takes). The online golden at gap
# 1e-4 takes one more round than the reference: the port's float32 IPM
# (its plain version here, K1 on the card) reaches the root duals in
# another operation order, and its float64 bound closes the 1e-4 gap one
# round later (87 LP steps in the reference, 99 here); the host loop takes
# the same 3 rounds, so the loop's redesign does not move it.
JAX_CASES = [("llama_3_70b/online", 1e-4, 1), ("llama_3_70b/online", 1e-3, 0),
             ("hermes_70b", 1e-4, 0), ("north_star", 1e-3, 0)]


@pytest.mark.parametrize("case,gap,extra", JAX_CASES)
def test_the_slice_against_the_jax_package(profiles_dir, case, gap, extra):
    from distilp_torch.solver import halda_solve
    from distilp_tpu.common import load_from_profile_folder as jload
    from distilp_tpu.common import load_model_profile as jmodel
    from distilp_tpu.solver import halda_solve as jax_solve
    from distilp_tpu.utils import make_synthetic_fleet as jfleet

    if case == "north_star":
        model = _online(profiles_dir)
        devs = make_synthetic_fleet(16, seed=123)
        jm = jmodel(profiles_dir / "llama_3_70b" / "online" / "model_profile.json")
        jdevs = jfleet(16, seed=123)
    else:
        devs, model = load_from_profile_folder(profiles_dir / case)
        jdevs, jm = jload(profiles_dir / case)
    tm, jtm = {}, {}
    got = halda_solve(devs, model, mip_gap=gap, kv_bits="4bit", device="cpu", timings=tm)
    ref = jax_solve(jdevs, jm, mip_gap=gap, kv_bits="4bit", backend="jax", timings=jtm)
    assert (got.k, got.w, got.n) == (ref.k, ref.w, ref.n)
    assert got.obj_value == pytest.approx(ref.obj_value, rel=gap)
    assert tm["bnb_rounds"] == jtm["bnb_rounds"] + extra
