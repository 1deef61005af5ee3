"""The MoE sweep's loop as one plan (``distilp_torch/solver/device_loop.py``)
on the CPU, through the plain versions the card's graph runs, on Mixtral
8x7B over 4 devices (the fleet of ``test_torch_moe_solver.py``):

- the plan's loop (the MoE seed: K7's problem taken from the upload, the
  ascent and the float64 evaluation, the Lagrangian-primal hints repaired by
  K2's hint mode, the warm hint by its warm mode; the head's per-node A;
  K1; K2's LP rows; the pre-rounded round tail) equals
  ``search.run_bnb_loop`` after ``backend_torch.seeded_state`` bit for bit
  in every state field and in the answer: cold, warm with stored duals and
  a warm hint, a margin tick, per-k, two scenario lanes with one settled at
  the seed, two lanes with an A each;
- its placement equals the JAX package's ``halda_solve`` (k, w, n, y) and its
  objective lies within ``mip_gap``;
- the MoE seed's root bounds against ``backend_jax._seed_root_bounds``: a
  30-step ascent within ``test_torch_decomp.py``'s 1e-4, and the evaluation
  at stored duals (0 steps) within 1e-12 with the duals equal;
- the head's per-node values and dense A equal ``search.node_A`` (gathered
  on the structure for the values) bit for bit;
- ``loop_route`` sends MoE and dense sweeps on the IPM and the PDHG engine
  to the graph, with the convergence log too (its route marked ``+log``),
  and a row mesh over distinct cards to the host loop.

One process: ~45 s on an 8-core CPU (most of it the JAX package's solve
and its short ascent).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distilp_torch.profiler import profile_model  # noqa: E402
from distilp_torch.solver import device_loop as DL  # noqa: E402
from distilp_torch.solver import halda_solve  # noqa: E402
from distilp_torch.solver import packed as PK  # noqa: E402
from distilp_torch.solver import search as S  # noqa: E402
from distilp_torch.solver.api import _build_instance  # noqa: E402
from distilp_torch.solver.backend_torch import (  # noqa: E402
    _prepare,
    _search_params,
    lane_input,
    seeded_state,
    solve_sweep_torch,
)
from distilp_torch.solver.standard_form import DECOMP_STEPS_WARM  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402

CPU = torch.device("cpu")
GAP = 1e-3
MIXTRAL = "tests/configs/mixtral_8x7b.json"
M, SEED, POOL = 4, 7, 64e9


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Few intra-op threads: the plain IPM's small batched products each
    open a parallel region, which with several test processes costs more
    than the product."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return profile_model(MIXTRAL, batch_sizes=[1], sequence_length=128).to_model_profile()


def _fleet(seed=SEED, scale=None):
    devs = make_synthetic_fleet(M, seed=seed, pool_bytes=int(POOL))
    if scale is not None:
        for d, f in zip(devs, scale):
            d.t_comm = d.t_comm * f
    return devs


def _sweep(devs, model):
    Ks, _, coeffs, arrays = _build_instance(devs, model, None, "8bit", None, None)
    kWs = [(k, model.L // k) for k in Ks]
    return arrays, kWs, coeffs, [(k, W) for k, W in kWs if W >= len(devs)]


def _lane(devs, model, warm=None, per_k=False, margin_state=None):
    arrays, kWs, coeffs, feas = _sweep(devs, model)
    return lane_input(arrays, coeffs, kWs, feas, warm=warm, margin_state=margin_state,
                      per_k=per_k)


def _same(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        it = torch.int64 if a.element_size() == 8 else torch.int32
        return torch.equal(a.contiguous().view(it), b.contiguous().view(it))
    return torch.equal(a, b)


def _both(lanes, per_k=False, edit=None, shared_A=True):
    """(host loop's (state, answer), plan's (state, answer), plan) of the
    same prepared sweep; ``edit`` changes both seeded states alike."""
    params = _search_params(lanes[0].sf, None, None, None, None, None, "ipm", None, None, None,
                            per_k)
    hp = _prepare(lanes, params, GAP, CPU, per_k=per_k, shared_A=shared_A, _host_loop=True)
    assert hp.plan is None
    st, duals, raw, m_y, _ = seeded_state(hp)
    if edit is not None:
        st = edit(st)
    h_state, h_root, _ = S.run_bnb_loop(hp.data, st, GAP, **hp.loop_kw)
    n_k = hp.data.ks.shape[1]
    want_my = m_y is not None and any(ln.margin_ctx is not None for ln in lanes)
    h_ans = DL.answer_rows(h_state, h_root, n_k, per_k, duals, raw,
                           [m_y] if want_my else ()).numpy()
    gp = _prepare(lanes, params, GAP, CPU, per_k=per_k, shared_A=shared_A)
    plan = gp.plan
    assert plan is not None and plan.sig.moe
    seeded = None
    if edit is not None:
        seeded = edit(seeded_state(gp)[0])
    g_ans = plan.run_plain(gp.entry, gp.warm, gp.root_warm, seeded=seeded)
    g_state = S.SearchState(*[t.clone() for t in plan.states[1]])
    hp.release()
    gp.release()
    return (h_state, h_ans), (g_state, g_ans), plan


def _assert_equal(host, graph):
    (h_state, h_ans), (g_state, g_ans) = host, graph
    bad = [f for f, a, b in zip(S.SearchState._fields, h_state, g_state) if not _same(a, b)]
    assert not bad, f"state fields differ: {bad}"
    assert h_ans.shape == g_ans.shape
    assert h_ans.tobytes() == g_ans.tobytes()


@pytest.fixture(scope="module")
def cold(model):
    """A cold solve of the fleet (its duals, hint and root iterates seed
    the warm cases) and the margin state it anchored."""
    arrays, kWs, coeffs, _ = _sweep(_fleet(), model)
    ms: dict = {}
    _, best = solve_sweep_torch(arrays, kWs, mip_gap=GAP, coeffs=coeffs, device="cpu",
                                margin_state=ms)
    assert best is not None and best.duals is not None and "m_y" in ms
    return best, ms


def test_cold_plan_equals_host_loop(model):
    host, graph, plan = _both([_lane(_fleet(), model)])
    _assert_equal(host, graph)
    assert plan.sig.decomp_steps > 0 and not plan.sig.has_duals
    lay = plan.alay
    assert lay.has_duals and lay.width == graph[1].shape[1]


def test_warm_with_duals_and_hint_plan_equals_host_loop(model, cold):
    best, _ = cold
    lane = _lane(_fleet(scale=[1.03, 0.97, 1.0, 1.02]), model, warm=best)
    assert lane.warm_tuple is not None and lane.duals_tuple is not None
    host, graph, plan = _both([lane])
    _assert_equal(host, graph)
    assert plan.sig.decomp_steps == DECOMP_STEPS_WARM and plan.sig.has_duals
    assert plan.sig.has_warm and not plan.sig.has_margin


def test_margin_tick_plan_equals_host_loop(model, cold):
    best, ms = cold
    lane = _lane(_fleet(), model, warm=best, margin_state=dict(ms))
    assert lane.margin_np is not None
    host, graph, plan = _both([lane])
    _assert_equal(host, graph)
    assert plan.sig.has_margin and not plan.sig.want_my
    # The answer's raw root bounds are the uploaded margin bounds.
    n_k = plan.sig.n_k
    o = 5 + 3 * M + n_k + 2 * n_k + n_k * M
    assert np.array_equal(graph[1][0, o:o + n_k], lane.margin_np)


def test_anchor_refresh_carries_m_y(model):
    """A cold tick of a margin chain asks for the y-profile: the plan's
    answer carries it after the root iterates, as the host loop's does."""
    lane = _lane(_fleet(), model, margin_state={})
    host, graph, plan = _both([lane])
    _assert_equal(host, graph)
    assert plan.sig.want_my and plan.alay.my_size == plan.sig.n_k * M * (plan.sig.e_max + 1)


def test_per_k_plan_equals_host_loop(model):
    host, graph, plan = _both([_lane(_fleet(), model, per_k=True)], per_k=True)
    _assert_equal(host, graph)
    assert plan.sig.per_k


def test_two_lanes_one_settled_at_the_seed(model):
    """Two scenario lanes of the fleet (one A), lane 1's frontier emptied
    in its seeded state: it runs no round while lane 0 searches."""
    lanes = [_lane(_fleet(), model), _lane(_fleet(scale=[1.5, 0.8, 1.2, 0.9]), model)]

    def settle_lane_1(st):
        active = st.active.clone()
        active[1] = False
        return st._replace(active=active)

    host, graph, plan = _both(lanes, edit=settle_lane_1)
    _assert_equal(host, graph)
    assert graph[1][1, 4] == 0.0
    assert plan.sig.L == 2 and not plan.sig.a_lanes


def test_two_lanes_with_an_a_each(model):
    lanes = [_lane(_fleet(seed=7), model), _lane(_fleet(seed=8), model)]
    host, graph, plan = _both(lanes, shared_A=False)
    _assert_equal(host, graph)
    assert plan.sig.a_lanes and plan.sig.moe


def test_head_values_equal_node_A(model):
    """After a plain run, the head's MoE mode on the final state's rows: each
    row's dense A equals ``node_A`` and its values ``node_A`` gathered on the
    structure, bit for bit."""
    lanes = [_lane(_fleet(seed=7), model), _lane(_fleet(seed=8), model)]
    params = _search_params(lanes[0].sf, None, None, None, None, None, "ipm", None, None, None,
                            False)
    gp = _prepare(lanes, params, GAP, CPU)
    plan = gp.plan
    plan.run_plain(gp.entry)
    data = plan.data(gp.entry)
    sp = gp.entry.sparsity
    for which, st in ((0, plan.states[0]), (1, plan.states[1])):
        B = (plan.sig.B0, plan.sig.Bw)[which]
        R = plan.sig.L * B
        plan.head_moe_reference(data, st, which)
        kidx = st.node_kidx[:, :B].reshape(R).long()
        lane = torch.arange(plan.sig.L).repeat_interleave(B)
        ref = S.node_A(data, kidx, M, lane)
        assert _same(plan.A_rows[which], ref)
        assert _same(plan.val_rows[which], ref.reshape(R, -1)[:, sp.src])
        assert _same(plan.Wr[:R], data.Ws[lane, kidx]) and _same(plan.kr[:R], data.ks[lane, kidx])
    gp.release()


def test_loop_route():
    from distilp_torch.parallel import Mesh

    one_card = Mesh((CPU, CPU), True)
    cards = Mesh((torch.device("cuda", 0), torch.device("cuda", 1)), False)
    assert DL.loop_route(True, "ipm", None, False) == ("graph", "moe_ipm")
    assert DL.loop_route(False, "ipm", None, False) == ("graph", "dense_ipm")
    assert DL.loop_route(True, "pdhg", None, False) == ("graph", "moe_pdhg")
    assert DL.loop_route(False, "pdhg", None, False) == ("graph", "dense_pdhg")
    # A row mesh of the search's device takes the graph (R3c); one over
    # distinct cards keeps the host loop under its own key.
    assert DL.loop_route(True, "pdhg", one_card, False, None, CPU) == \
        ("graph", "moe_row_mesh_pdhg")
    assert DL.loop_route(False, "pdhg", one_card, False, None, CPU) == \
        ("graph", "row_mesh_pdhg")
    assert DL.loop_route(True, "pdhg", cards, False, None, "cuda:0") == \
        ("host", "row_mesh_cards")
    assert DL.loop_route(True, "pdhg", None, True) == ("graph", "moe_pdhg+log")
    assert DL.loop_route(False, "pdhg", None, True) == ("graph", "dense_pdhg+log")
    # The IPM engine takes no row mesh (it partitions the PDHG's rows).
    assert DL.loop_route(True, "ipm", one_card, False, None, CPU) == ("graph", "moe_ipm")
    assert DL.loop_route(True, "ipm", None, True) == ("graph", "moe_ipm+log")


def test_node_mesh_and_forced_host_loop_keep_the_host(model):
    """A node mesh over distinct devices (a stand-in: one on a device of
    another type) and a forced host loop keep the host loop; a node mesh of
    the search's device takes the graph since R3c."""
    from distilp_torch.parallel import Mesh

    lanes = [_lane(_fleet(), model)]
    params = _search_params(lanes[0].sf, None, None, None, None, None, "ipm", None, None, None,
                            False)
    two = Mesh((CPU, torch.device("meta")), False)
    for kw in (dict(node_mesh=two), dict(_host_loop=True)):
        prep = _prepare(lanes, params, GAP, CPU, **kw)
        assert prep.plan is None
        prep.release()
    with DL.host_loop():
        prep = _prepare(lanes, params, GAP, CPU)
        assert prep.plan is None
        prep.release()


# ------------------------------------------------------- against the JAX package


def test_placement_matches_jax(model):
    pytest.importorskip("jax")
    from distilp_tpu.profiler.api import profile_model as jax_profile_model
    from distilp_tpu.solver import halda_solve as jax_halda_solve
    from distilp_tpu.utils import make_synthetic_fleet as jax_fleet

    jmodel = jax_profile_model(MIXTRAL, batch_sizes=[1], sequence_length=128).to_model_profile()
    ref = jax_halda_solve(jax_fleet(M, seed=SEED, pool_bytes=int(POOL)), jmodel, mip_gap=GAP,
                          kv_bits="8bit", backend="jax")
    from distilp_torch import kernels

    routes = kernels.SHAPES["bnb_graph"]
    before = sum(c for k, c in routes.items() if k.startswith("route=graph moe_ipm"))
    got = halda_solve(_fleet(), model, mip_gap=GAP, kv_bits="8bit", device="cpu")
    # The port's solve took the plan (the graph route's plain run).
    assert sum(c for k, c in routes.items() if k.startswith("route=graph moe_ipm")) > before
    assert (got.k, got.w, got.n, got.y) == (ref.k, ref.w, ref.n, ref.y)
    assert abs(got.obj_value - ref.obj_value) <= GAP * abs(ref.obj_value)


def _jax_seed(plan, lane, steps, init=None):
    """``backend_jax._seed_root_bounds`` on the plan's sweep: (raw bounds,
    duals, m_y) as numpy."""
    import jax.numpy as jnp

    from distilp_tpu.solver import backend_jax as BJ

    sig, v = plan.sig, plan.views
    jrd = BJ.RoundingData(**{k: jnp.asarray(x, jnp.float64) for k, x in lane.rd_np.items()})
    st = BJ._root_state(jnp.asarray(v["lo_k"][0].numpy()), jnp.asarray(v["hi_k"][0].numpy()),
                        sig.M, sig.cap, sig.m)
    _, duals, raw, m_y = BJ._seed_root_bounds(
        st, jrd, jnp.asarray(v["ks"][0].numpy()), jnp.asarray(v["Ws"][0].numpy()),
        float(v["obj_const"][0]), sig.nf, sig.M, True, sig.w_max, sig.e_max, steps,
        init_duals=None if init is None else tuple(jnp.asarray(x) for x in init))
    return np.asarray(raw), [np.asarray(d, np.float64) for d in duals], np.asarray(m_y)


def test_moe_seed_matches_jax_seed_root_bounds(model, cold):
    pytest.importorskip("jax")
    best, _ = cold
    lane = _lane(_fleet(), model, warm=best)
    params = _search_params(lane.sf, None, None, None, None, None, "ipm", None, None, None,
                            False)
    gp = _prepare([lane], params, GAP, CPU)
    plan = gp.plan
    data = plan.data(gp.entry)
    v = plan.views
    root = S.root_state(v["lo_k"], v["hi_k"], plan.sig.M, plan.sig.cap, plan.sig.m)
    # A short ascent from zeros: the bounds within the 30-step tolerance.
    short = DL.LoopPlan(plan.sig._replace(decomp_steps=30, has_duals=False))
    short.views["rd"].copy_(v["rd"])
    for f in ("rd_scalars", "ks", "Ws", "obj_const"):
        short.views[f].copy_(v[f])
    _, _, raw, _ = short.seed_moe_reference(root, data)
    jraw, _, _ = _jax_seed(plan, lane, 30)
    assert np.max(np.abs(raw[0].numpy() - jraw) / np.abs(jraw)) <= 1e-4
    # The evaluation at the stored duals (the warm tick's seed): bounds and
    # the y-profile within 1e-12, the multipliers equal.
    assert plan.sig.decomp_steps == 0 and plan.sig.has_duals
    st, duals, raw, m_y = plan.seed_moe_reference(root, data)
    init = [np.asarray(x, np.float64) for x in lane.duals_tuple]
    jraw, jduals, jm_y = _jax_seed(plan, lane, 0, init)
    rel = np.abs(raw[0].numpy() - jraw) / np.maximum(1.0, np.abs(jraw))
    assert np.max(rel) <= 1e-12
    for a, b in zip(duals, jduals):
        assert np.array_equal(a[0].numpy(), b)
    fin = np.isfinite(jm_y)
    assert np.array_equal(np.isfinite(m_y[0].numpy()), fin)
    assert np.max(np.abs(m_y[0].numpy()[fin] - jm_y[fin]) / np.maximum(1.0, np.abs(jm_y[fin]))) \
        <= 1e-12
    n_k = plan.sig.n_k
    assert np.array_equal(st.node_bound[0, :n_k].numpy(), raw[0].numpy() + float(v["obj_const"][0]))
    gp.release()


def test_answer_layout_reads_back(model, cold):
    """The plan's answer decodes through ``_search``'s split as the host
    loop's does: the duals block where ``AnswerLayout`` puts it."""
    best, _ = cold
    lane = _lane(_fleet(), model, warm=best)
    (_, h_ans), (_, g_ans), plan = _both([lane])
    out = PK.split_answer(g_ans, plan.alay)
    n_k = plan.sig.n_k
    o = 5 + 3 * M + n_k
    lam = out["head"][0, o:o + n_k]
    assert np.array_equal(lam, np.asarray(lane.duals_tuple[0], np.float32).astype(np.float64))
