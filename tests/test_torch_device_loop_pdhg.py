"""The sweep's loop on the PDHG engine as one plan (``distilp_torch/solver/
device_loop.py``) on the CPU, through the plain versions the card's graph
runs (the head, K5's plain version on the plan's values with the cast of a
float64 result, K2 MoE's, the round tail's, the control's and the
answer's):

- the plan's loop equals ``search.run_bnb_loop`` after
  ``backend_torch.seeded_state`` bit for bit in every state field and in
  the answer: a small dense fleet cold and warm (hint and root iterates),
  per-k, two scenario lanes with one settled at the seed, two lanes with an
  A each, ``pdhg_dtype='f64'``, Mixtral 8x7B over 4 devices, and a warm
  state with a NaN in one row's y (that row starts K5 cold on both routes);
- the placement equals the JAX package's ``halda_solve(...,
  lp_backend='pdhg', backend='jax')`` (k, w, n) with the objective within
  ``mip_gap``;
- a PDHG plan holds no dense A and no K1 workspace; K5's route, cluster
  size, shared memory and plan length, the iterate dtype and the restart
  factor are in its signature (and in the compile ledger's static part),
  and a forced route changes the signature;
- the head's PDHG mode (plain version) clears a row's warm flag when a
  component of its warm iterate is not finite, as the K5 wrapper does.

One process: ~35 s on an 8-core CPU (most of it the JAX package's solve).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distilp_torch.ops import pdhg as P  # noqa: E402
from distilp_torch.profiler import profile_model  # noqa: E402
from distilp_torch.solver import device_loop as DL  # noqa: E402
from distilp_torch.solver import halda_solve  # noqa: E402
from distilp_torch.solver import search as S  # noqa: E402
from distilp_torch.solver.api import _build_instance  # noqa: E402
from distilp_torch.solver.backend_torch import (  # noqa: E402
    _prepare,
    _search_params,
    lane_input,
    seeded_state,
    solve_sweep_torch,
)
from distilp_torch.common import load_model_profile  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402

CPU = torch.device("cpu")
GAP = 1e-3
M_DENSE, SEED = 8, 5
MIXTRAL = "tests/configs/mixtral_8x7b.json"


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Few intra-op threads: the plain PDHG's small batched products each
    open a parallel region, which with several test processes costs more
    than the product."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def online(profiles_dir):
    return load_model_profile(profiles_dir / "llama_3_70b" / "online" / "model_profile.json")


def _fleet(seed=SEED, scale=None):
    devs = make_synthetic_fleet(M_DENSE, seed=seed)
    if scale is not None:
        for d, f in zip(devs, scale):
            d.t_comm = d.t_comm * f
    return devs


def _lane(devs, model, kv="4bit", warm=None, per_k=False):
    Ks, _, coeffs, arrays = _build_instance(devs, model, None, kv, None, None)
    kWs = [(k, model.L // k) for k in Ks]
    feas = [(k, W) for k, W in kWs if W >= len(devs)]
    return lane_input(arrays, coeffs, kWs, feas, warm=warm, per_k=per_k)


def _params(lane, per_k=False, pdhg_dtype=None):
    return _search_params(lane.sf, None, None, None, None, None, "pdhg", None, None,
                          pdhg_dtype, per_k)


def _same(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        it = torch.int64 if a.element_size() == 8 else torch.int32
        return torch.equal(a.contiguous().view(it), b.contiguous().view(it))
    return torch.equal(a, b)


def _both(lanes, per_k=False, edit=None, shared_A=True, pdhg_dtype=None):
    """(host loop's (state, answer), plan's (state, answer), plan) of the
    same prepared sweep on the PDHG engine; ``edit`` changes both seeded
    states alike."""
    params = _params(lanes[0], per_k, pdhg_dtype)
    hp = _prepare(lanes, params, GAP, CPU, per_k=per_k, shared_A=shared_A, _host_loop=True)
    assert hp.plan is None and hp.loop_kw["lp_backend"] == "pdhg"
    st, duals, raw, m_y, _ = seeded_state(hp)
    if edit is not None:
        st = edit(st)
    h_state, h_root, _ = S.run_bnb_loop(hp.data, st, GAP, **hp.loop_kw)
    n_k = hp.data.ks.shape[1]
    h_ans = DL.answer_rows(h_state, h_root, n_k, per_k, duals, raw).numpy()
    gp = _prepare(lanes, params, GAP, CPU, per_k=per_k, shared_A=shared_A)
    plan = gp.plan
    assert plan is not None and plan.sig.engine == "pdhg"
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
def cold(online):
    """A cold PDHG solve of the small fleet: its hint and root iterates
    seed the warm cases."""
    Ks, _, coeffs, arrays = _build_instance(_fleet(), online, None, "4bit", None, None)
    _, best = solve_sweep_torch(arrays, [(k, online.L // k) for k in Ks], mip_gap=GAP,
                                coeffs=coeffs, device="cpu", lp_backend="pdhg")
    assert best is not None and best.ipm_state is not None
    return best


def test_dense_cold_plan_equals_host_loop(online):
    host, graph, plan = _both([_lane(_fleet(), online)])
    _assert_equal(host, graph)
    assert graph[1][0, 4] >= 1  # rounds ran
    assert plan.sig.root_chunk == P.PDHG_DEFAULT_CHUNK and not plan.sig.lp_f64


def test_dense_warm_plan_equals_host_loop(online, cold):
    lane = _lane(_fleet(scale=[1.03, 0.97] * 4), online, warm=cold)
    assert lane.warm_tuple is not None and lane.root_warm_tuple is not None
    host, graph, plan = _both([lane])
    _assert_equal(host, graph)
    assert plan.sig.has_warm and plan.sig.has_root_warm


def test_nan_in_a_rows_warm_y_starts_it_cold_on_both_routes(online, cold):
    """A root row's carried iterate with a NaN in its y: the head's PDHG
    mode and the K5 wrapper both start that row cold."""
    lane = _lane(_fleet(), online, warm=cold)

    def poison(st):
        assert bool(st.node_warm[0, 0])
        ny = st.node_y.clone()
        ny[0, 0, 1] = float("nan")
        return st._replace(node_y=ny)

    host, graph, _ = _both([lane], edit=poison)
    _assert_equal(host, graph)


def test_per_k_plan_equals_host_loop(online):
    host, graph, plan = _both([_lane(_fleet(), online, per_k=True)], per_k=True)
    _assert_equal(host, graph)
    assert plan.sig.per_k


def test_f64_plan_equals_host_loop(online):
    host, graph, plan = _both([_lane(_fleet(), online)], pdhg_dtype="f64")
    _assert_equal(host, graph)
    assert plan.sig.lp_f64 and plan.vals.dtype == torch.float64
    assert plan.lp_in64["b"].dtype == torch.float64 and plan.res64[0].v.dtype == torch.float64
    assert plan.res[0].v.dtype == torch.float32


def test_two_lanes_one_settled_at_the_seed(online):
    """Two scenario lanes (one A): lane 1's frontier emptied in its seeded
    state, so it runs no round while lane 0 searches."""
    lanes = [_lane(_fleet(), online), _lane(_fleet(scale=[1.5, 0.8, 1.2, 0.9] * 2), online)]

    def settle_lane_1(st):
        active = st.active.clone()
        active[1] = False
        return st._replace(active=active)

    host, graph, plan = _both(lanes, edit=settle_lane_1)
    _assert_equal(host, graph)
    assert graph[1][1, 4] == 0.0 and graph[1][0, 4] >= 1
    assert plan.sig.L == 2 and not plan.sig.a_lanes and not plan.per_node


def test_two_lanes_with_an_a_each(online):
    lanes = [_lane(_fleet(seed=5), online), _lane(_fleet(seed=6), online)]
    host, graph, plan = _both(lanes, shared_A=False)
    _assert_equal(host, graph)
    assert plan.sig.a_lanes and plan.per_node
    assert plan.val_rows[1].shape == (2 * plan.sig.Bw, plan.sig.nnz)


def test_mixtral_m4_plan_equals_host_loop():
    model = profile_model(MIXTRAL, batch_sizes=[1], sequence_length=128).to_model_profile()
    devs = make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9))
    host, graph, plan = _both([_lane(devs, model, kv="8bit")])
    _assert_equal(host, graph)
    assert plan.sig.moe and plan.sig.engine == "pdhg" and plan.A_rows is None


def test_a_pdhg_plan_holds_no_dense_a_and_no_k1_workspace(online):
    lane = _lane(_fleet(), online)
    gp = _prepare([lane], _params(lane), GAP, CPU)
    plan = gp.plan
    assert plan.A is None and plan.A_rows is None
    assert plan.ws is None and plan.vec_ws is None
    assert plan.vals.shape == (plan.sig.nnz,)
    gp.release()


def test_route_fields_are_in_the_signature(online, monkeypatch):
    lane = _lane(_fleet(), online)
    gp = _prepare([lane], _params(lane), GAP, CPU)
    sig = gp.plan.sig
    gp.release()
    route, C, cplan = P.kernel_route(gp.entry.sparsity, torch.float32)
    assert (sig.route, sig.C, sig.smem, sig.buf_len) == (route, C, cplan.smem,
                                                         cplan.buf.numel())
    assert sig.route == "cluster" and sig.restart_tol == P.DEFAULT_RESTART_TOL
    static, _ = DL.ledger_signatures(sig)
    for f in ("engine", "lp_f64", "restart_tol", "route", "C", "smem", "buf_len"):
        assert f"{f}=" in static
    # A forced route (the module attribute both routes read) is another
    # signature: another plan, another capture on the card.
    monkeypatch.setattr(P, "kernel_route", lambda sp, dtype, c_max=8: ("grid", 0, None))
    gp = _prepare([lane], _params(lane), GAP, CPU)
    forced = gp.plan.sig
    gp.release()
    assert forced != sig and (forced.route, forced.C, forced.smem, forced.buf_len) == \
        ("grid", 0, 0, 0)


def test_head_pdhg_mode_tests_the_warm_iterate(online, cold):
    lane = _lane(_fleet(), online, warm=cold)
    gp = _prepare([lane], _params(lane, pdhg_dtype="f64"), GAP, CPU)
    plan = gp.plan
    data = plan.data(gp.entry)
    st = seeded_state(gp)[0]
    nz = st.node_z.clone()
    nz[0, 1, 0] = float("inf")
    st = st._replace(node_z=nz)
    plan.frozen.zero_()
    got = plan.head_pdhg_reference(data, st, 0)
    ins = S.round_inputs(data, st, plan.sig.B0, plan.frozen)
    want = ins.warm.ok.clone()
    want[1] = False
    assert bool(ins.warm.ok[1]) and _same(got["wok"], want)
    assert got["b"].dtype == torch.float64 and _same(got["b"], ins.b.double())
    assert _same(got["wy"], ins.warm.y.double()) and _same(got["skip"], ins.skip)
    gp.release()


def test_loop_routes():
    from distilp_torch.parallel import Mesh

    one_card = Mesh((CPU, CPU), True)
    cards = Mesh((torch.device("cuda", 0), torch.device("cuda", 1)), False)
    assert DL.loop_route(False, "pdhg", None, False) == ("graph", "dense_pdhg")
    assert DL.loop_route(True, "pdhg", None, False) == ("graph", "moe_pdhg")
    # A row mesh of one device takes the graph (R3c); distinct cards keep
    # the host loop.
    assert DL.loop_route(False, "pdhg", one_card, False, None, CPU) == \
        ("graph", "row_mesh_pdhg")
    assert DL.loop_route(False, "pdhg", cards, False, None, "cuda:0") == \
        ("host", "row_mesh_cards")
    assert DL.loop_route(False, "pdhg", None, True) == ("graph", "dense_pdhg+log")


# ------------------------------------------------------- against the JAX package


def test_placement_matches_jax(profiles_dir, online):
    pytest.importorskip("jax")
    from distilp_tpu.common import load_model_profile as jload_model
    from distilp_tpu.solver import halda_solve as jax_halda_solve
    from distilp_tpu.utils import make_synthetic_fleet as jax_fleet

    from distilp_torch import kernels

    jmodel = jload_model(profiles_dir / "llama_3_70b" / "online" / "model_profile.json")
    ref = jax_halda_solve(jax_fleet(M_DENSE, seed=SEED), jmodel, mip_gap=GAP, kv_bits="4bit",
                          backend="jax", lp_backend="pdhg")
    routes = kernels.SHAPES["bnb_graph"]
    before = sum(c for k, c in routes.items() if k.startswith("route=graph dense_pdhg"))
    got = halda_solve(_fleet(), online, mip_gap=GAP, kv_bits="4bit", device="cpu",
                      lp_backend="pdhg")
    # The port's solve took the plan (the graph route's plain run).
    assert sum(c for k, c in routes.items() if k.startswith("route=graph dense_pdhg")) > before
    assert got.certified and ref.certified
    assert (got.k, got.w, got.n) == (ref.k, ref.w, ref.n)
    assert math.isclose(got.obj_value, ref.obj_value, rel_tol=GAP)
    assert np.isfinite(got.obj_value)
