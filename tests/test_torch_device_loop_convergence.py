"""The round log on the loop's plan (``distilp_torch/solver/device_loop.py``,
a diagnostics plan: ``diag``) on the CPU, through the plain versions the
card's graph runs: the root round's LP with its convergence trace on (K1's,
K5's or the row-sharded PDHG's plain version), the plain control writing
each round's row (``search.round_row`` on the plan's two state buffers) and
the plain answer carrying the log and the root trace.

With the log on, the plan's loop equals ``search.run_bnb_loop(
collect_rounds=True)`` bit for bit in every state field, in the root
iterates and in the whole answer (head, root iterates, the log padded to
``max_rounds`` rows and the root trace; ``backend_torch.host_answer``):
the online golden on both engines, the north star cold and warm,
per-k hermes_70b, Mixtral 8x7B over 4 devices on the IPM and the PDHG, a
small PDHG fleet in float64, S=8 scenario lanes with one settled at the
seed (its row 0 has ``executed`` 0 and its trace is zero), ``max_rounds``
1, 2 and 3, a row mesh of S=2, and one plan reused for a long solve and
then a short one (no stale rows). With the log off, a plan's answer is
byte-identical to that of a plan built without the ``diag`` field, and it
is the diagnostics answer's head. A stand-in library whose capture or
launch fails (the logged control and the traced root LP included) makes
a logged search raise: no fallback to the host loop.

One process: ~25 s on an 8-core CPU.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_device_loop import _lanes, _online, _same, _sweep  # noqa: E402

from distilp_torch.common import load_from_profile_folder  # noqa: E402
from distilp_torch.parallel import VIRTUAL_DEVICES_ENV, shard_mesh  # noqa: E402
from distilp_torch.profiler import profile_model  # noqa: E402
from distilp_torch.solver import device_loop as DL  # noqa: E402
from distilp_torch.solver import packed as PK  # noqa: E402
from distilp_torch.solver import search as S  # noqa: E402
from distilp_torch.solver.backend_torch import (  # noqa: E402
    _prepare,
    _search_params,
    host_answer,
    solve_sweep_torch,
)
from distilp_torch.solver.backend_torch import seeded_state  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402

CPU = torch.device("cpu")
MIXTRAL = "tests/configs/mixtral_8x7b.json"


@pytest.fixture(scope="module", autouse=True)
def few_threads_and_a_virtual_mesh():
    """Few intra-op threads (the plain LP engines' small batched products
    each open a parallel region) and a declared virtual mesh of 8
    devices."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    saved = os.environ.get(VIRTUAL_DEVICES_ENV)
    os.environ[VIRTUAL_DEVICES_ENV] = "8"
    yield
    torch.set_num_threads(n)
    if saved is None:
        del os.environ[VIRTUAL_DEVICES_ENV]
    else:
        os.environ[VIRTUAL_DEVICES_ENV] = saved


@pytest.fixture(scope="module")
def mixtral():
    return profile_model(MIXTRAL, batch_sizes=[1], sequence_length=128).to_model_profile()


def _params(lane, engine="ipm", per_k=False, max_rounds=None, shards=None, pdhg_dtype=None):
    return _search_params(lane.sf, None, None, None, max_rounds, None, engine, None, shards,
                          pdhg_dtype, per_k)


def _both(lanes, params, gap, per_k=False, edit=None, **kw):
    """(host loop's (state, root iterates, answer), plan's (state, root
    iterates, answer), plan) of the same prepared sweep with the round log
    on; ``edit`` changes both seeded states alike."""
    hp = _prepare(lanes, params, gap, CPU, per_k=per_k, shared_A=True, _host_loop=True,
                  convergence={}, **kw)
    assert hp.plan is None and hp.loop_kw["collect_rounds"]
    st, duals, raw, m_y, _ = seeded_state(hp)
    if edit is not None:
        st = edit(st)
    h_state, h_root, log = S.run_bnb_loop(hp.data, st, gap, **hp.loop_kw)
    h_ans, h_lay = host_answer(hp, h_state, h_root, log, duals, raw, m_y)
    gp = _prepare(lanes, params, gap, CPU, per_k=per_k, shared_A=True, convergence={}, **kw)
    plan = gp.plan
    assert plan is not None and plan.sig.diag
    assert plan.alay == h_lay and plan.alay.conv_rows == params["max_rounds"]
    seeded = None if edit is None else edit(seeded_state(gp)[0])
    g_ans = plan.run_plain(gp.entry, gp.warm, gp.root_warm, seeded=seeded)
    g_root = PK.split_answer(g_ans, plan.alay)["root"]
    g_state = S.SearchState(*[t.clone() for t in plan.states[1]])
    hp.release()
    gp.release()
    return (h_state, h_root, h_ans.numpy()), (g_state, g_root, g_ans), plan


def _assert_equal(host, graph, plan):
    (h_state, h_root, h_ans), (g_state, g_root, g_ans) = host, graph
    bad = [f for f, a, b in zip(S.SearchState._fields, h_state, g_state) if not _same(a, b)]
    assert not bad, f"state fields differ: {bad}"
    n_k = plan.sig.n_k
    for i, (a, b) in enumerate(zip(h_root, g_root)):
        assert np.array_equal(a[:, :n_k].to(torch.float64).reshape(b.shape).numpy(), b), i
    assert h_ans.tobytes() == g_ans.tobytes()
    rl, tr = PK.split_answer(g_ans, plan.alay)["conv"]
    # The log is not empty: one executed row a round some lane ran, in order.
    rounds = g_ans[:, 4]
    assert rl.shape == (plan.sig.max_rounds, plan.sig.L, S.RL_COLS)
    assert tr.shape == (plan.sig.L, *plan.alay.trace_shape)
    for q in range(plan.sig.L):
        ran = rl[:, q, S.RL_COLS - 1] > 0.5
        assert ran.sum() == rounds[q] and not ran[int(rounds[q]):].any()
    return rl, tr


@pytest.mark.parametrize("engine", ["ipm", "pdhg"])
def test_online_golden(profiles_dir, engine):
    devs, model = load_from_profile_folder(profiles_dir / "llama_3_70b" / "online")
    lanes = _lanes([devs], model)
    host, graph, plan = _both(lanes, _params(lanes[0], engine), 1e-4)
    rl, tr = _assert_equal(host, graph, plan)
    assert plan.sig.engine == engine and rl[0, 0, 5] == 1.0
    assert np.any(tr[0][..., 5] > 0.5)  # live trace rows


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_north_star(profiles_dir, warm):
    model = _online(profiles_dir)
    devs = make_synthetic_fleet(16, seed=123)
    hint = None
    if warm:
        arrays, kWs, coeffs = _sweep(devs, model)
        hint = solve_sweep_torch(arrays, kWs, mip_gap=1e-3, coeffs=coeffs, device="cpu")[1]
    lanes = _lanes([devs], model, warm=hint)
    host, graph, plan = _both(lanes, _params(lanes[0]), 1e-3)
    _, tr = _assert_equal(host, graph, plan)
    # A warm root runs the IPM's chunk (several trace rows), a cold one the
    # whole budget as one chunk.
    assert plan.sig.has_root_warm == warm and (plan.sig.trace_rows > 1) == warm
    assert tr.shape[2] == plan.sig.trace_rows


def test_per_k_hermes(profiles_dir):
    devs, model = load_from_profile_folder(profiles_dir / "hermes_70b")
    lanes = _lanes([devs], model, per_k=True)
    host, graph, plan = _both(lanes, _params(lanes[0], per_k=True), 1e-3, per_k=True)
    _assert_equal(host, graph, plan)
    assert plan.sig.per_k


def _mixtral_lane(model):
    from test_torch_device_loop_moe import _lane

    return _lane(make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9)), model)


@pytest.mark.parametrize("engine", ["ipm", "pdhg"])
def test_mixtral(mixtral, engine):
    lane = _mixtral_lane(mixtral)
    host, graph, plan = _both([lane], _params(lane, engine), 1e-3)
    _assert_equal(host, graph, plan)
    assert plan.sig.moe and plan.sig.engine == engine


def test_pdhg_f64_fleet(profiles_dir):
    model = _online(profiles_dir)
    lanes = _lanes([make_synthetic_fleet(8, seed=5)], model)
    host, graph, plan = _both(lanes, _params(lanes[0], "pdhg", pdhg_dtype="f64"), 1e-3)
    _assert_equal(host, graph, plan)
    assert plan.sig.lp_f64 and plan.trace.dtype == torch.float64


def test_lanes_with_one_settled_at_the_seed(profiles_dir):
    """S=8 futures of the north star as lanes, lane 2's frontier emptied in
    its seeded state: its row 0 says it did not run the root round and its
    root trace is zero, while the other lanes log their own rounds."""
    model = _online(profiles_dir)
    devs = make_synthetic_fleet(16, seed=123)
    rng = np.random.default_rng(17)
    fleets = []
    for _ in range(8):
        snap = [d.model_copy(deep=True) for d in devs]
        for d in snap:
            d.t_comm = max(0.0, d.t_comm * float(rng.uniform(0.5, 2.0)))
        fleets.append(snap)

    def settle_lane_2(st):
        active = st.active.clone()
        active[2] = False
        return st._replace(active=active)

    lanes = _lanes(fleets, model)
    host, graph, plan = _both(lanes, _params(lanes[0]), 1e-3, edit=settle_lane_2)
    rl, tr = _assert_equal(host, graph, plan)
    assert rl[0, 2, 5] == 0.0 and not np.any(tr[2])
    assert np.all(rl[0, [q for q in range(8) if q != 2], 5] == 1.0)
    assert np.any(tr[0])


@pytest.mark.parametrize("max_rounds", [1, 2, 3])
def test_max_rounds(profiles_dir, max_rounds):
    model = _online(profiles_dir)
    lanes = _lanes([make_synthetic_fleet(16, seed=123)], model)
    host, graph, plan = _both(lanes, _params(lanes[0], max_rounds=max_rounds), 1e-4)
    rl, _ = _assert_equal(host, graph, plan)
    assert float(graph[2][0, 4]) == max_rounds and np.all(rl[:, 0, 5] == 1.0)


def test_row_mesh(profiles_dir):
    model = _online(profiles_dir)
    lanes = _lanes([make_synthetic_fleet(8, seed=5)], model)
    params = _params(lanes[0], "pdhg", shards=2)
    host, graph, plan = _both(lanes, params, 1e-3, row_mesh=shard_mesh(2, "cpu"))
    _assert_equal(host, graph, plan)
    assert plan.sig.mesh == "row" and plan.sig.S == 2


def test_a_reused_plan_shows_no_stale_rows(profiles_dir):
    """One plan serves a long solve, then a short one of its signature (the
    lane settled at the seed): the short solve's answer, log and trace are
    the host loop's, all zero."""
    model = _online(profiles_dir)
    lanes = _lanes([make_synthetic_fleet(16, seed=123)], model)
    params = _params(lanes[0])
    DL.clear_plans()
    host, graph, plan = _both(lanes, params, 1e-4)
    rl, _ = _assert_equal(host, graph, plan)
    assert rl[:, 0, 5].sum() >= 2

    def settle(st):
        return st._replace(active=torch.zeros_like(st.active))

    host, graph, again = _both(lanes, params, 1e-4, edit=settle)
    assert again is plan
    rl, tr = _assert_equal(host, graph, plan)
    assert not np.any(rl) and not np.any(tr) and graph[2][0, 4] == 0.0


def test_log_off_is_the_untraced_plan(profiles_dir):
    """With the log off, a plan's signature, buffers and answer are those
    of a plan built without the ``diag`` field; with it on, the answer's
    head and root iterates are the untraced answer, byte for byte."""
    model = _online(profiles_dir)
    lanes = _lanes([make_synthetic_fleet(16, seed=123)], model)
    params = _params(lanes[0])
    gp = _prepare(lanes, params, 1e-3, CPU, shared_A=True)
    sig = gp.plan.sig
    assert not sig.diag and sig.trace_rows == 0 and gp.plan.log is None
    legacy = DL.PlanSig(*(getattr(sig, f) for f in DL.PlanSig._fields
                          if f not in ("diag", "trace_rows")))
    assert legacy == sig and "diag=False" in DL.ledger_signatures(sig)[0]
    off = gp.plan.run_plain(gp.entry, gp.warm, gp.root_warm)
    gp.release()
    bare = DL.LoopPlan(legacy)
    bare.stage(lanes)
    assert bare.alay == PK.AnswerLayout(sig.M, sig.n_k, sig.m, sig.nf, False, False)
    assert bare.run_plain(gp.entry, None, None).tobytes() == off.tobytes()
    dp = _prepare(lanes, params, 1e-3, CPU, shared_A=True, convergence={})
    plan = dp.plan
    assert plan.sig == sig._replace(diag=True, trace_rows=1)
    on = plan.run_plain(dp.entry, dp.warm, dp.root_warm)
    dp.release()
    assert on[:, :off.shape[1]].tobytes() == off.tobytes()
    assert on.shape[1] == off.shape[1] + plan.alay.conv_rows * S.RL_COLS + plan.alay.trace_size


@pytest.mark.parametrize("fail", ["dtk_bnb_capture_end", "dtk_bnb_graph_launch",
                                  "dtk_bnb_control", "dtk_ipm_f32"])
def test_a_failed_logged_capture_or_launch_raises(profiles_dir, monkeypatch, fail):
    """A diagnostics plan whose graph cannot be captured or launched (its
    logged control or traced root LP included) makes the search raise:
    nothing falls back to the host loop."""
    from test_torch_device_loop import _Lib

    from distilp_torch import kernels
    from distilp_torch.kernels import build
    from distilp_torch.solver.backend_torch import _search

    devs, model = load_from_profile_folder(profiles_dir / "llama_3_70b" / "online")
    lanes = _lanes([devs], model)
    DL.clear_plans()
    prep = _prepare(lanes, _params(lanes[0]), 1e-4, CPU, convergence={})
    assert prep.plan is not None and prep.plan.sig.diag
    lib = _Lib(fail)
    monkeypatch.setattr(build, "_LIBS", {name: lib for name in build.SOURCES})
    monkeypatch.setattr(kernels, "on_cuda", lambda *t: True)
    monkeypatch.setattr(PK, "read_answer", lambda ans: pytest.fail("no answer after a failure"))
    monkeypatch.setattr(S, "run_bnb_loop", lambda *a, **k: pytest.fail("fell back"))
    with pytest.raises(RuntimeError, match="cudaError 900"):
        _search(prep)
    assert "dtk_bnb_graph_new" in lib.calls
    DL.clear_plans()  # no plan keeps a stand-in's graph
