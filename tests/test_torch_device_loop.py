"""The dense sweep's loop as one plan (``distilp_torch/solver/device_loop.py``)
on the CPU, through the plain versions the card's graph runs: the plan's
loop (two state buffers used in turns, the plain head, K1's and the round
tail's plain versions, the plain control, a Python ``while`` for the WHILE
node) equals ``search.run_bnb_loop`` bit for bit in every state field, in
the root iterates and in the answer: the goldens, the north star cold and
warm, per-k hermes_70b, S=8 scenario lanes with a lane settled at the seed
(zero rounds) while others settle at different rounds, and ``max_rounds``
1, 2 and 3. The round head's plain version equals the gathers a round made
before it (``search.round_inputs``), and a stand-in library whose capture
or launch fails makes the search raise (no fallback to the host loop).

One process: ~10 s on an 8-core CPU.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distilp_torch import kernels  # noqa: E402
from distilp_torch.common import load_from_profile_folder, load_model_profile  # noqa: E402
from distilp_torch.kernels import build  # noqa: E402
from distilp_torch.solver import device_loop as DL  # noqa: E402
from distilp_torch.solver import packed as PK  # noqa: E402
from distilp_torch.solver import search as S  # noqa: E402
from distilp_torch.solver.api import _build_instance, _warm_to_ilp  # noqa: E402
from distilp_torch.solver.backend_torch import (  # noqa: E402
    _prepare,
    _search,
    _search_params,
    lane_input,
    seeded_state,
    solve_sweep_torch,
)
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402

CPU = torch.device("cpu")
GOLDEN = ("hermes_70b", "llama_3_70b/4bit", "llama_3_70b/online", "qwen3_32b/bf16")


def _online(profiles_dir):
    return load_model_profile(profiles_dir / "llama_3_70b" / "online" / "model_profile.json")


def _lanes(fleets, model, warm=None, per_k=False):
    out = []
    for devs in fleets:
        Ks, _, coeffs, arrays = _build_instance(devs, model, None, "4bit", None, None, 1)
        kWs = [(k, model.L // k) for k in Ks]
        feasible = [(k, W) for k, W in kWs if W >= len(devs)]
        out.append(lane_input(arrays, coeffs, kWs, feasible, warm=warm, per_k=per_k))
    return out


def _same(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        it = torch.int64 if a.element_size() == 8 else torch.int32
        return torch.equal(a.contiguous().view(it), b.contiguous().view(it))
    return torch.equal(a, b)


def _both(lanes, gap, per_k=False, edit=None, **over):
    """(host loop's (state, root iterates, answer), plan's (state, root
    iterates, answer)) of the same prepared sweep."""
    params = _search_params(lanes[0].sf, over.get("node_cap"), over.get("beam"), None,
                            over.get("max_rounds"), None, "ipm", None, None, None, per_k)
    hp = _prepare(lanes, params, gap, CPU, per_k=per_k, shared_A=True, _host_loop=True)
    assert hp.plan is None
    st = seeded_state(hp)[0]
    if edit is not None:
        st = edit(st)
    h_state, h_root, _ = S.run_bnb_loop(hp.data, st, gap, **hp.loop_kw)
    n_k = hp.data.ks.shape[1]
    h_ans = DL.answer_rows(h_state, h_root, n_k, per_k).numpy()
    gp = _prepare(lanes, params, gap, CPU, per_k=per_k, shared_A=True)
    plan = gp.plan
    assert plan is not None
    seeded = None
    if edit is not None:
        seeded = edit(seeded_state(gp)[0])
    g_ans = plan.run_plain(gp.entry, gp.warm, gp.root_warm, seeded=seeded)
    g_root = PK.split_answer(g_ans, plan.alay)["root"]
    g_state = S.SearchState(*[t.clone() for t in plan.states[1]])
    hp.release()
    gp.release()
    return (h_state, h_root, h_ans), (g_state, g_root, g_ans), n_k


def _assert_equal(host, graph, n_k):
    (h_state, h_root, h_ans), (g_state, g_root, g_ans) = host, graph
    bad = [f for f, a, b in zip(S.SearchState._fields, h_state, g_state) if not _same(a, b)]
    assert not bad, f"state fields differ: {bad}"
    for i, (a, b) in enumerate(zip(h_root, g_root)):
        assert np.array_equal(a[:, :n_k].to(torch.float64).reshape(b.shape).numpy(), b), i
    assert h_ans.tobytes() == g_ans.tobytes()


@pytest.mark.parametrize("folder", GOLDEN)
def test_goldens_plan_equals_host_loop(profiles_dir, folder):
    devs, model = load_from_profile_folder(profiles_dir / folder)
    host, graph, n_k = _both(_lanes([devs], model), 1e-4)
    _assert_equal(host, graph, n_k)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_north_star_plan_equals_host_loop(profiles_dir, warm):
    model = _online(profiles_dir)
    devs = make_synthetic_fleet(16, seed=123)
    hint = None
    if warm:
        arrays, kWs, coeffs = _sweep(devs, model)
        _, best = solve_sweep_torch(arrays, kWs, mip_gap=1e-3, coeffs=coeffs, device="cpu")
        hint = best
        assert best.ipm_state is not None
    lanes = _lanes([devs], model, warm=hint)
    assert (lanes[0].warm_tuple is not None) == warm
    assert (lanes[0].root_warm_tuple is not None) == warm
    host, graph, n_k = _both(lanes, 1e-3)
    _assert_equal(host, graph, n_k)
    assert float(graph[2][0, 4]) >= 1.0


def _sweep(devs, model):
    Ks, _, coeffs, arrays = _build_instance(devs, model, None, "4bit", None, None, 1)
    return arrays, [(k, model.L // k) for k in Ks], coeffs


def test_per_k_hermes_plan_equals_host_loop(profiles_dir):
    devs, model = load_from_profile_folder(profiles_dir / "hermes_70b")
    host, graph, n_k = _both(_lanes([devs], model, per_k=True), 1e-3, per_k=True)
    _assert_equal(host, graph, n_k)


def test_lanes_with_one_settled_at_the_seed(profiles_dir):
    """S=8 futures of the north star as lanes, lane 2's frontier emptied in
    its seeded state: it runs zero rounds (its carried-in root iterates
    come back) while the others settle at their own rounds."""
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

    host, graph, n_k = _both(_lanes(fleets, model), 1e-3, edit=settle_lane_2)
    _assert_equal(host, graph, n_k)
    rounds = graph[2][:, 4]
    assert rounds[2] == 0.0 and rounds.max() >= 1.0
    assert graph[2][2, PK.AnswerLayout(16, n_k, 0, 0, False, False).head] == 0.0  # not ran


@pytest.mark.parametrize("max_rounds", [1, 2, 3])
def test_max_rounds(profiles_dir, max_rounds):
    model = _online(profiles_dir)
    lanes = _lanes([make_synthetic_fleet(16, seed=123)], model)
    host, graph, n_k = _both(lanes, 1e-4, max_rounds=max_rounds)
    _assert_equal(host, graph, n_k)
    assert float(graph[2][0, 4]) == max_rounds


def test_head_equals_the_rounds_old_gathers(profiles_dir):
    """``round_inputs`` (the head's plain version) against the gathers a
    round made inline before it, on a mid-search state of two lanes with
    lane 1 frozen."""
    model = _online(profiles_dir)
    fleets = [make_synthetic_fleet(16, seed=s) for s in (123, 5)]
    lanes = _lanes(fleets, model)
    params = _search_params(lanes[0].sf, None, 6, None, None, None, "ipm", None, None, None,
                            False)
    prep = _prepare(lanes, params, 1e-3, CPU, _host_loop=True)
    data = prep.data
    st, _, _ = S.run_bnb_loop(data, seeded_state(prep)[0], 1e-3, ipm_iters=12, max_rounds=2,
                              beam=6)
    frozen = torch.tensor([False, True])
    L, B = 2, 6
    row_lane = torch.arange(L).repeat_interleave(B)

    def flat(t):
        return t.reshape(L * B, *t.shape[2:])

    active_p = st.active[:, :B] & ~frozen[:, None]
    kidx_r = flat(st.node_kidx[:, :B].long())
    old = dict(b=data.b_k[row_lane, kidx_r], c=data.c_k[row_lane, kidx_r],
               lo=flat(st.node_lo[:, :B]), hi=flat(st.node_hi[:, :B]),
               v=flat(st.node_v[:, :B]), y=flat(st.node_y[:, :B]), z=flat(st.node_z[:, :B]),
               f=flat(st.node_f[:, :B]), ok=flat(st.node_warm[:, :B]), skip=~flat(active_p))
    got = S.round_inputs(data, st, B, frozen)
    new = dict(b=got.b, c=got.c, lo=got.lo, hi=got.hi, v=got.warm.v, y=got.warm.y,
               z=got.warm.z, f=got.warm.f, ok=got.warm.ok, skip=got.skip)
    assert all(_same(old[k], new[k]) for k in old)
    assert torch.equal(got.kidx, kidx_r) and torch.equal(got.lane, row_lane)
    assert bool(got.skip[B:].all())  # the frozen lane's rows skip
    prep.release()


class _Lib:
    """Stands in for the built libraries: every launcher succeeds, except
    the one named ``fail``, which returns a CUDA error."""

    def __init__(self, fail: str):
        self.fail = fail
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("dtk_"):
            raise AttributeError(name)

        def fn(*args):
            self.calls.append(name)
            if name == "dtk_bnb_graph_new":
                ctypes.cast(args[0], ctypes.POINTER(ctypes.c_void_p))[0] = 0x1000
            if name == "dtk_bnb_capture_end":
                ctypes.cast(args[1], ctypes.POINTER(ctypes.c_void_p))[0] = 0x2000 + len(self.calls)
            return 900 if name == self.fail else 0

        return fn


@pytest.mark.parametrize("fail", ["dtk_bnb_capture_end", "dtk_bnb_graph_finish",
                                  "dtk_bnb_graph_launch", "dtk_bnb_head"])
def test_a_failed_capture_or_launch_raises(profiles_dir, monkeypatch, fail):
    """A plan whose graph cannot be captured, instantiated or launched makes
    the search raise: nothing falls back to the host loop or the plain
    versions."""
    devs, model = load_from_profile_folder(profiles_dir / "llama_3_70b" / "online")
    lanes = _lanes([devs], model)
    params = _search_params(lanes[0].sf, None, None, None, None, None, "ipm", None, None, None,
                            False)
    DL.clear_plans()  # a fresh plan: its graph is captured in this test
    prep = _prepare(lanes, params, 1e-4, CPU)
    assert prep.plan is not None
    lib = _Lib(fail)
    monkeypatch.setattr(build, "_LIBS", {name: lib for name in build.SOURCES})
    monkeypatch.setattr(kernels, "on_cuda", lambda *t: True)
    monkeypatch.setattr(PK, "read_answer", lambda ans: pytest.fail("no answer after a failure"))
    host_loop = S.run_bnb_loop
    monkeypatch.setattr(S, "run_bnb_loop", lambda *a, **k: pytest.fail("fell back"))
    with pytest.raises(RuntimeError, match="cudaError 900"):
        _search(prep)
    assert "dtk_bnb_graph_new" in lib.calls
    if fail != "dtk_bnb_graph_launch":
        assert "dtk_bnb_graph_free" in lib.calls or "dtk_bnb_graph_launch" not in lib.calls
    monkeypatch.setattr(S, "run_bnb_loop", host_loop)
    DL.clear_plans()  # no plan keeps a stand-in's graph
