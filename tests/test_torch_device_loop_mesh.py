"""The meshes' rounds on the loop's plan (``distilp_torch/solver/
device_loop.py``) on the CPU, through the plain versions the card's graph
runs (the head's row-mesh mode, the row-sharded PDHG's plain version on
the plan's row blocks, the gather's; on the node mesh K1's or K5's and
K2's plain versions a shard at a time; the round tail's, the control's and
the answer's), on a virtual mesh of this process's CPU:

- the plan's loop equals ``search.run_bnb_loop`` after
  ``backend_torch.seeded_state`` bit for bit in every state field and in
  the answer: the row mesh on a small dense fleet at S=2 and S=4 (m = 49
  rows, padded to 50 and 52) cold, warm with a hint and root iterates, in
  float64 and per k (6 rounds), Mixtral 8x7B on 4 devices at S=2 (B6c's per-element
  blocks) and a warm state with a NaN in one row's y (that row starts cold
  on both routes); the node mesh at 4 shards on the IPM (the root round
  padded to the mesh), per k, on the PDHG, and Mixtral M=4 (MoE);
- the placements match the JAX package's: ``halda_solve(...,
  lp_backend='pdhg', mesh_shards=2)`` (k, w, n) with the objective within
  ``mip_gap``, the port's solve taken by the plan; the node-sharded sweep,
  both certified and within 2x gap;
- the mesh and its shards are in the plan's signature and the compile
  ledger's parts, and a mesh over two distinct devices keeps the host loop
  under its own route key.

One process: ~60-90 s on an 8-core CPU.
"""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distilp_torch import kernels  # noqa: E402
from distilp_torch.common import load_from_profile_folder, load_model_profile  # noqa: E402
from distilp_torch.parallel import (  # noqa: E402
    VIRTUAL_DEVICES_ENV,
    Mesh,
    pad_cap_to_mesh,
    shard_mesh,
    solve_sweep_sharded,
)
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
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402

CPU = torch.device("cpu")
GAP = 1e-3
M_DENSE, SEED = 8, 5
MIXTRAL = "tests/configs/mixtral_8x7b.json"


@pytest.fixture(scope="module", autouse=True)
def few_threads_and_a_virtual_mesh():
    """Few intra-op threads (the plain PDHG's small batched products each
    open a parallel region) and a declared virtual mesh of 8 devices."""
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
def online(profiles_dir):
    return load_model_profile(profiles_dir / "llama_3_70b" / "online" / "model_profile.json")


@pytest.fixture(scope="module")
def mixtral():
    return profile_model(MIXTRAL, batch_sizes=[1], sequence_length=128).to_model_profile()


def _fleet(seed=SEED):
    return make_synthetic_fleet(M_DENSE, seed=seed)


def _mixtral_fleet():
    return make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9))


def _lane(devs, model, kv="4bit", warm=None, per_k=False):
    Ks, _, coeffs, arrays = _build_instance(devs, model, None, kv, None, None)
    kWs = [(k, model.L // k) for k in Ks]
    feas = [(k, W) for k, W in kWs if W >= len(devs)]
    return lane_input(arrays, coeffs, kWs, feas, warm=warm, per_k=per_k)


def _same(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        it = torch.int64 if a.element_size() == 8 else torch.int32
        return torch.equal(a.contiguous().view(it), b.contiguous().view(it))
    return torch.equal(a, b)


def _row(lane, shards, per_k=False, pdhg_dtype=None, max_rounds=None):
    """(params, prepare keywords) of a row-mesh sweep on ``shards``."""
    params = _search_params(lane.sf, None, None, None, max_rounds, None, "pdhg", None, shards,
                            pdhg_dtype, per_k)
    return params, dict(row_mesh=shard_mesh(shards, "cpu"))


def _node(lane, shards, engine=None, per_k=False):
    """(params, prepare keywords) of a node-sharded sweep on ``shards``, its
    capacity, beam and root round padded as ``solve_sweep_sharded`` pads
    them."""
    mesh = shard_mesh(shards, "cpu")
    n_k = len(lane.sf.ks)
    params = _search_params(lane.sf, None, None, None, 48, None, engine, None, None, None,
                            per_k)
    cap = pad_cap_to_mesh(max(params["cap"], 2 * n_k), mesh)
    params.update(cap=cap, beam=min(pad_cap_to_mesh(params["beam"], mesh), cap))
    return params, dict(node_mesh=mesh, root_beam=min(pad_cap_to_mesh(n_k, mesh), cap))


def _both(lane, params, kw, per_k=False, edit=None):
    """(host loop's (state, answer), plan's (state, answer), plan) of the
    same prepared mesh sweep; ``edit`` changes both seeded states alike."""
    hp = _prepare([lane], params, GAP, CPU, per_k=per_k, shared_A=True, _host_loop=True, **kw)
    assert hp.plan is None
    st, duals, raw, _, _ = seeded_state(hp)
    if edit is not None:
        st = edit(st)
    h_state, h_root, _ = S.run_bnb_loop(hp.data, st, GAP, **hp.loop_kw)
    n_k = hp.data.ks.shape[1]
    h_ans = DL.answer_rows(h_state, h_root, n_k, per_k, duals, raw).numpy()
    gp = _prepare([lane], params, GAP, CPU, per_k=per_k, shared_A=True, **kw)
    plan = gp.plan
    assert plan is not None and plan.sig.mesh in ("row", "node")
    seeded = None if edit is None else edit(seeded_state(gp)[0])
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
    assert g_ans[0, 4] >= 1  # rounds ran


@pytest.fixture(scope="module")
def cold(online):
    """A cold PDHG solve of the small fleet at S=2: its hint and root
    iterates seed the warm cases."""
    Ks, _, coeffs, arrays = _build_instance(_fleet(), online, None, "4bit", None, None)
    _, best = solve_sweep_torch(arrays, [(k, online.L // k) for k in Ks], mip_gap=GAP,
                                coeffs=coeffs, device="cpu", lp_backend="pdhg", mesh_shards=2)
    assert best is not None and best.ipm_state is not None
    return best


# ------------------------------------------------------------------ row mesh


@pytest.mark.parametrize("shards,pad", [(2, 1), (4, 3)])
def test_row_mesh_cold_plan_equals_host_loop(online, shards, pad):
    lane = _lane(_fleet(), online)
    host, graph, plan = _both(lane, *_row(lane, shards))
    _assert_equal(host, graph)
    sig = plan.sig
    assert (sig.mesh, sig.S) == ("row", shards) and sig.S * sig.ms - sig.m == pad
    assert plan.A_blk[0].shape == (sig.ms, sig.nf) and plan.b_blk.shape[0] == shards
    assert plan.vals is None and plan.val_rows is None and not plan.k5_rows


def test_row_mesh_warm_plan_equals_host_loop(online, cold):
    lane = _lane(_fleet(), online, warm=cold)
    assert lane.warm_tuple is not None and lane.root_warm_tuple is not None
    host, graph, plan = _both(lane, *_row(lane, 2))
    _assert_equal(host, graph)
    assert plan.sig.has_warm and plan.sig.has_root_warm


def test_row_mesh_nan_in_a_rows_warm_y_starts_it_cold_on_both_routes(online, cold):
    lane = _lane(_fleet(), online, warm=cold)

    def poison(st):
        assert bool(st.node_warm[0, 0])
        ny = st.node_y.clone()
        ny[0, 0, 1] = float("nan")
        return st._replace(node_y=ny)

    params, kw = _row(lane, 2)
    host, graph, _ = _both(lane, params, kw, edit=poison)
    _assert_equal(host, graph)
    # The head's mesh mode judges the row on its full arrays, before any
    # cast or padding: the poisoned root alone loses its warm start.
    gp = _prepare([lane], params, GAP, CPU, shared_A=True, **kw)
    plan = gp.plan
    plan.load_static(gp.entry)
    st = seeded_state(gp)[0]
    warm_roots = st.node_warm[0, :plan.sig.n_k].clone()
    plan.frozen.zero_()
    got = plan.head_mesh_reference(plan.data(gp.entry), poison(st), 0)
    gp.release()
    assert not bool(got["wok"][0])
    assert _same(got["wok"][1:plan.sig.n_k], warm_roots[1:])


def test_row_mesh_f64_plan_equals_host_loop(online):
    lane = _lane(_fleet(), online)
    host, graph, plan = _both(lane, *_row(lane, 2, pdhg_dtype="f64"))
    _assert_equal(host, graph)
    assert plan.sig.lp_f64 and plan.b_blk.dtype == torch.float64
    assert plan.A_blk[0].dtype == torch.float64 and plan.res64[0].y_dual.dtype == torch.float64


def test_row_mesh_per_k_plan_equals_host_loop(online):
    """Per-k rounds (cut at 6 rounds: every k's search stays open, so each
    round runs the beam of every k; both routes stop at the same round)."""
    lane = _lane(_fleet(), online, per_k=True)
    host, graph, plan = _both(lane, *_row(lane, 2, per_k=True, max_rounds=6), per_k=True)
    _assert_equal(host, graph)
    assert plan.sig.per_k and plan.sig.max_rounds == 6


def test_row_mesh_mixtral_m4_plan_equals_host_loop(mixtral):
    lane = _lane(_mixtral_fleet(), mixtral, kv="8bit")
    host, graph, plan = _both(lane, *_row(lane, 2))
    _assert_equal(host, graph)
    sig = plan.sig
    assert sig.moe and sig.mesh == "row" and len(sig.blk_nnz) == 2 and plan.elem
    # Every expert-busy entry has one place in one block's values.
    off, stride = plan.gky_mesh
    assert set(stride.tolist()) <= set(sig.blk_nnz) and len(set(off.tolist())) == 2 * sig.M


# ----------------------------------------------------------------- node mesh


@pytest.mark.parametrize("engine,per_k", [("ipm", False), ("ipm", True), ("pdhg", False)])
def test_node_mesh_plan_equals_host_loop(online, engine, per_k):
    lane = _lane(make_synthetic_fleet(16, seed=123), online, per_k=per_k)
    host, graph, plan = _both(lane, *_node(lane, 4, engine, per_k), per_k=per_k)
    _assert_equal(host, graph)
    sig = plan.sig
    assert (sig.mesh, sig.S, sig.engine) == ("node", 4, engine)
    assert sig.B0 % 4 == 0 and sig.B0 >= sig.n_k and sig.Bw % 4 == 0


def test_node_mesh_mixtral_m4_plan_equals_host_loop(mixtral):
    lane = _lane(_mixtral_fleet(), mixtral, kv="8bit")
    host, graph, plan = _both(lane, *_node(lane, 4))
    _assert_equal(host, graph)
    assert plan.sig.moe and plan.sig.mesh == "node"


# ------------------------------------------------------- route and signature


def test_mesh_fields_are_in_the_signature_and_the_ledger(online, mixtral):
    lane = _lane(_fleet(), online)
    params, kw = _row(lane, 4)
    gp = _prepare([lane], params, GAP, CPU, shared_A=True, **kw)
    sig = gp.plan.sig
    gp.release()
    assert (sig.mesh, sig.S, sig.ms, sig.Gs, sig.blk_nnz) == ("row", 4, 13, 0, ())
    static, shape = (dict(part.split("=", 1) for part in text.split(","))
                     for text in DL.ledger_signatures(sig))
    assert (static["mesh"], static["S"], static["Gs"]) == ("'row'", "4", "0")
    assert shape["ms"] == "13" and "blk_nnz" in shape and "blk_index" in shape
    assert not {"mesh", "S", "Gs"} & set(shape) and not {"ms", "blk_nnz"} & set(static)
    ml = _lane(_mixtral_fleet(), mixtral, kv="8bit")
    params, kw = _row(ml, 2)
    gp = _prepare([ml], params, GAP, CPU, shared_A=True, **kw)
    msig = gp.plan.sig
    gp.release()
    rb = gp.entry.mesh_blocks(2)
    assert msig.blk_nnz == tuple(sp.nnz for sp in rb.sparsity)
    assert msig.blk_index == tuple(int(sp.index.numel()) for sp in rb.sparsity)
    assert gp.entry.mesh_blocks(2) is rb  # kept on the static entry
    nl = _lane(make_synthetic_fleet(16, seed=123), online)
    params, kw = _node(nl, 8)
    gp = _prepare([nl], params, GAP, CPU, shared_A=True, **kw)
    nsig = gp.plan.sig
    gp.release()
    assert (nsig.mesh, nsig.S, nsig.B0) == ("node", 8, kw["root_beam"])
    assert nsig.B0 % 8 == 0 and nsig.B0 > nsig.n_k


def test_routes_of_meshes():
    cards = (torch.device("cuda", 0), torch.device("cuda", 1))
    one_card = Mesh((torch.device("cuda", 0),) * 2, True)
    cpu = Mesh((CPU,) * 4, True)
    assert DL.loop_route(False, "pdhg", cpu, False, None, CPU) == ("graph", "row_mesh_pdhg")
    assert DL.loop_route(True, "pdhg", cpu, False, None, CPU) == ("graph", "moe_row_mesh_pdhg")
    assert DL.loop_route(False, "ipm", None, False, cpu, CPU) == ("graph", "node_mesh_ipm")
    assert DL.loop_route(True, "pdhg", None, False, cpu, CPU) == ("graph",
                                                                  "moe_node_mesh_pdhg")
    assert DL.loop_route(False, "pdhg", one_card, False, None, "cuda:0") == \
        ("graph", "row_mesh_pdhg")
    # Shards over distinct cards keep the host loop, each mesh under its key.
    assert DL.loop_route(False, "pdhg", Mesh(cards, False), False, None, "cuda:0") == \
        ("host", "row_mesh_cards")
    assert DL.loop_route(False, "ipm", None, False, Mesh(cards, False), "cuda:0") == \
        ("host", "node_mesh_cards")
    # The round log takes its mesh's graph route, marked (R3d).
    assert DL.loop_route(False, "pdhg", cpu, True, None, CPU) == ("graph",
                                                                  "row_mesh_pdhg+log")
    # A node mesh takes no round log, on one card or over several.
    for mesh in (cpu, Mesh(cards, False)):
        with pytest.raises(ValueError, match="no round log"):
            DL.loop_route(False, "ipm", None, True, mesh, CPU)


def test_a_mesh_over_distinct_devices_keeps_the_host_loop(online, monkeypatch):
    """``_prepare`` takes no plan for a mesh whose shards span devices (a
    stand-in mesh of two distinct devices, the loop route asked of it) and
    counts the search under its own route key."""
    lane = _lane(_fleet(), online)
    params, _ = _row(lane, 2)
    two = Mesh((CPU, torch.device("meta")), False)
    kernels.reset_launch_counts()
    hp = _prepare([lane], params, GAP, CPU, shared_A=True, row_mesh=two)
    assert hp.plan is None and hp.loop_kw["row_mesh"] is two
    hp.release()
    nl = _lane(make_synthetic_fleet(16, seed=123), online)
    nparams, nkw = _node(nl, 2)
    hp = _prepare([nl], nparams, GAP, CPU, shared_A=True, node_mesh=two,
                  root_beam=nkw["root_beam"])
    assert hp.plan is None and hp.loop_kw["node_mesh"].mesh is two
    hp.release()
    routes = kernels.SHAPES["bnb_graph"]
    assert routes == {"route=host row_mesh_cards L=1": 1, "route=host node_mesh_cards L=1": 1}
    kernels.reset_launch_counts()


# ------------------------------------------------------- against the JAX package


def test_row_mesh_placement_matches_jax(profiles_dir):
    pytest.importorskip("jax")
    from distilp_tpu.common import load_from_profile_folder as jload
    from distilp_tpu.solver import halda_solve as jax_halda_solve

    folder = profiles_dir / "llama_3_70b" / "online"
    jdevs, jmodel = jload(folder)
    ref = jax_halda_solve(jdevs, jmodel, mip_gap=GAP, kv_bits="4bit", backend="jax",
                          lp_backend="pdhg", mesh_shards=2)
    devs, model = load_from_profile_folder(folder)
    routes = kernels.SHAPES["bnb_graph"]
    before = sum(c for k, c in routes.items() if k.startswith("route=graph row_mesh_pdhg"))
    got = halda_solve(devs, model, mip_gap=GAP, kv_bits="4bit", device="cpu",
                      lp_backend="pdhg", mesh_shards=2)
    # The port's solve took the plan (the graph route's plain run).
    assert sum(c for k, c in routes.items() if k.startswith("route=graph row_mesh_pdhg")) > \
        before
    assert got.certified and ref.certified
    assert (got.k, got.w, got.n) == (ref.k, ref.w, ref.n)
    assert math.isclose(got.obj_value, ref.obj_value, rel_tol=GAP)
    assert np.isfinite(got.obj_value)


def test_node_mesh_sweep_matches_jax(profiles_dir):
    pytest.importorskip("jax")
    from distilp_tpu.common import kv_bits_to_factor as jkv
    from distilp_tpu.common import load_model_profile as jload
    from distilp_tpu.parallel import make_mesh as jax_mesh
    from distilp_tpu.parallel import solve_sweep_sharded as jax_sweep
    from distilp_tpu.solver.assemble import assemble as jassemble
    from distilp_tpu.solver.backend_jax import _best_bound
    from distilp_tpu.solver.coeffs import assign_sets as jsets
    from distilp_tpu.solver.coeffs import build_coeffs as jcoeffs
    from distilp_tpu.utils import make_synthetic_fleet as jfleet

    from distilp_torch.common import kv_bits_to_factor
    from distilp_torch.solver.assemble import assemble
    from distilp_torch.solver.coeffs import assign_sets, build_coeffs, valid_factors_of_L

    path = profiles_dir / "llama_3_70b" / "online" / "model_profile.json"
    model = load_model_profile(path)
    devs = make_synthetic_fleet(8, seed=123)
    coeffs = build_coeffs(devs, model, kv_bits_to_factor("4bit"), assign_sets(devs))
    kWs = [(k, model.L // k) for k in valid_factors_of_L(model.L) if model.L // k >= 8]
    routes = kernels.SHAPES["bnb_graph"]
    before = sum(c for k, c in routes.items() if k.startswith("route=graph node_mesh"))
    state, _ = solve_sweep_sharded(assemble(coeffs), kWs, coeffs, shard_mesh(4, "cpu"),
                                   mip_gap=GAP)
    assert sum(c for k, c in routes.items() if k.startswith("route=graph node_mesh")) > before
    inc, bd = float(state.incumbent[0]), float(S.best_bound(state)[0])
    assert inc - bd <= GAP * abs(inc) + 1e-12
    jmodel = jload(path)
    jdevs = jfleet(8, seed=123)
    jc = jcoeffs(jdevs, jmodel, jkv("4bit"), jsets(jdevs))
    jstate, _ = jax_sweep(jassemble(jc), kWs, jc, jax_mesh(4), mip_gap=GAP)
    jinc = float(jstate.incumbent)
    assert jinc - float(_best_bound(jstate)) <= GAP * abs(jinc) + 1e-12
    assert inc == pytest.approx(jinc, rel=2 * GAP)
