"""The port's cross-shard combiner (``distilp_torch/combine``), its shard
router and its memory model against the JAX package's, on the CPU.

- Exact: the consistent-hash owners of 200 shard keys at 1-5 workers and
  the churn when a worker is added; ``BucketPolicy``'s ``pad_for``,
  ``lane_cap`` (with and without a budget), ``quantize_lanes`` and
  ``lane_shapes``, and every ``ops.memmodel`` function, for M from 1 to
  4096 and both engines.
- The port's copies of the reference's policy contract and of its combiner
  thread test (bucketing by signature, exactly-once delivery, drain on
  stop, post-stop fail-fast) with a stub solver.
- A 3-lane mixed-M bucket (fleets of 4, 6 and 8 devices padded to 8) solved
  by both packages' ``solve_batch``: (k, w, n) equal, objectives within the
  gap; the north star (16 devices, seed 123) as one combined lane within 2x
  gap of the port's own one-shot solve.
- The reference's gateway contract for combined ticks on the port: after
  ``warm_combine`` a coalesced drift burst over 4 fleets rides combined
  lanes (no per-shard fallback, no dispatch error), builds no new graph
  plan, and ends on the (k, w, n) a combine-off gateway serves for the same
  events, each final placement certified and within 2x gap of a one-shot
  solve on its final fleet.

~20 s in one process.
"""

import asyncio
import threading
import warnings

import pytest

torch = pytest.importorskip("torch")

from distilp_tpu.combine import BucketPolicy as JBucketPolicy  # noqa: E402
from distilp_tpu.gateway.router import ConsistentHashRouter as JRouter  # noqa: E402
from distilp_tpu.ops import memmodel as jmem  # noqa: E402

from distilp_torch.combine import BucketPolicy, CombineEntry, SolveCombiner  # noqa: E402
from distilp_torch.common import load_model_profile  # noqa: E402
from distilp_torch.gateway import Gateway, shard_key  # noqa: E402
from distilp_torch.gateway.router import ConsistentHashRouter  # noqa: E402
from distilp_torch.ops import memmodel  # noqa: E402
from distilp_torch.solver import device_loop, halda_solve  # noqa: E402
from distilp_torch.solver.api import _build_instance  # noqa: E402
from distilp_torch.solver.batchlayout import pack_instance, solve_batch  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402

GAP = 1e-3
KS = [8, 10]
ONLINE = "tests/profiles/llama_3_70b/online/model_profile.json"
SIZES = list(range(1, 130)) + [200, 255, 256, 511, 512, 1000, 1024, 2048, 4095, 4096]


@pytest.fixture(scope="module")
def model():
    return load_model_profile(ONLINE)


def _quiet(fn, *a, **k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **k)


def _pack(devs, model, M_pad=None, k_candidates=KS):
    Ks, sets, coeffs, arrays = _build_instance(devs, model, k_candidates, "4bit", False,
                                               None, 1)
    inst = pack_instance(arrays, [(k, model.L // k) for k in Ks], mip_gap=GAP,
                         coeffs=coeffs, M_pad=M_pad)
    return inst, sets


@pytest.mark.parametrize("n_workers", [1, 2, 3, 4, 5])
def test_router_owners_and_churn_equal_the_reference(n_workers):
    keys = [shard_key(f"f{i:03d}", "m" if i % 3 else "default") for i in range(200)]
    ours, theirs = ConsistentHashRouter(n_workers), JRouter(n_workers)
    assert ours.assignments(keys) == theirs.assignments(keys)
    assert ours.load(keys) == theirs.load(keys)
    grown, jgrown = ConsistentHashRouter(n_workers + 1), JRouter(n_workers + 1)
    moved = [k for k in keys if grown.owner(k) != ours.owner(k)]
    assert moved == [k for k in keys if jgrown.owner(k) != theirs.owner(k)]
    # Consistent hashing: only keys that land on the new worker move.
    assert all(grown.owner(k) == n_workers for k in moved)
    sparse = ConsistentHashRouter(worker_ids=[w for w in range(n_workers + 1) if w != 1])
    jsparse = JRouter(worker_ids=[w for w in range(n_workers + 1) if w != 1])
    assert sparse.assignments(keys) == jsparse.assignments(keys)


@pytest.mark.parametrize("engine", ["ipm", "pdhg"])
def test_bucket_policy_and_memmodel_equal_the_reference(engine):
    for M in SIZES:
        assert memmodel.standard_form_dims(M) == jmem.standard_form_dims(M)
        assert memmodel.peak_bytes(M, engine) == jmem.peak_bytes(M, engine)
        assert memmodel.peak_gb(M, engine) == jmem.peak_gb(M, engine)
        for beam in (1, 6):
            assert memmodel.ipm_peak_bytes(M, beam) == jmem.ipm_peak_bytes(M, beam)
            assert memmodel.ipm_memory_infeasible(M, 5.0, beam) == \
                jmem.ipm_memory_infeasible(M, 5.0, beam)
        for db in (memmodel.F32_BYTES, memmodel.F64_BYTES):
            assert memmodel.pdhg_peak_bytes(M, db) == jmem.pdhg_peak_bytes(M, db)
            for shards in (1, 3, 8):
                assert memmodel.pdhg_shard_peak_bytes(M, shards, db) == \
                    jmem.pdhg_shard_peak_bytes(M, shards, db)
            for budget in (10**6, 10**9):
                assert memmodel.choose_mesh_shards(M, budget, 8, db) == \
                    jmem.choose_mesh_shards(M, budget, 8, db)
    for knob in (None, "f32", "f64"):
        assert memmodel.dtype_bytes_of(knob) == jmem.dtype_bytes_of(knob)
    budgets = (None, 3 * memmodel.peak_bytes(16, engine), 10**9, 10**12)
    for budget in budgets:
        kw = dict(mem_budget_bytes=budget, engine=engine)
        ours, theirs = BucketPolicy(**kw), JBucketPolicy(**kw)
        for M in SIZES:
            M_pad = ours.pad_for(M)
            assert M_pad == theirs.pad_for(M)
            assert ours.lane_cap(M_pad) == theirs.lane_cap(M_pad)
            assert ours.lane_shapes(M_pad) == theirs.lane_shapes(M_pad)
            for n in (1, 2, 3, 5, 9, 16, 17):
                assert ours.quantize_lanes(n, M_pad) == theirs.quantize_lanes(n, M_pad)


def test_bucket_policy_contract():
    """The port's copy of the reference's contract test."""
    p = BucketPolicy()
    assert p.pad_for(1) == 2 and p.pad_for(5) == 8 and p.pad_for(128) == 128
    assert p.pad_for(200) == 200  # above the top boundary: exact M
    with pytest.raises(ValueError):
        p.pad_for(0)
    assert [p.quantize_lanes(n, 8) for n in (1, 3, 5, 16)] == [1, 4, 8, 16]
    assert p.lane_shapes(8) == (1, 2, 4, 8, 16)
    tight = BucketPolicy(mem_budget_bytes=3 * memmodel.peak_bytes(16, "ipm"))
    assert tight.lane_cap(16) == 3 and tight.lane_cap(128) == 1
    assert tight.quantize_lanes(2, 16) == 2 and tight.quantize_lanes(3, 16) == 3
    assert tight.lane_shapes(16) == (1, 2, 3)
    for bad in (dict(boundaries=(4, 2)), dict(max_batch=0), dict(max_wait_ms=-1.0)):
        with pytest.raises(ValueError):
            BucketPolicy(**bad)


class _Ticket:
    """The combiner only dereferences ``ticket.prep.instance``."""

    def __init__(self, inst):
        self.prep = type("P", (), {"instance": inst})()


def test_combiner_thread_semantics_with_stub_solver(model, monkeypatch):
    from distilp_torch.solver import batchlayout as bl

    insts = [_pack(make_synthetic_fleet(4, seed=4), model, M_pad=8)[0],
             _pack(make_synthetic_fleet(6, seed=7), model, M_pad=8)[0],
             _pack(make_synthetic_fleet(4, seed=4), model, M_pad=4)[0]]
    assert insts[0].signature == insts[1].signature != insts[2].signature
    calls = []

    def stub_solve_batch(batch, timings=None, lane_pad=None, device=None):
        calls.append((len(batch), lane_pad, str(device)))
        assert len({i.signature for i in batch}) == 1, "a flush mixed signatures"
        if timings is not None:
            timings.update(batch_size=len(batch), static_hit=1.0)
        return [("stub", None) for _ in batch]

    # _flush imports solve_batch from the module at call time.
    monkeypatch.setattr(bl, "solve_batch", stub_solve_batch)
    got, done = {}, threading.Event()

    def deliver(i):
        def _d(decoded, err):
            got[i] = (decoded, err)
            if len(got) == 3:
                done.set()
        return _d

    combiner = SolveCombiner(BucketPolicy(max_wait_ms=20.0), device="cpu")
    try:
        for i, inst in enumerate(insts):
            combiner.submit(CombineEntry(_Ticket(inst), deliver(i)))
        assert done.wait(timeout=60.0), f"undelivered: {set(got)}"
    finally:
        combiner.stop()
    assert all(got[i] == (("stub", None), None) for i in range(3))
    snap = combiner.snapshot()
    assert snap["instances"] == 3 and snap["batches"] == len(calls) == 2
    assert sorted(calls) == [(1, 1, "cpu"), (2, 2, "cpu")]  # the shared pair rode together
    assert snap["pending"] == 0 and snap["errors"] == 0
    late = {}
    combiner.submit(CombineEntry(_Ticket(insts[0]), lambda d, e: late.update(err=e)))
    assert isinstance(late.get("err"), RuntimeError)


def test_mixed_m_bucket_equals_the_reference(model):
    from distilp_tpu.common import load_model_profile as jload_model
    from distilp_tpu.solver.api import _build_instance as jbuild
    from distilp_tpu.solver.batchlayout import pack_instance as jpack
    from distilp_tpu.solver.batchlayout import solve_batch as jsolve
    from distilp_tpu.utils import make_synthetic_fleet as jfleet

    jm = jload_model(ONLINE)
    shapes = [(4, 4), (6, 7), (8, 8)]
    insts = [_pack(make_synthetic_fleet(M, seed=s), model, M_pad=8)[0] for M, s in shapes]
    jinsts = []
    for M, s in shapes:
        Ks, _, jc, ja = jbuild(jfleet(M, seed=s), jm, KS, "4bit", False, None, 1)
        jinsts.append(jpack(ja, [(k, jm.L // k) for k in Ks], mip_gap=GAP, coeffs=jc,
                            M_pad=8))
    decoded = _quiet(solve_batch, insts, lane_pad=4, device="cpu")
    jdecoded = _quiet(jsolve, jinsts, lane_pad=4)
    for (M, _), (_, best), (_, jbest) in zip(shapes, decoded, jdecoded):
        assert best.certified and jbest.certified and len(best.w) == M
        assert (best.k, best.w, best.n) == (jbest.k, jbest.w, jbest.n)
        assert abs(best.obj_value - jbest.obj_value) <= GAP * abs(jbest.obj_value)


def test_combined_north_star_matches_a_one_shot_solve(model):
    from distilp_torch.solver.api import _best_to_result

    devs = make_synthetic_fleet(16, seed=123)
    ref = _quiet(halda_solve, devs, model, mip_gap=GAP, kv_bits="4bit", device="cpu")
    inst, sets = _pack(devs, model, M_pad=16, k_candidates=None)
    result = _best_to_result(_quiet(solve_batch, [inst], device="cpu")[0][1], sets)
    assert result.certified and result.gap is not None and result.gap <= GAP
    assert result.obj_value == pytest.approx(ref.obj_value, rel=2 * GAP)
    assert sum(result.w) * result.k == model.L


FLEETS = {f"c{i}": (M, s) for i, (M, s) in enumerate([(4, 31), (6, 32), (5, 33), (6, 34)])}


def _drift(fleet, j):
    from distilp_torch.sched import DeviceDegrade

    names = [d.name for d in _fleet(fleet)]
    return DeviceDegrade(name=names[(3 * j + 1) % len(names)],
                         t_comm_scale=1.0 + 0.04 * (j + 1))


def _fleet(fleet):
    M, seed = FLEETS[fleet]
    return make_synthetic_fleet(M, seed=seed)


def _run_gateway(model, combine: bool):
    gw = Gateway(n_workers=2, device="cpu",
                 scheduler_kwargs=dict(mip_gap=GAP, kv_bits="4bit", k_candidates=KS))
    try:
        for f in FLEETS:
            gw.register_fleet(f, _fleet(f), model)
        for j in range(2):  # per-shard warm-up: a cold tick, then a warm one
            for f in FLEETS:
                gw.handle_event(f, _drift(f, j))
        warm = None
        gw.configure_admission(coalesce=True, combine=combine,
                               combine_policy=BucketPolicy(max_wait_ms=200.0)
                               if combine else None)
        if combine:
            warm = gw.warm_combine()
        built = sum(device_loop.PLANS_BUILT.values())

        async def burst(js):
            await asyncio.gather(*[gw.handle_event_async(f, _drift(f, j))
                                   for j in js for f in FLEETS])

        asyncio.run(burst(range(2, 7)))
        asyncio.run(burst(range(7, 10)))
        new_plans = sum(device_loop.PLANS_BUILT.values()) - built
        finals = {f: gw.latest(f) for f in FLEETS}
        devs = {f: gw.read_shard(f, lambda s: s.fleet.device_list()) for f in FLEETS}
        snap = gw.metrics_snapshot()
        return finals, devs, snap, warm, new_plans
    finally:
        gw.close()


def test_combined_lanes_match_per_shard_ticks(model):
    finals, devs, snap, warm, new_plans = _run_gateway(model, combine=True)
    plain, _, psnap, _, _ = _run_gateway(model, combine=False)
    totals, c = snap["shard_totals"], snap["counters"]
    assert warm["buckets"] >= 1 and warm["shapes_traced"] >= 5 and warm["captures"] == 0
    assert new_plans == 0, "a graph plan was built after warm_combine"
    assert totals["combine_prepared"] >= 2 * len(FLEETS)
    assert totals.get("combine_local", 0) == totals.get("combine_fallback", 0) == 0
    assert c.get("combine_dispatch_error", 0) == 0 and c["combine_instances"] >= 2 * len(FLEETS)
    assert c["combine_batches"] < c["combine_instances"]  # lanes shared dispatches
    assert psnap["shard_totals"].get("combine_prepared", 0) == 0
    for f in FLEETS:
        v, p = finals[f].result, plain[f].result
        assert finals[f].mode == "combine" and v.certified
        assert (v.k, v.w, v.n) == (p.k, p.w, p.n), f
        ref = _quiet(halda_solve, devs[f], model, mip_gap=GAP, kv_bits="4bit",
                     k_candidates=KS, device="cpu")
        assert v.obj_value == pytest.approx(ref.obj_value, rel=2 * GAP)
