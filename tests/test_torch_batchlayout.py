"""The port's batch layout (``solver.batchlayout``) on the CPU: instances
that each keep their own A searched as the lanes of one batch.

Mirrors the JAX package's ``tests/test_combine.py``: the golden fixtures
padded to their bucket boundary (at the reference's k, w, n and the golden
objective), a mixed-M bucket with per-lane certificates, ``lane_pad``
duplicates, the per-lane static cache and the warm round trip through a
batched tick; plus the refusal of mixed signatures and lanes on the PDHG
engine (K5's per-element entry).
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from distilp_torch.common import load_from_profile_folder, load_model_profile  # noqa: E402
from distilp_torch.solver import StreamingReplanner, halda_solve  # noqa: E402
from distilp_torch.solver.api import _best_to_result, _build_instance  # noqa: E402
from distilp_torch.solver.batchlayout import (  # noqa: E402
    clear_lane_static_cache,
    pack_instance,
    solve_batch,
)
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module: the plain PDHG's and IPM's many
    small batched products each open a parallel region, which with several
    test processes on few cores costs far more than the product."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

GOLDEN = [
    ("hermes_70b", 40, 29.643569),
    ("llama_3_70b/4bit", 8, 12.834690),
    ("llama_3_70b/online", 2, 1.934942),
    ("qwen3_32b/bf16", 16, 12.072837),
]
GAP = 1e-3


def _pack(devs, model, mip_gap, M_pad=None, warm=None, k_candidates=None, **kw):
    Ks, sets, coeffs, arrays = _build_instance(devs, model, k_candidates, "4bit", False,
                                               None, 1)
    inst = pack_instance(arrays, [(k, model.L // k) for k in Ks], mip_gap=mip_gap,
                         coeffs=coeffs, warm=warm, M_pad=M_pad, **kw)
    return inst, sets


def _online(profiles_dir):
    return load_model_profile(profiles_dir / "llama_3_70b" / "online" / "model_profile.json")


def _quiet(fn, *a, **k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **k)


@pytest.mark.parametrize("folder,k_star,obj", GOLDEN)
def test_golden_in_a_padded_bucket(profiles_dir, folder, k_star, obj):
    """A golden fixture padded to its bucket boundary and solved as a lane:
    the golden k and objective, certified, decoded to its own width, and
    the reference's own batch-layout (k, w, n)."""
    from distilp_tpu.combine import BucketPolicy
    from distilp_tpu.common import load_from_profile_folder as jload
    from distilp_tpu.solver.api import _build_instance as jbuild
    from distilp_tpu.solver.batchlayout import pack_instance as jpack
    from distilp_tpu.solver.batchlayout import solve_batch as jsolve

    devs, model = load_from_profile_folder(profiles_dir / folder)
    M_pad = BucketPolicy().pad_for(len(devs))
    inst, sets = _pack(devs, model, 1e-4, M_pad=M_pad)
    assert inst.M_pad >= inst.M_real == len(devs)
    (_, best), = _quiet(solve_batch, [inst], device="cpu")
    result = _best_to_result(best, sets)
    assert result.k == k_star and result.certified
    assert result.obj_value == pytest.approx(obj, rel=2e-4)
    assert len(result.w) == len(devs) and sum(result.w) * result.k == model.L

    jdevs, jm = jload(profiles_dir / folder)
    Ks, _, jc, ja = jbuild(jdevs, jm, None, "4bit", False, None, 1)
    jinst = jpack(ja, [(k, jm.L // k) for k in Ks], mip_gap=1e-4, coeffs=jc, M_pad=M_pad)
    (_, jbest), = _quiet(jsolve, [jinst])
    assert (best.k, best.w, best.n) == (jbest.k, jbest.w, jbest.n)


def test_mixed_m_bucket_certifies_each_lane(profiles_dir):
    """Fleets of 4, 6 and 8 devices padded to 8: one signature, one search,
    each lane decoded to its own width with its own certificate, within 2x
    gap of its own single solve."""
    model = _online(profiles_dir)
    ks = [8, 10]
    fleets = [make_synthetic_fleet(M, seed=s) for M, s in [(4, 4), (6, 7), (8, 8)]]
    packed = [_pack(devs, model, GAP, M_pad=8, k_candidates=ks) for devs in fleets]
    insts = [inst for inst, _ in packed]
    assert len({inst.signature for inst in insts}) == 1
    tm = {}
    decoded = _quiet(solve_batch, insts, timings=tm, device="cpu")
    assert tm["batch_size"] == 3
    for devs, inst, (per_k, best) in zip(fleets, insts, decoded):
        assert best is not None and best.certified and best.gap <= GAP
        assert len(best.w) == inst.M_real == len(devs)
        assert sum(best.w) * best.k == model.L
        assert len(per_k) == len(inst.kWs)
        ref = _quiet(halda_solve, devs, model, mip_gap=GAP, kv_bits="4bit", k_candidates=ks,
                     device="cpu")
        assert best.obj_value == pytest.approx(ref.obj_value, rel=2 * GAP)


def test_lane_pad_duplicates_and_static_cache(profiles_dir):
    """``lane_pad`` repeats the last instance without changing any real
    lane's decode; the per-lane static cache serves a repeat and a
    reordered flush without an upload; a ``lane_pad`` below the batch size
    raises before any work."""
    model = _online(profiles_dir)
    insts = [_pack(make_synthetic_fleet(4, seed=s), model, GAP, M_pad=4, k_candidates=[8, 10])[0]
             for s in (1, 2, 3)]
    clear_lane_static_cache()
    tm1, tm2, tm3 = {}, {}, {}
    plain = _quiet(solve_batch, insts, timings=tm1, device="cpu")
    padded = _quiet(solve_batch, insts, timings=tm2, lane_pad=4, device="cpu")
    rev = _quiet(solve_batch, list(reversed(insts)), timings=tm3, lane_pad=4, device="cpu")
    assert tm1["static_hit"] == 0.0 and tm2["lanes"] == 4
    assert tm2["static_hit"] == 1.0 and tm3["static_hit"] == 1.0
    assert len(plain) == len(padded) == 3
    for (_, a), (_, b), (_, c) in zip(plain, padded, reversed(rev)):
        assert a.obj_value == b.obj_value == c.obj_value
        assert a.w == b.w == c.w and a.n == b.n and a.k == b.k
    with pytest.raises(ValueError, match="lane_pad"):
        solve_batch(insts, lane_pad=2, device="cpu")


def test_mixed_signatures_and_pdhg_lanes_are_refused(profiles_dir):
    model = _online(profiles_dir)
    a, _ = _pack(make_synthetic_fleet(4, seed=1), model, GAP, M_pad=4, k_candidates=[8, 10])
    b, _ = _pack(make_synthetic_fleet(4, seed=2), model, GAP, M_pad=8, k_candidates=[8, 10])
    with pytest.raises(ValueError, match="signature"):
        solve_batch([a, b], device="cpu")
    # Lanes with an A each on the PDHG engine run K5's per-element entry:
    # each lane ends where its own single-lane batch ends (the frozen-lane
    # rule). A single lane takes the shared-A route, so the LP bounds, and
    # with them the gap, differ in summation order only (float64 iterates:
    # no float32 restart decision can flip between the two routes).
    lanes = [_pack(make_synthetic_fleet(4, seed=s), model, GAP, lp_backend="pdhg",
                   pdhg_dtype="f64", k_candidates=[8, 10])[0] for s in (1, 2)]
    tm = {}
    out = _quiet(solve_batch, lanes, timings=tm, device="cpu")
    assert tm["lp_backend"] == "pdhg"
    for inst, (_, best) in zip(lanes, out):
        (_, own), = _quiet(solve_batch, [inst], device="cpu")
        assert (best.k, best.w, best.n, best.obj_value, best.certified) == \
            (own.k, own.w, own.n, own.obj_value, own.certified)
        assert abs(best.gap - own.gap) <= 1e-9


def test_warm_roundtrip_through_a_batched_tick(profiles_dir):
    """A replanner whose warm state came from an adopted batched lane
    round-trips its blob bit for bit, and the restored replanner packs the
    identical next instance."""
    model = _online(profiles_dir)
    devs = make_synthetic_fleet(5, seed=3)
    planner = StreamingReplanner(mip_gap=GAP, kv_bits="4bit", device="cpu")
    _quiet(planner.step, devs, model)
    devs[2].t_comm *= 1.05
    prep = planner.prepare(devs, model, M_pad=8)
    assert prep is not None and prep.warm_used
    result = _quiet(planner.adopt, prep, solve_batch([prep.instance], device="cpu")[0])
    assert result.certified and planner.last is result
    blob = planner.dump_warm_state()
    restored = StreamingReplanner(mip_gap=GAP, kv_bits="4bit", device="cpu")
    restored.load_warm_state(blob)
    assert restored.dump_warm_state() == blob
    a = planner.prepare(devs, model, M_pad=8).instance
    b = restored.prepare(devs, model, M_pad=8).instance
    assert a.signature == b.signature
    assert np.array_equal(a.static_np, b.static_np)
    for x, y in zip(a.lane.warm_tuple, b.lane.warm_tuple):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    for x, y in zip(a.lane.root_warm_tuple, b.lane.root_warm_tuple):
        assert np.array_equal(x, y)
