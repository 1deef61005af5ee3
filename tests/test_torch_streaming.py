"""The port's ``StreamingReplanner`` on ``device='cpu'`` (mirrors the JAX
package's ``tests/test_streaming.py`` and ``tests/test_warm_start.py``):
warm ticks equal cold solves within the gap, pipelined ticks equal
sequential ones, search overrides reach every tick, and a warm-state blob
written by either package loads in the other, the next tick equal to the
uninterrupted one.
"""

import copy
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from distilp_torch.common import load_from_profile_folder  # noqa: E402
from distilp_torch.profiler import profile_model  # noqa: E402
from distilp_torch.solver import StreamingReplanner, halda_solve  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402

GAP = 1e-3


@pytest.fixture(scope="module")
def fleet_and_model():
    _, model = load_from_profile_folder("tests/profiles/llama_3_70b/online")
    return make_synthetic_fleet(6, seed=11), model


def _close(a, b, gap=GAP):
    return abs(a - b) <= 2 * gap * abs(b) + 1e-9


def _planner(**kw):
    return StreamingReplanner(mip_gap=GAP, kv_bits="4bit", device="cpu", **kw)


def test_warm_ticks_match_cold_under_drift(fleet_and_model):
    devs, model = fleet_and_model
    devs = [copy.deepcopy(d) for d in devs]
    planner = _planner()
    first = planner.step(devs, model)
    assert planner.last is first and planner.last_tick_mode == "cold"
    rng = np.random.default_rng(7)
    for _ in range(2):
        for d in devs:
            d.t_comm = max(0.0, d.t_comm * float(rng.uniform(0.95, 1.05)))
        warm = planner.step(devs, model)
        assert planner.last_tick_mode == "warm" and warm.certified
    cold = halda_solve(devs, model, kv_bits="4bit", mip_gap=GAP, device="cpu")
    assert _close(warm.obj_value, cold.obj_value)
    # A fleet that shrinks changes shape: the tick solves cold.
    third = planner.step(devs[:4], model)
    assert planner.last_tick_mode == "cold" and len(third.w) == 4


def test_pipelined_ticks_equal_sequential(fleet_and_model):
    """submit/collect with one tick in flight gives the ticks that step()
    gives when each is seeded by the same (one tick stale) result."""
    devs, model = fleet_and_model
    rng = np.random.default_rng(9)
    fleets = [[copy.deepcopy(d) for d in devs]]
    for _ in range(3):
        nxt = [copy.deepcopy(d) for d in fleets[-1]]
        for d in nxt:
            d.t_comm = max(0.0, d.t_comm * float(rng.uniform(0.9, 1.1)))
        fleets.append(nxt)
    piped = _planner()
    piped.submit(fleets[0], model)
    got = []
    for f in fleets[1:]:
        piped.submit(f, model)
        got.append(piped.collect())
    got.append(piped.collect())
    # The pipeline seeds tick t+1 with tick t-1's result: replay that.
    seq = [halda_solve(fleets[0], model, kv_bits="4bit", mip_gap=GAP, device="cpu")]
    seq.append(halda_solve(fleets[1], model, kv_bits="4bit", mip_gap=GAP, device="cpu"))
    for t in range(2, len(fleets)):
        seq.append(halda_solve(fleets[t], model, kv_bits="4bit", mip_gap=GAP, device="cpu",
                               warm=seq[t - 2]))
    for a, b in zip(got, seq):
        assert a.certified
        assert (a.k, a.w, a.n, a.obj_value) == (b.k, b.w, b.n, b.obj_value)
    with pytest.raises(RuntimeError, match="in-flight"):
        piped.collect()
    with pytest.raises(RuntimeError, match="torch"):
        StreamingReplanner(backend="cpu").submit([], None)


def test_search_overrides_apply_to_every_tick(fleet_and_model, monkeypatch):
    import distilp_torch.solver.streaming as streaming_mod

    devs, model = fleet_and_model
    captured = []
    real = streaming_mod.halda_solve

    def spy(*args, **kwargs):
        captured.append({k: kwargs.get(k) for k in ("beam", "ipm_iters", "device")})
        return real(*args, **kwargs)

    monkeypatch.setattr(streaming_mod, "halda_solve", spy)
    planner = _planner(search={"beam": 6, "ipm_iters": 8})
    planner.step(devs, model)
    planner.step(devs, model)
    assert len(captured) >= 2
    assert all(c == {"beam": 6, "ipm_iters": 8, "device": "cpu"} for c in captured)
    with pytest.raises(ValueError, match="unknown search override"):
        StreamingReplanner(search={"beams": 8})
    planner = _planner(diagnostics=True)
    planner.step(devs, model)
    assert planner.last_convergence["round_log"]


def _small():
    from distilp_tpu.profiler.api import profile_model as jprofile
    from distilp_tpu.utils import make_synthetic_fleet as jfleet

    cfg = "tests/configs/llama31_8b_4bit.json"
    model = profile_model(cfg, batch_sizes=[1], sequence_length=128).to_model_profile()
    jm = jprofile(cfg, batch_sizes=[1], sequence_length=128).to_model_profile()
    return make_synthetic_fleet(4, seed=11), model, jfleet(4, seed=11), jm


def _drift(devs, f):
    for d in devs:
        d.t_comm *= f


def test_warm_blobs_cross_between_packages():
    """A JAX-package blob restores into the port and a port blob into the
    JAX package; each restored replanner's next tick is a warm tick equal
    to the uninterrupted replanner's of the same package. A port blob also
    round-trips through the port bit for bit."""
    from distilp_tpu.solver import StreamingReplanner as JPlanner

    devs, model, jdevs, jm = _small()
    ks = [4, 8]
    p, jp = _planner(), JPlanner(mip_gap=GAP, kv_bits="4bit", backend="jax")
    for f in (1.0, 1.02):
        _drift(devs, f)
        _drift(jdevs, f)
        p.step(devs, model, k_candidates=ks)
        jp.step(jdevs, jm, k_candidates=ks)
    port_blob = json.loads(json.dumps(p.dump_warm_state()))
    jax_blob = json.loads(json.dumps(jp.dump_warm_state()))

    q = _planner()
    q.load_warm_state(port_blob)
    assert q.dump_warm_state() == port_blob
    from_jax = _planner()
    from_jax.load_warm_state(jax_blob)
    to_jax = JPlanner(mip_gap=GAP, kv_bits="4bit", backend="jax")
    to_jax.load_warm_state(port_blob)
    for key, arr in jp.last.ipm_state.items():
        assert np.array_equal(np.asarray(arr), from_jax.last.ipm_state[key])

    _drift(devs, 0.97)
    _drift(jdevs, 0.97)
    r_p = p.step(devs, model, k_candidates=ks)
    r_q = q.step(devs, model, k_candidates=ks)
    r_fj = from_jax.step(devs, model, k_candidates=ks)
    r_jp = jp.step(jdevs, jm, k_candidates=ks)
    r_tj = to_jax.step(jdevs, jm, k_candidates=ks)
    assert {x.last_tick_mode for x in (p, q, from_jax, jp, to_jax)} == {"warm"}
    key = lambda r: (r.k, r.w, r.n, r.obj_value)  # noqa: E731
    assert key(r_q) == key(r_p)
    # Across packages: the same placement, the objective within float
    # rounding of the other's.
    assert (r_fj.k, r_fj.w, r_fj.n) == (r_p.k, r_p.w, r_p.n)
    assert (r_tj.k, r_tj.w, r_tj.n) == (r_jp.k, r_jp.w, r_jp.n)
    assert r_fj.obj_value == pytest.approx(r_p.obj_value, rel=1e-9)
    assert r_tj.obj_value == pytest.approx(r_jp.obj_value, rel=1e-9)


def test_moe_margin_anchor_crosses_from_the_jax_package():
    """A JAX-package MoE replanner's blob carries its margin anchor (rounding
    data, y-profile, multipliers) into the port: the restored tick rides the
    margin path, certified, with the port's own uninterrupted replanner's
    placement."""
    from distilp_tpu.profiler.api import profile_model as jprofile
    from distilp_tpu.solver import StreamingReplanner as JPlanner
    from distilp_tpu.utils import make_synthetic_fleet as jfleet

    cfg = "tests/configs/mixtral_8x7b.json"
    model = profile_model(cfg, batch_sizes=[1], sequence_length=128).to_model_profile()
    jm = jprofile(cfg, batch_sizes=[1], sequence_length=128).to_model_profile()
    devs = make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9))
    jdevs = jfleet(4, seed=7, pool_bytes=int(64e9))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = JPlanner(mip_gap=GAP, kv_bits="8bit", backend="jax")
        jp.step(jdevs, jm)
        p = StreamingReplanner(mip_gap=GAP, kv_bits="8bit", device="cpu")
        p.step(devs, model)
        q = StreamingReplanner(mip_gap=GAP, kv_bits="8bit", device="cpu")
        q.load_warm_state(json.loads(json.dumps(jp.dump_warm_state())))
        devs[2].t_comm *= 1.02
        r_p = p.step(devs, model)
        r_q = q.step(devs, model)
    assert p.last_tick_mode == "margin" == q.last_tick_mode
    assert r_p.certified and r_q.certified
    assert sum(r_q.y) == model.n_routed_experts
    assert (r_q.k, r_q.w, r_q.n, r_q.y) == (r_p.k, r_p.w, r_p.n, r_p.y)
    assert _close(r_q.obj_value, r_p.obj_value)
