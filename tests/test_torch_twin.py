"""The port's digital twin (``distilp_torch.twin``) against the JAX package's
(``distilp_tpu.twin``), on the CPU.

- The deterministic parts are the same numpy code on the port's own copies
  of the coefficient builders: ``TwinArrays``, ``placement_vectors``,
  ``simulate_placement``, ``evaluate_placement`` and ``rank_agreement``
  must be equal exactly.
- The Monte-Carlo engine (kernel K8; here its plain version) draws with its
  own Philox stream, not ``jax.random``. So: fed the JAX package's own
  multipliers, the per-row math (``evaluate_rows``) must give every
  latency within 1e-12 relative (sums in another order) and equal
  violation flags on every row; the sensitivity and base rows, which draw
  nothing, must agree within 1e-12 from the port's own draws; and the
  sampled rows must agree in distribution (two-sample KS statistic at most
  0.035, about the 0.1% critical value at n = m = 8192; violation
  probability within 0.015; means within 4 standard errors).
- The torch Philox equals a pure-Python Philox4x32-10 written with Python
  integers (which cannot overflow), including counters and keys near
  2**32 - 1, and Random123's known answer at counter 0, key 0.

Placements come from the port's HiGHS backend, so no JAX solve runs; the
JAX package's solver modules turn on float64 (``jax_enable_x64``), which
its twin engine needs to compute in float64.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("scipy")

# The JAX package's solver turns on float64 when it loads; its twin engine
# computes in float64 only then.
importlib.import_module("distilp_tpu.solver.backend_jax")
from distilp_tpu import twin as jtwin  # noqa: E402
from distilp_tpu.common import load_from_profile_folder as jload  # noqa: E402
from distilp_tpu.common import load_model_profile as jload_model  # noqa: E402
from distilp_tpu.profiler.api import profile_model as jprofile_model  # noqa: E402
from distilp_tpu.solver import HALDAResult as JResult  # noqa: E402
from distilp_tpu.twin import engine as jengine  # noqa: E402
from distilp_tpu.utils import make_synthetic_fleet as jfleet  # noqa: E402

from distilp_torch import kernels, twin  # noqa: E402
from distilp_torch.common import load_from_profile_folder, load_model_profile  # noqa: E402
from distilp_torch.profiler import profile_model  # noqa: E402
from distilp_torch.solver import halda_solve  # noqa: E402
from distilp_torch.solver.backend_cpu import Infeasible  # noqa: E402
from distilp_torch.twin import engine  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402

GOLDEN = ["hermes_70b", "llama_3_70b/4bit", "llama_3_70b/online", "qwen3_32b/bf16"]
MC = dict(sigma_compute=0.08, sigma_comm=0.15, sigma_disk=0.10, sigma_mem=0.05,
          dropout_p=0.05, dropout_slowdown=8.0, degrade=1.25)
TOL = 1e-12


def _instance(name, profiles_dir):
    """(port devs, port model, jax devs, jax model, kv_bits)."""
    if name in GOLDEN:
        return (*load_from_profile_folder(profiles_dir / name),
                *jload(profiles_dir / name), "4bit")
    if name == "north_star":
        path = profiles_dir / "llama_3_70b" / "online" / "model_profile.json"
        return (make_synthetic_fleet(16, seed=123), load_model_profile(path),
                jfleet(16, seed=123), jload_model(path), "4bit")
    config, M, seed, pool = {
        "mixtral_M4": ("tests/configs/mixtral_8x7b.json", 4, 7, 64e9),
        "deepseek_v3_M32": ("tests/configs/deepseek_v3.json", 32, 11, 32e9),
    }[name]
    kw = dict(batch_sizes=[1], sequence_length=128)
    return (make_synthetic_fleet(M, seed=seed, pool_bytes=int(pool)),
            profile_model(config, **kw).to_model_profile(),
            jfleet(M, seed=seed, pool_bytes=int(pool)),
            jprofile_model(config, **kw).to_model_profile(), "8bit")


def _placement(devs, model, kv, **kw):
    """The port's HiGHS placement, and the same as a JAX package result."""
    r = halda_solve(devs, model, mip_gap=1e-6, kv_bits=kv, backend="cpu", **kw)
    return r, JResult.model_validate(r.model_dump())


@pytest.mark.parametrize("name", GOLDEN + ["north_star", "deepseek_v3_M32"])
def test_twin_arrays_equal_the_jax_package(profiles_dir, name):
    devs, model, jdevs, jmodel, kv = _instance(name, profiles_dir)
    a = twin.build_twin_arrays(devs, model, kv_bits=kv)
    b = jtwin.build_twin_arrays(jdevs, jmodel, kv_bits=kv)
    assert vars(a).keys() == vars(b).keys()
    for field, v in vars(a).items():
        w = getattr(b, field)
        if isinstance(v, np.ndarray):
            assert v.dtype == w.dtype and np.array_equal(v, w), field
        else:
            assert v == w, field


@pytest.mark.parametrize("name", ["llama_3_70b/online", "hermes_70b", "north_star",
                                  "mixtral_M4"])
def test_placement_and_simulation_equal_the_jax_package(profiles_dir, name):
    devs, model, jdevs, jmodel, kv = _instance(name, profiles_dir)
    kw = {"k_candidates": [2, 4, 8]} if name == "mixtral_M4" else {}
    r, jr = _placement(devs, model, kv, **kw)
    a = twin.build_twin_arrays(devs, model, kv_bits=kv)
    b = jtwin.build_twin_arrays(jdevs, jmodel, kv_bits=kv)
    va = twin.placement_vectors(a, r.w, r.n, y=r.y, k=r.k)
    vb = jtwin.placement_vectors(b, jr.w, jr.n, y=jr.y, k=jr.k)
    for field, v in vars(va).items():
        assert np.array_equal(v, getattr(vb, field)), field
    assert twin.placement_applicable(a, r.w, r.n, y=r.y, k=r.k)
    assert twin.placement_applicable(a, r.w, r.n, y=r.y, k=r.k) == \
        jtwin.placement_applicable(b, jr.w, jr.n, y=jr.y, k=jr.k)
    ev = twin.evaluate_placement(devs, model, r, kv_bits=kv)
    jev = jtwin.evaluate_placement(jdevs, jmodel, jr, kv_bits=kv)
    assert ev.model_dump() == jev.model_dump()
    assert ev.rel_err < 1e-9 and ev.feasible
    sim = twin.simulate_placement(a, r.w, r.n, y=r.y, k=r.k)
    assert sim.model_dump() == jtwin.simulate_placement(b, jr.w, jr.n, y=jr.y,
                                                         k=jr.k).model_dump()
    assert twin.applicable_candidates(a, [None, r]) == [r]


def _per_k(devs, model, kv):
    out = []
    for k in sorted(k for k in range(1, model.L) if model.L % k == 0):
        try:
            out.append(halda_solve(devs, model, k_candidates=[k], mip_gap=1e-6,
                                   kv_bits=kv, backend="cpu"))
        except Infeasible:  # no feasible placement at this k
            continue
    return out


@pytest.mark.parametrize("name", ["llama_3_70b/online", "hermes_70b"])
def test_rank_agreement_equals_the_jax_package(profiles_dir, name):
    devs, model, jdevs, jmodel, kv = _instance(name, profiles_dir)
    per_k = _per_k(devs, model, kv)
    assert len(per_k) >= 2
    ra = twin.rank_agreement(devs, model, per_k, kv_bits=kv)
    jra = jtwin.rank_agreement(jdevs, jmodel,
                               [JResult.model_validate(r.model_dump()) for r in per_k],
                               kv_bits=kv)
    assert ra == jra
    assert ra["pairwise_inversions"] == 0


def violation_edit(vec):
    """``vec`` with device 0 exactly at a RAM spill cap it has positive
    headroom under, so memory jitter moves rows across the cap (the same
    edit as ``chip_smoke.py``'s twin_mc check)."""
    import copy

    e = copy.deepcopy(vec)
    cap = float(np.floor(e.ram_lhs0[0] / e.bp / 2.0))
    e.s_cap = e.s_cap.copy()
    e.ram_rhs = e.ram_rhs.copy()
    e.s_cap[0] = cap
    e.ram_rhs[0] = e.ram_lhs0[0] - cap * e.bp + 1.0
    return e


@pytest.fixture(scope="module")
def north_star_vectors():
    """(port vectors, jax vectors) of the north star's placement, edited so
    that 0 < P(violation) < 1, and the unedited pair."""
    from pathlib import Path

    profiles = Path(__file__).resolve().parent / "profiles"
    devs, model, jdevs, jmodel, kv = _instance("north_star", profiles)
    r, jr = _placement(devs, model, kv)
    va = twin.placement_vectors(twin.build_twin_arrays(devs, model, kv_bits=kv),
                                r.w, r.n, k=r.k)
    vb = jtwin.placement_vectors(jtwin.build_twin_arrays(jdevs, jmodel, kv_bits=kv),
                                 jr.w, jr.n, k=jr.k)
    return (violation_edit(va), violation_edit(vb)), (va, vb)


def _jax_multipliers(M, samples, seed, mc):
    """The (R, M) multipliers ``distilp_tpu/twin/engine.py::_mc`` evaluates,
    rebuilt with ``jax.random`` exactly as it draws them."""
    import jax.numpy as jnp

    @jax.jit
    def draw(seed):
        key = jax.random.key(seed)
        k_norm, k_drop = jax.random.split(key)
        z = jax.random.normal(k_norm, (4, samples, M))
        sig = jnp.asarray([mc["sigma_compute"], mc["sigma_comm"], mc["sigma_disk"],
                           mc["sigma_mem"]], jnp.float64).reshape(4, 1, 1)
        jit = jnp.exp(sig * z - 0.5 * sig * sig)
        comp, comm, disk, mem = jit[0], jit[1], jit[2], jit[3]
        straggler = jax.random.bernoulli(k_drop, mc["dropout_p"], (samples, M))
        comp = comp * jnp.where(straggler, mc["dropout_slowdown"], 1.0)
        ones_m = jnp.ones((M, M))
        sens = 1.0 + (mc["degrade"] - 1.0) * jnp.eye(M)
        one = jnp.ones((1, M))
        return (jnp.concatenate([comp, sens, one]), jnp.concatenate([comm, sens, one]),
                jnp.concatenate([disk, ones_m, one]), jnp.concatenate([mem, ones_m, one]))

    return [torch.tensor(np.array(x)) for x in draw(np.uint32(seed))]


def _jax_mc(vec, samples, seed, mc):
    out = jengine.run_monte_carlo(vec, samples=samples, seed=seed, **mc)
    lat = np.concatenate([out["latencies"], out["sens_latencies"], [out["base_latency"]]])
    viol = np.concatenate([out["violations"], np.zeros(len(out["sens_latencies"]), bool),
                           [out["base_violation"]]])
    return out, lat, viol


def test_row_math_on_the_jax_draws_matches_every_row(north_star_vectors):
    (va, vb), _ = north_star_vectors
    samples, seed = 512, 3
    out, jlat, jviol = _jax_mc(vb, samples, seed, MC)
    assert 0.0 < out["violations"].mean() < 1.0
    vecs, scalars = engine.pack_vectors(va, "cpu")
    M = vecs.shape[1]
    lat, viol = engine.evaluate_rows(vecs, scalars, *_jax_multipliers(M, samples, seed, MC))
    rel = np.abs(lat.numpy() - jlat) / np.abs(jlat)
    assert rel.max() <= TOL
    # The sensitivity rows carry no flag in the JAX package's return dict.
    assert np.array_equal(viol.numpy()[:samples], jviol[:samples])
    assert bool(viol[-1]) == bool(jviol[-1])


def test_sensitivity_and_base_rows_match_from_own_draws(north_star_vectors):
    for va, vb in north_star_vectors:
        out = twin.run_monte_carlo(va, samples=64, seed=5, device="cpu", **MC)
        jout = jengine.run_monte_carlo(vb, samples=64, seed=5, **MC)
        sens, jsens = out["sens_latencies"], jout["sens_latencies"]
        assert np.abs(sens - jsens).max() <= TOL * np.abs(jsens).max()
        assert abs(out["base_latency"] - jout["base_latency"]) <= TOL * abs(jout["base_latency"])
        assert out["base_violation"] == jout["base_violation"]


def test_samples_agree_with_jax_in_distribution(north_star_vectors):
    from scipy.stats import ks_2samp

    (va, vb), _ = north_star_vectors
    n = 8192
    ours = twin.run_monte_carlo(va, samples=n, seed=11, device="cpu", **MC)
    theirs, _, _ = _jax_mc(vb, n, 11, MC)
    a, b = ours["latencies"], theirs["latencies"]
    assert ks_2samp(a, b).statistic <= 0.035
    pa, pb = ours["violations"].mean(), theirs["violations"].mean()
    assert 0.0 < pa < 1.0 and abs(pa - pb) <= 0.015
    se = np.sqrt(a.var(ddof=1) / n + b.var(ddof=1) / n)
    assert abs(a.mean() - b.mean()) <= 4 * se


def test_port_normals_are_standard():
    mult = engine.draw_multipliers(8192, 16, seed=2, sigmas=(1.0, 1.0, 1.0, 1.0),
                                   dropout_p=0.0, dropout_slowdown=8.0)
    z = torch.cat([torch.log(m).flatten() + 0.5 for m in mult])
    assert z.numel() == 4 * 8192 * 16
    assert abs(float(z.mean())) <= 0.01
    assert abs(float(z.var()) - 1.0) <= 0.02
    # Streams and draws are distinct: no two of the four share a value.
    assert len(set(torch.stack([m[0, 0] for m in mult]).tolist())) == 4


def _py_philox(c, k):
    """Philox4x32-10 on Python integers (Salmon et al., SC'11)."""
    c0, c1, c2, c3 = c
    k0, k1 = k
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & 0xFFFFFFFF
            k1 = (k1 + 0xBB67AE85) & 0xFFFFFFFF
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & 0xFFFFFFFF,
                          (p0 >> 32) ^ c3 ^ k1, p0 & 0xFFFFFFFF)
    return [c0, c1, c2, c3]


@pytest.mark.parametrize("key", [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (12345, 0xFFFFFFFE)])
def test_torch_philox_equals_python_philox(key):
    rng = np.random.default_rng(key[0] % 997)
    ctr = rng.integers(0, 1 << 32, (3000, 4), dtype=np.uint64).astype(np.int64)
    ctr[:8] = (1 << 32) - 1 - np.arange(8)[:, None]
    ctr[8:16] = np.arange(8)[:, None]
    t = torch.as_tensor(ctr)
    got = torch.stack(engine.philox4x32(t[:, 0], t[:, 1], t[:, 2], t[:, 3], *key), 1)
    want = np.array([_py_philox(c, key) for c in ctr.tolist()], dtype=np.int64)
    assert np.array_equal(got.numpy(), want)


def test_philox_known_answer():
    zero = torch.zeros(1, dtype=torch.int64)
    got = [int(x) for x in engine.philox4x32(zero, zero, zero, zero, 0, 0)]
    assert got == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert _py_philox([0, 0, 0, 0], (0, 0)) == got


def test_sigma_zero_gives_multipliers_of_exactly_one():
    mult = engine.draw_multipliers(256, 8, seed=9, sigmas=(0.0, 0.0, 0.0, 0.0),
                                   dropout_p=0.0, dropout_slowdown=8.0)
    for m in mult:
        assert torch.equal(m, torch.ones_like(m))
    u = engine.uniform53(torch.tensor([0, 0xFFFFFFFF]), torch.tensor([0, 0xFFFFFFFF]))
    assert float(u[0]) > 0.0 and float(u[1]) == 1.0


def test_same_seed_same_report_other_seed_differs(profiles_dir):
    devs, model = load_from_profile_folder(profiles_dir / "llama_3_70b" / "online")
    r = halda_solve(devs, model, mip_gap=1e-6, kv_bits="4bit", backend="cpu")
    kw = dict(samples=256, kv_bits="4bit", device="cpu", dropout_p=0.05)
    kernels.reset_launch_counts()
    a = twin.robustness_report(devs, model, r, seed=1, **kw)
    b = twin.robustness_report(devs, model, r, seed=1, **kw)
    c = twin.robustness_report(devs, model, r, seed=2, **kw)
    assert a.model_dump() == b.model_dump()
    assert a.p95_s != c.p95_s and a.base_latency_s == c.base_latency_s
    assert kernels.LAUNCHES["twin_mc"] == 0  # CPU tensors take the plain version
    # The report crosses packages: the JAX package's schema reads it back.
    from distilp_tpu.twin import RobustnessReport as JReport

    assert JReport.model_validate(a.model_dump()).model_dump() == a.model_dump()
    score = twin.twin_p95_score(devs, model, r, samples=256, kv_bits="4bit", device="cpu")
    jscore_keys = {"score", "p95_s", "p_violation", "base_latency_s"}
    assert set(score) == jscore_keys and score["score"] == score["p95_s"]


def test_run_monte_carlo_needs_a_gpu_by_default(north_star_vectors, monkeypatch):
    _, (va, _) = north_star_vectors
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        twin.run_monte_carlo(va, samples=8)
    with pytest.raises(ValueError, match="samples"):
        twin.run_monte_carlo(va, samples=0, device="cpu")
