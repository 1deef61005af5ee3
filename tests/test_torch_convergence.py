"""The port's convergence telemetry (the traces of kernels K1 and K5, the
branch-and-bound round log, ``distilp_torch.obs.convergence`` and the
``diagnose`` CLI) on the CPU path, against the JAX package.

Mirrors ``tests/test_convergence.py`` case by case, each held against the
JAX package where it has a counterpart:

- tracing never steers: the traced solve's fields equal the untraced
  solve's bit for bit, on both engines;
- exact accounting: each element's live rows carry strictly increasing
  cumulative iterations ending at ``iters_run``; the round log's LP
  iterations sum to the header counter;
- ``trace_buf`` against the JAX package's on the same float64 batch: the
  iters, restarts and live columns equal, rp/rd/gap within the engine's
  float64 parity tolerance (IPM 1e-8, PDHG 1e-5, relative to max(1,
  |ref|), as ``tests/test_torch_ipm.py`` and ``tests/test_torch_pdhg.py``
  hold the fields they come from);
- ``halda_solve(convergence=...)`` fills the JAX package's keys, and on
  ``llama_3_70b/online`` its round log's expanded and live columns equal
  the JAX package's (gap 1e-3, both engines), the search taking the loop's
  plan (its route ``+log``);
- the report layer is the JAX package's: the same JSONL from the same
  dict, and an export loads in either package.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from distilp_torch.obs.convergence import (  # noqa: E402
    CONV_DIGEST_KEYS,
    build_search_trace,
    search_trace_from_jsonl,
    search_trace_to_jsonl,
)
from distilp_torch.ops import LPBatch, ipm_solve_batch, pdhg_solve_batch  # noqa: E402
from distilp_torch.ops.ipm import TRACE_COLS  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module: the plain PDHG's and IPM's many
    small batched products each open a parallel region, which with several
    test processes on few cores costs far more than the product."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

GAP = 1e-3
KS = [8, 10]  # proper factors of L=80
ONLINE = "tests/profiles/llama_3_70b/online"
CONV_KEYS = {"lp_backend", "mip_gap", "ks", "incumbent", "best_bound", "ipm_iters_executed",
             "bnb_rounds", "round_log", "root_trace"}


@pytest.fixture(scope="module")
def model():
    from distilp_torch.common import load_model_profile

    return load_model_profile(f"{ONLINE}/model_profile.json")


@pytest.fixture(scope="module")
def fleet():
    from distilp_torch.utils import make_synthetic_fleet

    return make_synthetic_fleet(4, seed=11)


def tiny_arrays(B=3, m=5, n=9):
    """A small feasible boxed-LP batch (shared A, b at the box midpoint),
    the JAX test's ``tiny_batch`` in float64."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(m, n))
    c = rng.normal(size=(B, n))
    l = np.zeros((B, n))
    u = np.full((B, n), 2.0)
    b = np.ones((B, n)) @ A.T
    return A, b, c, l, u


def _port(arrs):
    return LPBatch(*(torch.tensor(a, dtype=torch.float64) for a in arrs))


def _solve(engine, batch, **kw):
    if engine == "ipm":
        return ipm_solve_batch(batch, iters=20, **kw)
    return pdhg_solve_batch(batch, iters=200, **kw)


# -- kernel-level contracts -------------------------------------------------


@pytest.mark.parametrize("engine", ["ipm", "pdhg"])
def test_trace_off_on_bit_identical(engine):
    batch = _port(tiny_arrays())
    r0 = _solve(engine, batch)
    r1 = _solve(engine, batch, trace=True)
    assert r0.trace_buf is None and r1.trace_buf is not None
    for f in r0._fields[:-1]:
        assert torch.equal(getattr(r0, f), getattr(r1, f)), f"{engine}: {f} diverged"


@pytest.mark.parametrize("engine", ["ipm", "pdhg"])
def test_trace_rows_account_for_iters(engine):
    res = _solve(engine, _port(tiny_arrays()), trace=True)
    tb = res.trace_buf.numpy()
    iters_run = res.iters_run.numpy()
    assert tb.shape[0] == len(iters_run) and tb.shape[2] == TRACE_COLS
    for e in range(tb.shape[0]):
        live = tb[e][tb[e][:, 5] > 0.5]
        assert len(live) >= 1
        assert np.all(np.diff(live[:, 0]) > 0)
        assert live[-1, 0] == iters_run[e]
        assert np.all(np.isfinite(live))
        assert np.all(np.diff(live[:, 4]) >= 0)
        if engine == "ipm":
            assert np.all(live[:, 4] == 0)
        # Rows past the element's last chunk stay zero.
        assert not np.any(tb[e][len(live):])


def test_pdhg_skip_element_has_no_live_rows():
    res = pdhg_solve_batch(_port(tiny_arrays()), iters=64, trace=True,
                           skip=torch.tensor([True, False, False]))
    tb = res.trace_buf.numpy()
    assert not np.any(tb[0])
    assert np.any(tb[1][:, 5] > 0.5)


@pytest.mark.parametrize("engine,tol", [("ipm", 1e-8), ("pdhg", 1e-5)])
def test_trace_buf_matches_jax(engine, tol):
    from distilp_tpu.ops import LPBatch as JBatch
    from distilp_tpu.ops.ipm import ipm_solve_batch as j_ipm
    from distilp_tpu.ops.pdhg import pdhg_solve_batch as j_pdhg

    arrs = tiny_arrays(B=4, m=6, n=11)
    skip = np.array([False, False, True, False])
    jb = JBatch(*(jnp.asarray(a) for a in arrs))
    if engine == "ipm":
        ref = j_ipm(jb, iters=20, trace=True, skip=jnp.asarray(skip))
    else:
        ref = j_pdhg(jb, iters=200, trace=True, skip=jnp.asarray(skip))
    got = _solve(engine, _port(arrs), trace=True, skip=torch.tensor(skip))
    t_ref = np.asarray(ref.trace_buf)
    t_got = got.trace_buf.numpy()
    assert t_got.shape == t_ref.shape
    np.testing.assert_array_equal(t_got[..., [0, 4, 5]], t_ref[..., [0, 4, 5]])
    scale = np.maximum(1.0, np.abs(t_ref[..., 1:4]))
    assert np.all(np.abs(t_got[..., 1:4] - t_ref[..., 1:4]) <= tol * scale)
    np.testing.assert_array_equal(got.iters_run.numpy(), np.asarray(ref.iters_run))


# -- sweep-level contracts --------------------------------------------------


@pytest.fixture(scope="module")
def jax_online():
    """The JAX package's convergence dicts on llama_3_70b/online (its own
    devices, gap 1e-3), per engine."""
    from distilp_tpu.common import load_from_profile_folder
    from distilp_tpu.solver import halda_solve

    out = {}
    for engine in ("ipm", "pdhg"):
        conv = {}
        halda_solve(*load_from_profile_folder(ONLINE), mip_gap=GAP, kv_bits="4bit",
                    backend="jax", lp_backend=engine, convergence=conv)
        out[engine] = conv
    return out


@pytest.mark.parametrize("engine", ["ipm", "pdhg"])
def test_round_log_matches_jax_on_the_online_fixture(jax_online, engine):
    from distilp_torch import kernels
    from distilp_torch.common import load_from_profile_folder
    from distilp_torch.solver import halda_solve

    conv, tm = {}, {}
    routes = dict(kernels.SHAPES["bnb_graph"])
    halda_solve(*load_from_profile_folder(ONLINE), mip_gap=GAP, kv_bits="4bit",
                device="cpu", lp_backend=engine, convergence=conv, timings=tm)
    # The logged search runs on the loop's plan (R3d), not the host loop.
    key = f"route=graph dense_{engine}+log L=1"
    assert kernels.SHAPES["bnb_graph"].get(key, 0) == routes.get(key, 0) + 1
    ref = jax_online[engine]
    assert set(conv) == set(ref) == CONV_KEYS
    assert conv["lp_backend"] == engine and conv["ks"] == ref["ks"]
    assert [r[:3] for r in conv["round_log"]] == [r[:3] for r in ref["round_log"]]
    assert [len(t) for t in conv["root_trace"]] == [len(t) for t in ref["root_trace"]]
    assert conv["incumbent"] == pytest.approx(ref["incumbent"], rel=1e-9)
    assert tm["conv_rounds"] == len(conv["round_log"])


@pytest.mark.parametrize("engine", ["ipm", "pdhg"])
def test_sweep_convergence_report(model, fleet, engine):
    from distilp_torch.solver import halda_solve

    tm, conv = {}, {}
    res = halda_solve(fleet, model, k_candidates=KS, mip_gap=GAP, kv_bits="4bit",
                      device="cpu", lp_backend=engine, timings=tm, convergence=conv)
    trace = build_search_trace(conv)
    assert trace.lp_backend == engine and trace.rounds
    assert sum(r.lp_iters for r in trace.rounds) == trace.lp_iters_executed
    assert trace.lp_iters_executed == int(round(tm["ipm_iters_executed"]))
    gaps = [r.gap for r in trace.rounds if r.gap is not None]
    assert all(a >= b - 1e-12 for a, b in zip(gaps, gaps[1:])), gaps
    if res.certified:
        assert trace.certified and trace.final_gap <= GAP + 1e-12
        assert trace.rounds_to_certify is not None and trace.iters_to_certify is not None
    assert tm["conv_rounds"] == len(trace.rounds)
    assert tm["conv_lp_iters"] == trace.lp_iters_executed
    assert tm["conv_certified"] == trace.certified
    assert [t.k for t in trace.root_traces] == KS
    if engine == "pdhg":
        assert trace.restarts > 0


def test_untraced_solve_identical_to_traced(model, fleet):
    from distilp_torch.solver import halda_solve

    runs = []
    for conv in (None, {}):
        tm = {}
        r = halda_solve(fleet, model, k_candidates=KS, mip_gap=GAP, kv_bits="4bit",
                        device="cpu", timings=tm, convergence=conv)
        runs.append(((r.k, r.w, r.n, r.obj_value, r.certified),
                     tm["ipm_iters_executed"], tm["bnb_rounds"]))
    assert runs[0] == runs[1]


def test_async_convergence_equals_sync(model, fleet):
    from distilp_torch.solver import halda_solve, halda_solve_async

    sync, piped = {}, {}
    halda_solve(fleet, model, k_candidates=KS, mip_gap=GAP, kv_bits="4bit", device="cpu",
                convergence=sync)
    pending = halda_solve_async(fleet, model, k_candidates=KS, mip_gap=GAP, kv_bits="4bit",
                                device="cpu", convergence=piped)
    pending.collect()
    assert piped == sync and piped["round_log"]


def test_streaming_diagnostics_flag(model, fleet):
    from distilp_torch.solver.streaming import StreamingReplanner

    planner = StreamingReplanner(mip_gap=GAP, kv_bits="4bit", device="cpu", diagnostics=True)
    tm: dict = {}
    planner.step(list(fleet), model, k_candidates=KS, timings=tm)
    assert planner.last_convergence.get("round_log")
    assert "conv_rounds" in tm
    assert build_search_trace(planner.last_convergence).rounds
    planner.step(list(fleet), model, k_candidates=KS, timings=tm)
    assert build_search_trace(planner.last_convergence).rounds
    planner.reset()
    assert planner.last_convergence == {}


def test_pipelined_diagnostics_refresh(model, fleet):
    from distilp_torch.solver.streaming import StreamingReplanner

    planner = StreamingReplanner(mip_gap=GAP, kv_bits="4bit", device="cpu", diagnostics=True)
    planner.step(list(fleet), model, k_candidates=KS)
    first = planner.last_convergence
    assert first.get("round_log")
    planner.submit(list(fleet), model, k_candidates=KS)
    assert planner.collect() is not None
    assert planner.last_convergence is not first
    trace = build_search_trace(planner.last_convergence)
    assert trace.rounds
    assert sum(r.lp_iters for r in trace.rounds) == trace.lp_iters_executed


# -- report layer -----------------------------------------------------------


@pytest.mark.parametrize("engine", ["ipm", "pdhg"])
def test_report_of_a_jax_dict_equals_the_jax_modules(jax_online, engine):
    from distilp_tpu.obs import convergence as jconv

    conv = jax_online[engine]
    got = build_search_trace(conv)
    ref = jconv.build_search_trace(conv)
    assert search_trace_to_jsonl(got) == jconv.search_trace_to_jsonl(ref)
    assert got.digest() == ref.digest()
    assert got.render_text() == ref.render_text()


def test_jsonl_roundtrip_across_packages(model, fleet):
    from distilp_torch.solver import halda_solve
    from distilp_tpu.obs import convergence as jconv

    conv: dict = {}
    halda_solve(fleet, model, k_candidates=KS, mip_gap=GAP, kv_bits="4bit", device="cpu",
                convergence=conv)
    trace = build_search_trace(conv)
    text = search_trace_to_jsonl(trace)
    back = search_trace_from_jsonl(text)
    assert back == trace and back.digest() == trace.digest()
    assert "round" in trace.render_text()
    assert search_trace_to_jsonl(jconv.search_trace_from_jsonl(text)) == text


def test_digest_keys_match_registry(model, fleet):
    from distilp_torch.solver import halda_solve
    from distilp_tpu.obs.convergence import CONV_DIGEST_KEYS as J_KEYS

    conv: dict = {}
    halda_solve(fleet, model, k_candidates=KS, mip_gap=GAP, kv_bits="4bit", device="cpu",
                convergence=conv)
    digest = build_search_trace(conv).digest()
    assert tuple(CONV_DIGEST_KEYS) == tuple(J_KEYS)
    assert set(digest) == set(CONV_DIGEST_KEYS)  # certified: every field


def test_jsonl_rejects_malformed():
    with pytest.raises(ValueError):
        search_trace_from_jsonl('{"type": "round", "round": 0}\n')
    with pytest.raises(ValueError):
        search_trace_from_jsonl('{"type": "mystery"}\n')


def test_build_search_trace_handles_sentinels():
    conv = {
        "lp_backend": "ipm", "mip_gap": 1e-3, "ks": [4],
        "incumbent": float("inf"), "best_bound": float("-inf"),
        "ipm_iters_executed": 8.0, "bnb_rounds": 1.0,
        "round_log": [[0, 1.0, 2.0, float("inf"), float("-inf"), 8.0]],
        "root_trace": [[[8.0, 1e-5, 1e-6, 1e-7, 0.0, 1.0]]],
    }
    tr = build_search_trace(conv)
    assert tr.incumbent is None and tr.best_bound is None
    assert not tr.certified and tr.final_gap is None
    assert tr.rounds[0].gap is None
    conv["best_bound"] = float("inf")
    conv["incumbent"] = 5.0
    assert build_search_trace(conv).final_gap == 0.0


# -- the diagnose CLI -------------------------------------------------------


def test_diagnose_cli_roundtrip(tmp_path, capsys):
    from distilp_torch.cli.solver_cli import main

    out = tmp_path / "diag.jsonl"
    rc = main(["diagnose", "--profile", ONLINE, "--synthetic-fleet", "4", "--fleet-seed",
               "11", "--k-candidates", "8,10", "--mip-gap", str(GAP), "--device", "cpu",
               "--json", "--out", str(out)])
    assert rc == 0
    payload = json.loads(capsys.readouterr().out.strip())
    assert payload["rounds"]
    assert payload["digest"]["conv_rounds"] == len(payload["rounds"])
    assert sum(r["lp_iters"] for r in payload["rounds"]) == payload["lp_iters_executed"]
    assert main(["diagnose", "--load", str(out)]) == 0
    assert "search:" in capsys.readouterr().out
    trace = search_trace_from_jsonl(out.read_text())
    assert trace.rounds and trace.lp_iters_executed == payload["lp_iters_executed"]


def test_diagnose_cli_rejects_bad_input(tmp_path, capsys):
    from distilp_torch.cli.solver_cli import diagnose_main

    assert diagnose_main([]) == 2  # no --profile, no --load
    bad = tmp_path / "bad.jsonl"
    bad.write_text("not json\n")
    assert diagnose_main(["--load", str(bad)]) == 2
    assert diagnose_main(["--profile", str(tmp_path / "none"), "--device", "cpu"]) == 2
    capsys.readouterr()
