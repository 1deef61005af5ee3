"""The port's asynchronous solve (``halda_solve_async`` / ``PendingHalda``).

``collect()`` returns what ``halda_solve`` returns (k, w, n, y, objective and
certificate) on the four golden fixtures and a MoE case (Mixtral 8x7B on 4
devices), also with two solves in flight at once and collected in the other
order; a structurally infeasible sweep raises at dispatch; an exception of
the search on the worker thread is raised by ``collect()``; the options of
later slices raise as in ``halda_solve``. All on the plain path
(``device='cpu'``); the same on the card is ``chip_smoke.py``'s sweep run.
"""

import pytest

torch = pytest.importorskip("torch")

from distilp_torch.common import load_from_profile_folder, load_model_profile  # noqa: E402
from distilp_torch.solver import PendingHalda, halda_solve, halda_solve_async  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402

GOLDEN = ["hermes_70b", "llama_3_70b/4bit", "llama_3_70b/online", "qwen3_32b/bf16"]


def _same(a, b):
    assert (a.k, a.w, a.n, a.y, a.obj_value, a.certified, a.gap) == \
        (b.k, b.w, b.n, b.y, b.obj_value, b.certified, b.gap)


@pytest.mark.parametrize("folder", GOLDEN)
def test_collect_equals_the_synchronous_solve(profiles_dir, folder):
    devs, model = load_from_profile_folder(profiles_dir / folder)
    kw = dict(mip_gap=1e-4, kv_bits="4bit", device="cpu")
    pending = halda_solve_async(devs, model, **kw)
    assert isinstance(pending, PendingHalda)
    _same(pending.collect(), halda_solve(devs, model, **kw))


def test_moe_solves_in_flight_together():
    from distilp_torch.profiler import profile_model

    model = profile_model("tests/configs/mixtral_8x7b.json", batch_sizes=[1],
                          sequence_length=128).to_model_profile()
    kw = dict(mip_gap=1e-3, kv_bits="8bit", device="cpu")
    fleets = [make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9)),
              make_synthetic_fleet(8, seed=7, pool_bytes=int(64e9))]
    pending = [halda_solve_async(d, model, **kw) for d in fleets]
    got = [p.collect() for p in reversed(pending)][::-1]
    for d, r in zip(fleets, got):
        ref = halda_solve(d, model, **kw)
        _same(r, ref)
        assert r.duals is not None and sum(r.y) == model.n_routed_experts


def test_infeasible_sweep_raises_at_dispatch(profiles_dir):
    model = load_model_profile(profiles_dir / "llama_3_70b" / "online" / "model_profile.json")
    devs = make_synthetic_fleet(16, seed=123)
    # k = 40 leaves W = 2 layers a segment for 16 devices.
    with pytest.raises(RuntimeError, match="No feasible"):
        halda_solve_async(devs, model, k_candidates=[40], kv_bits="4bit", device="cpu")


def test_worker_exception_is_raised_by_collect(profiles_dir, monkeypatch):
    from distilp_torch.solver import backend_torch

    def boom(prep):
        raise FloatingPointError("search failed")

    monkeypatch.setattr(backend_torch, "_search", boom)
    devs, model = load_from_profile_folder(profiles_dir / "llama_3_70b" / "online")
    pending = halda_solve_async(devs, model, kv_bits="4bit", device="cpu")
    with pytest.raises(FloatingPointError, match="search failed"):
        pending.collect()


def test_options_of_later_slices_raise(profiles_dir):
    devs, model = load_from_profile_folder(profiles_dir / "llama_3_70b" / "online")
    # The margin chain is ported: a dense solve accepts the dict and
    # leaves it alone (the chain is MoE-only).
    ms = {}
    assert halda_solve_async(devs, model, margin_state=ms, device="cpu").collect().certified
    assert ms == {}
    # Convergence telemetry is ported: the dict is decoded at collect().
    conv, tm = {}, {}
    pending = halda_solve_async(devs, model, convergence=conv, timings=tm, device="cpu")
    assert conv == {}
    assert pending.collect().certified
    assert conv["round_log"] and conv["root_trace"] and conv["lp_backend"] == "ipm"
    assert tm["conv_rounds"] == len(conv["round_log"])
