"""The node-sharded sweep (K10, ``distilp_torch/parallel/mesh.py``) against
the JAX package's ``parallel.solve_sweep_sharded`` on the CPU.

The JAX side shards the frontier over conftest's eight virtual CPU devices;
the port splits each round's beam rows over an 8-shard virtual CPU mesh
(the plain versions of K1/K5, K2 and K3 per shard). Both must certify, the
objectives within 2x gap of each other, and the port's sharded sweep must
reach its unsharded sweep's placement at the same padded capacity and beam.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from distilp_tpu.parallel import make_mesh as jax_mesh  # noqa: E402
from distilp_tpu.parallel import solve_sweep_sharded as jax_sweep  # noqa: E402
from distilp_tpu.solver.backend_jax import _best_bound  # noqa: E402

from distilp_torch.common import (  # noqa: E402
    kv_bits_to_factor,
    load_from_profile_folder,
    load_model_profile,
)
from distilp_torch.parallel import (  # noqa: E402
    VIRTUAL_DEVICES_ENV,
    make_mesh,
    pad_cap_to_mesh,
    solve_sweep_sharded,
)
from distilp_torch.solver import halda_solve_per_k  # noqa: E402
from distilp_torch.solver.api import _build_instance  # noqa: E402
from distilp_torch.solver.assemble import assemble  # noqa: E402
from distilp_torch.solver.backend_torch import solve_sweep_torch  # noqa: E402
from distilp_torch.solver.coeffs import assign_sets, build_coeffs, valid_factors_of_L  # noqa: E402
from distilp_torch.solver.search import best_bound, per_k_bound  # noqa: E402
from distilp_torch.solver.standard_form import default_search_params  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402

MIP_GAP = 1e-3
MIXTRAL_M8 = -244.53183237917105  # the JAX package, gap 1e-3, kv 8bit


@pytest.fixture
def mesh8(monkeypatch):
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "8")
    return make_mesh(8, "cpu")


def _instance(profiles_dir, M, pkg="torch"):
    if pkg == "torch":
        model = load_model_profile(profiles_dir / "llama_3_70b" / "online" / "model_profile.json")
        devs = make_synthetic_fleet(M, seed=123)
        coeffs = build_coeffs(devs, model, kv_bits_to_factor("4bit"), assign_sets(devs))
        arrays = assemble(coeffs)
    else:
        from distilp_tpu.common import kv_bits_to_factor as jkv
        from distilp_tpu.common import load_model_profile as jload
        from distilp_tpu.solver.assemble import assemble as jassemble
        from distilp_tpu.solver.coeffs import assign_sets as jsets
        from distilp_tpu.solver.coeffs import build_coeffs as jcoeffs
        from distilp_tpu.utils import make_synthetic_fleet as jfleet

        model = jload(profiles_dir / "llama_3_70b" / "online" / "model_profile.json")
        devs = jfleet(M, seed=123)
        coeffs = jcoeffs(devs, model, jkv("4bit"), jsets(devs))
        arrays = jassemble(coeffs)
    kWs = [(k, model.L // k) for k in valid_factors_of_L(model.L) if model.L // k >= M]
    return arrays, coeffs, kWs


def _certified(state, gap):
    inc, bd = float(state.incumbent[0]), float(best_bound(state)[0])
    return inc - bd <= gap * abs(inc) + 1e-12


@pytest.mark.parametrize("M", [8, 16])
def test_sharded_sweep_matches_the_jax_package_and_the_unsharded_sweep(profiles_dir, mesh8,
                                                                        M):
    arrays, coeffs, kWs = _instance(profiles_dir, M)
    state, sf = solve_sweep_sharded(arrays, kWs, coeffs, mesh8, mip_gap=MIP_GAP)
    assert _certified(state, MIP_GAP)
    inc = float(state.incumbent[0])
    jarrays, jcoeffs, jkWs = _instance(profiles_dir, M, "jax")
    jstate, _ = jax_sweep(jarrays, jkWs, jcoeffs, jax_mesh(8), mip_gap=MIP_GAP)
    jinc = float(jstate.incumbent)
    assert float(jstate.incumbent) - float(_best_bound(jstate)) <= MIP_GAP * abs(jinc) + 1e-12
    assert inc == pytest.approx(jinc, rel=2 * MIP_GAP)
    k = int(sf.ks[int(state.inc_kidx[0])])
    w = [int(round(float(x))) for x in state.inc_w[0]]
    n = [int(round(float(x))) for x in state.inc_n[0]]
    assert sum(w) == dict(kWs)[k] and all(wi >= 1 for wi in w)
    # The unsharded sweep at the padded capacity and beam reaches the same
    # placement.
    cap = state.node_lo.shape[1]
    beam = min(pad_cap_to_mesh(default_search_params(False, len(sf.ks))[1], mesh8), cap)
    _, best = solve_sweep_torch(arrays, kWs, mip_gap=MIP_GAP, coeffs=coeffs, node_cap=cap,
                                beam=beam, device="cpu")
    assert (best.k, best.w, best.n) == (k, w, n)
    assert best.obj_value == inc


def test_sharded_cap_and_beam_are_mesh_multiples(profiles_dir, mesh8):
    arrays, coeffs, kWs = _instance(profiles_dir, 16)
    state, _ = solve_sweep_sharded(arrays, kWs, coeffs, mesh8, mip_gap=MIP_GAP, beam=5,
                                   node_cap=20)
    assert _certified(state, MIP_GAP)
    assert state.node_lo.shape[1] % 8 == 0


def test_pad_cap_to_mesh(mesh8):
    assert [pad_cap_to_mesh(c, mesh8) for c in (1, 8, 9)] == [8, 8, 16]


def test_sharded_moe_certifies(mesh8):
    """Mixtral M=8 (seed 7, 64e9): the decomposition bounds seed the roots
    once before the frontier is split; the sweep certifies with sum(y) = E."""
    from distilp_torch.profiler import profile_model

    model = profile_model("tests/configs/mixtral_8x7b.json", batch_sizes=[1],
                          sequence_length=128).to_model_profile()
    devs = make_synthetic_fleet(8, seed=7, pool_bytes=int(64e9))
    Ks, _, coeffs, arrays = _build_instance(devs, model, None, "8bit", None, None)
    kWs = [(k, model.L // k) for k in Ks]
    state, _ = solve_sweep_sharded(arrays, kWs, coeffs, mesh8, mip_gap=MIP_GAP)
    assert _certified(state, MIP_GAP)
    assert float(state.incumbent[0]) == pytest.approx(MIXTRAL_M8, rel=2 * MIP_GAP)
    assert int(round(float(state.inc_y[0].sum()))) == model.n_routed_experts


def test_sharded_per_k_certifies_every_k(profiles_dir, mesh8):
    devs, model = load_from_profile_folder(profiles_dir / "hermes_70b")
    coeffs = build_coeffs(devs, model, kv_bits_to_factor("4bit"), assign_sets(devs))
    arrays = assemble(coeffs)
    kWs = [(k, model.L // k) for k in valid_factors_of_L(model.L)]
    gap = 1e-4
    state, sf = solve_sweep_sharded(arrays, kWs, coeffs, mesh8, mip_gap=gap, per_k=True)
    inc_k = state.per_k_best[0].numpy()
    bound_k = per_k_bound(state)[0].numpy()
    w_k = state.per_k_w[0].numpy()
    solo = {r.k: r for r in halda_solve_per_k(devs, model, mip_gap=gap, kv_bits="4bit",
                                              device="cpu")}
    assert len(solo) == len(sf.ks)
    for j, k in enumerate(sf.ks):
        assert np.isfinite(inc_k[j]), f"k={k} found no incumbent sharded"
        assert np.isposinf(bound_k[j]) or inc_k[j] - bound_k[j] <= gap * abs(inc_k[j]) + 1e-12
        assert abs(inc_k[j] - solo[k].obj_value) <= 2 * gap * abs(solo[k].obj_value) + 1e-9
        assert int(round(float(w_k[j].sum()))) * k == model.L
