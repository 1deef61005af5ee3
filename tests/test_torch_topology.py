"""The port's interconnect probe (K9c, ``distilp_torch/profiler/topology.py``)
against the JAX package's ``profiler/topology.py`` on the CPU.

A mesh of shards that share the CPU times the collectives (the plain
versions here) and marks them "virtual"; one device with no mesh stays
"unmeasured"; ``estimate_t_comm`` and the profile mapping of several devices
equal the JAX package's on the same ``InterconnectInfo``.
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from distilp_tpu.profiler import datatypes as jdt  # noqa: E402
from distilp_tpu.profiler import topology as jtopology  # noqa: E402

from distilp_torch.parallel import Mesh  # noqa: E402
from distilp_torch.parallel.collectives import all_gather, psum  # noqa: E402
from distilp_torch.profiler.datatypes import InterconnectInfo  # noqa: E402
from distilp_torch.profiler import topology  # noqa: E402


def _cpu_mesh(S):
    return Mesh((torch.device("cpu"),) * S, True)


def test_virtual_mesh_is_probed_and_marked_virtual():
    info = topology.measure_interconnect(latency_iters=3, bandwidth_mb=1, devices=_cpu_mesh(4))
    assert info.num_devices == 4 and info.num_slices == 1
    assert info.provenance == "virtual"
    assert info.ici_allreduce_latency_s > 0 and info.ici_bandwidth > 0
    assert info.dcn_latency_s == 0 and info.dcn_bandwidth == 0
    # A list of devices that repeats one is a virtual mesh too.
    listed = topology.measure_interconnect(latency_iters=1, bandwidth_mb=1,
                                           devices=["cpu"] * 2)
    assert listed.provenance == "virtual" and listed.num_devices == 2


def test_islands_add_the_cross_island_terms():
    info = topology.measure_interconnect(latency_iters=2, bandwidth_mb=1, devices=_cpu_mesh(4),
                                         slice_of=lambda i: i // 2)
    assert info.num_slices == 2
    assert info.dcn_latency_s > 0 and info.dcn_bandwidth > 0
    t = topology.estimate_t_comm(4096, info=info)
    assert t == info.dcn_latency_s + 4096 / info.dcn_bandwidth


def test_probe_collectives_equal_plain_sums_and_gathers():
    mesh = _cpu_mesh(4)
    tiny = [torch.full((1, 8), float(s + 1)) for s in range(4)]
    for out in psum(tiny, mesh):
        assert torch.equal(out, torch.full((1, 8), 10.0))
    big = [torch.arange(6, dtype=torch.float32) + 10 * s for s in range(4)]
    for g in all_gather(big, mesh):
        assert torch.equal(g, torch.cat(big))


def test_one_device_without_a_mesh_stays_unmeasured(monkeypatch):
    info = topology.measure_interconnect(device="cpu")
    assert info.num_devices == 1 and info.provenance == "unmeasured"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert topology.measure_interconnect(device="cuda").provenance == "unmeasured"
    one = topology.measure_interconnect(devices=_cpu_mesh(1))
    assert one.num_devices == 1 and one.ici_bandwidth == 0.0
    assert topology.estimate_t_comm(16384, info=info) == 0.0


@pytest.mark.parametrize("fields", [
    dict(num_devices=1),
    dict(num_devices=4, ici_allreduce_latency_s=3.9e-5, ici_bandwidth=2.3e11,
         provenance="virtual"),
    dict(num_devices=8, num_slices=2, ici_allreduce_latency_s=1.2e-5, ici_bandwidth=4.5e10,
         dcn_latency_s=1e-3, dcn_bandwidth=3e9, provenance="measured"),
    dict(num_devices=8, num_slices=2, ici_allreduce_latency_s=1.2e-5, ici_bandwidth=4.5e10,
         provenance="measured"),
])
def test_estimate_t_comm_equals_the_jax_package(fields):
    info = InterconnectInfo(**fields)
    jinfo = jdt.InterconnectInfo.model_validate_json(info.model_dump_json())
    for payload in (16384, 1 << 20):
        assert topology.estimate_t_comm(payload, info=info) == \
            jtopology.estimate_t_comm(payload, info=jinfo)
