"""The port's device profiler (``distilp_torch.profiler.device``) against the
JAX package's, on the CPU.

- The ``DeviceInfo`` -> ``DeviceProfile`` mapping equals the JAX package's
  field by field (its ``profile`` monkeypatched to hand back the same
  ``DeviceInfo``) for what the port measures: a CUDA card or none, on one
  device; other accelerators and several devices are refused.
- ``bench``'s sub-noise rule and ``_gemm_flops``' "no table" value mirror
  ``tests/test_device_profiler.py``; a dtype the matmul does not take is
  refused before anything is launched.
- ``/proc/meminfo`` gives psutil's totals.
- ``profile_device(device='cpu')`` gives a profile the port's solver uses,
  and profiles and raw ``DeviceInfo`` JSON cross packages both ways.
- One visible device: the interconnect is "unmeasured"; several GPUs raise
  naming ROADMAP A13.
The probe kernels' plain versions (``torch.roll``; ``torch.matmul`` and
``y / (max|y| + eps)``) are what CPU tensors take, and the plain chain step
equals the JAX package's chain body; the kernels run only on the card
(``chip_smoke.py``), and K9b refuses operands it cannot take before it
launches anything.
"""

import math

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from distilp_tpu.profiler import datatypes as jdt  # noqa: E402
from distilp_tpu.profiler import device as jdevice  # noqa: E402
from distilp_tpu.profiler.hfconfig import load_config as jload_config  # noqa: E402

from distilp_torch import kernels  # noqa: E402
from distilp_torch.common import DeviceProfile, load_from_profile_folder  # noqa: E402
from distilp_torch.profiler import DeviceInfo, load_config, profile_device  # noqa: E402
from distilp_torch.profiler import device as pdevice  # noqa: E402
from distilp_torch.profiler import topology  # noqa: E402
from distilp_torch.solver import halda_solve  # noqa: E402

CONFIG = "tests/configs/llama3_70b_4bit.json"
SMALL_ENV = {"DPERF_MEM_MB": "4", "DPERF_DISK_FILE_MB": "2", "DPERF_GEMM_ITERS": "2",
             "DPERF_GEMM_WARMUP": "0"}


def _device_info(gpu_name: str, multi: bool) -> DeviceInfo:
    di = DeviceInfo(os="linux")
    for i, tag in enumerate(("f32", "fp16", "bf16")):
        for j, b in enumerate(("b_1", "b_2", "b_4")):
            setattr(getattr(di.cpu.benchmarks, tag), b, 1e11 * (i + 1) + j * 7e9)
            setattr(getattr(di.gpu.benchmarks, tag), b, 5e13 * (i + 1) + j * 3e12)
    di.memory.total, di.memory.available = 6.4e10, 5.1e10
    di.memory.total_swap, di.memory.available_swap = 8e9, 7e9
    di.memory.cpu_read_warm_bw, di.memory.cpu_read_cold_bw = 2.1e10, 1.3e10
    di.memory.cpu_write_cold_bw = 9.7e9
    di.disk.read, di.disk.write, di.disk.random = 2.5e9, 1.9e9, 2.5e9
    di.gpu.name = gpu_name
    di.gpu.memory.vram_to_compute = 2.9e12
    di.gpu.memory.read_bw, di.gpu.memory.write_bw = 1.2e10, 9e9
    di.gpu.memory.free, di.gpu.memory.total = 8.4e10, 8.5e10
    if multi:
        di.interconnect.num_devices, di.interconnect.num_slices = 8, 2
        di.interconnect.ici_allreduce_latency_s = 1.2e-5
        di.interconnect.ici_bandwidth = 4.5e10
        di.interconnect.dcn_latency_s, di.interconnect.dcn_bandwidth = 1e-3, 3e9
    else:
        di.interconnect.num_devices = 1
    return di


@pytest.mark.parametrize("gpu_name,multi", [("cuda", False), ("", False), ("cuda", True)])
def test_device_profile_mapping_equals_the_jax_package(monkeypatch, gpu_name, multi):
    di = _device_info(gpu_name, multi)
    jdi = jdt.DeviceInfo.model_validate_json(di.model_dump_json())
    monkeypatch.setattr(jdevice, "profile", lambda config, max_batch_exp=6: jdi)
    want = jdevice.profile_device(jload_config(CONFIG), max_batch_exp=3, is_head=False)
    got = pdevice.device_profile_from_info(di, load_config(CONFIG), 3, is_head=False)
    assert got.model_dump() == want.model_dump()
    if gpu_name == "cuda":
        assert got.has_cuda and got.T_cuda == 2.9e12 and got.d_avail_cuda == int(8.4e10)
    if multi:  # several devices: the timed collectives' terms (DCN: two slices)
        assert got.t_comm > 0 and (got.comm_latency, got.comm_bandwidth) == (1e-3, 3e9)


@pytest.mark.parametrize("gpu_name,multi,error", [
    ("tpu", False, ValueError), ("metal", False, ValueError)])
def test_device_profile_mapping_refuses_what_the_port_does_not_measure(gpu_name, multi,
                                                                       error):
    with pytest.raises(error):
        pdevice.device_profile_from_info(_device_info(gpu_name, multi), load_config(CONFIG), 3)


def test_bench_subnoise_is_invalid_not_clamped():
    sink = {}
    x = torch.ones(4)
    t = pdevice.bench(lambda: x, warmup=1, iters=4, baseline=10.0, label="probe", sink=sink)
    assert math.isnan(t)
    st = sink["probe"]
    assert not st.valid and st.samples == 4 and st.baseline == 10.0
    assert st.min <= st.p50 <= st.p95 <= st.p99 <= st.max
    t2 = pdevice.bench(lambda: x * 2.0, warmup=1, iters=4, label="ok", sink=sink)
    assert t2 > 0 and sink["ok"].valid


def test_gemm_flops_no_table_value():
    cpu = torch.device("cpu")
    sink = {}
    # A sub-noise integer product (the JAX test's uint32 case; PyTorch's CPU
    # matmul takes int32, not uint32).
    assert pdevice._gemm_flops(cpu, 1, 8, 8, 8, "int32", warmup=0, iters=2,
                               baseline=10.0, label="gemm.cpu.i32.b_1", sink=sink) == 0.0
    assert not sink["gemm.cpu.i32.b_1"].valid
    # A dtype the matmul does not take is refused before anything runs: on
    # the CPU (uint32) and on a CUDA device (every integer type), which this
    # host does not even have.
    for dev in (cpu, torch.device("cuda")):
        assert pdevice._gemm_flops(dev, 1, 8, 8, 8, "uint32", 0, 2, label="u32",
                                   sink=sink) == 0.0
    assert "u32" not in sink
    assert not pdevice.matmul_supported(torch.device("cuda"), torch.int32)
    # A float chain on the CPU measures something.
    assert pdevice._gemm_flops(cpu, 2, 64, 64, 64, "bfloat16", 0, 2) > 0.0


def test_meminfo_equals_psutil_totals():
    psutil = pytest.importorskip("psutil")
    mi = pdevice.read_meminfo()
    assert mi["MemTotal"] == psutil.virtual_memory().total
    assert mi["SwapTotal"] == psutil.swap_memory().total


def test_cpu_probes_take_the_plain_versions_and_count_nothing():
    kernels.reset_launch_counts()
    x = torch.arange(10.0)
    assert torch.equal(pdevice.roll1(x), torch.roll(x, 1))
    y = torch.tensor([[-3.0, 1.5], [2.0, 0.5]], dtype=torch.bfloat16)
    b = torch.tensor([[0.5, -1.0], [2.0, 0.25]], dtype=torch.bfloat16)
    p = y @ b
    assert torch.equal(pdevice.gemm_absmax_scale(y, b), p / (p.abs().amax() + 1e-6))
    assert set(kernels.LAUNCHES.values()) == {0}


# (dtype, atol): the outputs lie in [-1, 1]; float32 differs by summation
# order only, the 16-bit types by at most one ulp of the rounded product
# (2^-10 and 2^-7 at 1.0) after that.
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-6), ("float16", 2 ** -10),
                                        ("bfloat16", 2 ** -7)])
def test_gemm_chain_step_equals_the_jax_chain_body(dtype, atol):
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 48, 64)).astype(np.float32)
    b = rng.standard_normal((64, 40)).astype(np.float32)
    jdt_ = jnp.dtype(dtype)
    jy = jnp.matmul(jnp.asarray(x, jdt_), jnp.asarray(b, jdt_))
    want = np.asarray((jy / (jnp.max(jnp.abs(jy)) + jnp.asarray(1e-6, jdt_))).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = pdevice.gemm_absmax_scale(torch.from_numpy(x).to(tdt), torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt and got.shape == (2, 48, 40)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("x_shape,b_shape,dtype,error", [
    ((4, 64), (64, 32), torch.int32, TypeError),
    ((4, 64), (32, 32), torch.float32, ValueError),   # K does not match
    ((4, 66), (66, 32), torch.float32, ValueError),   # K not a multiple of 4
    ((4, 64), (64, 36), torch.float16, ValueError),   # N not a multiple of 8
    ((4, 64), (64, 32), (torch.float16, torch.bfloat16), TypeError),  # mixed pairs
    ((4, 64), (64, 32), (torch.bfloat16, torch.float16), TypeError),
    ((4, 64), (64, 32), (torch.float32, torch.float16), TypeError),
    ((4, 64), (64, 32), (torch.float16, torch.float32), TypeError),
    ((4, 64), (64, 32), torch.float64, TypeError),
    ((4, 0), (0, 32), torch.float16, ValueError),     # K = 0
    ((4, 36), (36, 32), torch.bfloat16, ValueError),  # x rows of 72 bytes
])
def test_gemm_chain_kernel_refuses_operands_before_launching(x_shape, b_shape, dtype, error):
    xd, bd = dtype if isinstance(dtype, tuple) else (dtype, dtype)
    x = torch.zeros(x_shape, dtype=xd)
    b = torch.zeros(b_shape, dtype=bd)
    with pytest.raises(error):
        pdevice._gemm_absmax_kernel(x, b)


def _misaligned(shape, dtype):
    flat = torch.zeros(math.prod(shape) + 1, dtype=dtype)
    return flat[1:].view(shape)


# What the products' TMA loads refuse, float32's as the 16-bit types' (a
# base that is not 16-byte aligned, strides other than the rows' own,
# coordinates past 32-bit signed integers): the wrapper raises before
# anything is launched.
@pytest.mark.parametrize("make", [
    lambda: (_misaligned((4, 64), torch.float16), torch.zeros(64, 32, dtype=torch.float16)),
    lambda: (torch.zeros(4, 64, dtype=torch.bfloat16), _misaligned((64, 32), torch.bfloat16)),
    lambda: (_misaligned((4, 64), torch.float32), torch.zeros(64, 32)),
    lambda: (torch.zeros(4, 64), _misaligned((64, 32), torch.float32)),
    lambda: (torch.zeros(4, 64), torch.zeros(32, 64).t()),  # b column-major
    lambda: (torch.zeros(4, 128)[:, :64], torch.zeros(64, 32)),  # x rows strided
    lambda: (torch.zeros(4, 64, dtype=torch.float16),
             torch.zeros(32, 64, dtype=torch.float16).t()),  # b column-major
    lambda: (torch.zeros(64, 4, dtype=torch.float16).t(),
             torch.zeros(64, 32, dtype=torch.float16)),  # x column-major
    lambda: (torch.zeros(4, 128, dtype=torch.float16)[:, :64],
             torch.zeros(64, 32, dtype=torch.float16)),  # x rows strided
    lambda: (torch.empty((2**31, 8), dtype=torch.float16, device="meta"),
             torch.empty((8, 8), dtype=torch.float16, device="meta")),  # M >= 2^31
    lambda: (torch.empty((8, 2**31), dtype=torch.bfloat16, device="meta"),
             torch.empty((2**31, 8), dtype=torch.bfloat16, device="meta")),  # K >= 2^31
], ids=["x_misaligned_f16", "b_misaligned_bf16", "x_misaligned_f32", "b_misaligned_f32",
        "b_column_major_f32", "x_row_strided_f32", "b_column_major", "x_column_major",
        "x_row_strided", "rows_past_int32", "depth_past_int32"])
def test_gemm_chain_kernel_refuses_what_tma_refuses(make):
    x, b = make()
    with pytest.raises(ValueError):
        pdevice._gemm_absmax_kernel(x, b)


def _stand_in_tile(code, M, N):
    """The tile the stand-in library answers: each dtype's own, and for
    float32 one picked from the shape, as the library does."""
    if code == 0:
        return (128, 192) if N >= 1024 else (128, 128)
    return (128, 256)


class _StandInGemmLibrary:
    """Records what the K9b wrappers pass the kernel library."""

    def __init__(self, seen):
        self.seen = seen

    def dtk_gemm_tile(self, code, M, N, rows, cols):
        self.seen.setdefault("tiles", []).append((code, M, N))
        rows._obj.value, cols._obj.value = _stand_in_tile(code, M, N)
        return 0

    def __getattr__(self, name):
        if not name.startswith(("dtk_gemm_absmax_", "dtk_absmax_rescale_")):
            raise AttributeError(name)

        def entry(*args):
            self.seen.setdefault("calls", []).append(name)
            if name.startswith("dtk_gemm_absmax_"):
                self.seen["MNK"] = tuple(args[3:6])
                self.seen["partial"] = args[6].value
            return 0
        return entry


@pytest.mark.parametrize("dtype,code,suffix,N,parts", [
    (torch.float32, 0, "f32", 520, 3 * 5), (torch.float32, 0, "f32", 1040, 3 * 6),
    (torch.float16, 1, "f16", 520, 3 * 3)])
def test_gemm_partials_come_from_the_library_tile(monkeypatch, dtype, code, suffix, N, parts):
    """The wrapper sizes ``partial`` (one abs-max per output tile) from the
    output tile the kernel library reports for the dtype and the product's
    (M, N) (``dtk_gemm_tile``; float32's depends on the shape) and passes the
    dtype's entry its (M, N, K): a stand-in library answers here."""
    from distilp_torch.kernels import build

    seen = {}
    monkeypatch.setattr(build, "library", lambda name: _StandInGemmLibrary(seen))
    monkeypatch.setattr(pdevice.kernels, "stream_handle", lambda dev: None)
    x = torch.zeros((2, 150, 64), dtype=dtype)
    b = torch.zeros((64, N), dtype=dtype)
    y, partial = pdevice._gemm_absmax_kernel(x, b)
    assert seen["tiles"] == [(code, 300, N)] and seen["MNK"] == (300, N, 64)
    assert seen["calls"] == [f"dtk_gemm_absmax_{suffix}"]
    tile = _stand_in_tile(code, 300, N)
    assert pdevice.gemm_tile(dtype, 300, N) == tile
    assert partial.numel() == pdevice.gemm_partials(300, N, tile) == parts
    assert seen["partial"] == partial.data_ptr() and y.shape == (2, 150, N)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_step_counts_its_launch_by_dtype(monkeypatch, dtype):
    """On the card one chain step is one count of ``gemm_absmax_scale``
    (product and scale), broken down by dtype in ``kernels.SHAPES``; a
    stand-in library takes the launches here."""
    from distilp_torch.kernels import build

    seen = {}
    monkeypatch.setattr(build, "library", lambda name: _StandInGemmLibrary(seen))
    monkeypatch.setattr(pdevice.kernels, "stream_handle", lambda dev: None)
    monkeypatch.setattr(pdevice.kernels, "on_cuda", lambda *t: True)
    kernels.reset_launch_counts()
    try:
        for _ in range(3):
            pdevice.gemm_absmax_scale(torch.zeros((2, 8, 64), dtype=dtype),
                                      torch.zeros((64, 32), dtype=dtype))
        tag = str(dtype).split(".")[-1]
        suffix = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
        assert kernels.LAUNCHES["gemm_absmax_scale"] == 3
        assert kernels.SHAPES["gemm_absmax_scale"] == {tag: 3}
        assert seen["calls"] == [f"dtk_gemm_absmax_{suffix}",
                                 f"dtk_absmax_rescale_{suffix}"] * 3
    finally:
        kernels.reset_launch_counts()


@pytest.fixture(scope="module")
def cpu_profile():
    mp = pytest.MonkeyPatch()
    for k, v in SMALL_ENV.items():
        mp.setenv(k, v)
    raw = []
    try:
        prof = profile_device("tests/configs/phi3_mini.json", max_batch_exp=1,
                              is_head=False, raw_info=raw, device="cpu")
    finally:
        mp.undo()
    return prof, raw[0]


def test_cpu_profile_is_valid_and_solvable(cpu_profile, profiles_dir):
    prof, di = cpu_profile
    assert isinstance(prof, DeviceProfile) and not prof.has_cuda and not prof.is_head
    assert prof.T_cpu > 0 and prof.scpu["F32"]["b_1"] > 0 and prof.s_disk > 0
    assert prof.d_avail_ram > 0 and prof.sgpu_cuda is None
    assert di.interconnect.num_devices == 1 and di.interconnect.provenance == "unmeasured"
    assert di.cpu.benchmarks.u32.b_1 == 0.0  # PyTorch's CPU matmul takes no uint32
    assert "gemm.cpu.f32.b_1.hi" in di.stats and di.stats["mem.cpu_read_warm"].valid
    devs, model = load_from_profile_folder(profiles_dir / "llama_3_70b" / "online")
    r = halda_solve(devs + [prof], model, mip_gap=1e-3, kv_bits="4bit", device="cpu")
    assert r.certified and sum(r.w) * r.k == model.L and len(r.w) == 3


def test_profiles_and_raw_info_cross_packages(cpu_profile, profiles_dir, tmp_path):
    from distilp_tpu.common import load_from_profile_folder as jload

    prof, di = cpu_profile
    folder = tmp_path / "fleet"
    folder.mkdir()
    src = profiles_dir / "llama_3_70b" / "online"
    for f in src.glob("*.json"):
        (folder / f.name).write_text(f.read_text())
    (folder / "zz_port.json").write_text(prof.model_dump_json(indent=2))
    ours, _ = load_from_profile_folder(folder)
    theirs, _ = jload(folder)
    assert [d.model_dump() for d in ours] == [d.model_dump() for d in theirs]
    assert ours[-1].model_dump() == prof.model_dump()
    # Raw DeviceInfo, both ways.
    back = jdt.DeviceInfo.model_validate_json(di.model_dump_json())
    assert back.model_dump() == di.model_dump()
    jdi = jdt.DeviceInfo.model_validate_json(_device_info("tpu", True).model_dump_json())
    assert DeviceInfo.model_validate_json(jdi.model_dump_json()).model_dump() == jdi.model_dump()


def test_one_device_interconnect_is_unmeasured(monkeypatch):
    info = topology.measure_interconnect(device="cpu")
    assert info.num_devices == 1 and info.provenance == "unmeasured"
    assert topology.estimate_t_comm(16384, info=info) == 0.0
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert topology.measure_interconnect(device="cuda").provenance == "unmeasured"
    # Several devices are probed now (K9c): two shards of a virtual CPU mesh
    # time the collectives and say so; a multi-slice info prices the
    # slowest link as the JAX package does.
    two = topology.measure_interconnect(latency_iters=2, bandwidth_mb=1,
                                        devices=["cpu", "cpu"])
    assert two.num_devices == 2 and two.provenance == "virtual"
    multi = _device_info("cuda", True).interconnect
    from distilp_tpu.profiler import topology as jtopology

    jmulti = jdt.InterconnectInfo.model_validate_json(multi.model_dump_json())
    assert topology.estimate_t_comm(16384, info=multi) == \
        jtopology.estimate_t_comm(16384, info=jmulti) == 1e-3 + 16384 / 3e9


def test_profile_device_needs_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        profile_device("tests/configs/phi3_mini.json", max_batch_exp=1)
