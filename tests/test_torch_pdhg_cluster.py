"""K5's two routes on the CPU: the cluster route's choice and ownership plan
(``distilp_torch/ops/pdhg.py``: ``pdhg_route``, ``cluster_plan``), a shared A
read only through its sparse structure (values with a batch stride of 0),
and the search building that structure and its values once a sweep.

The kernels need the card (``chip_smoke.py`` holds both routes against the
plain version there, at the route edges too); here the plan is checked
against the fleet LPs' own structures, a stand-in library records what the
wrapper launches, and the plain version's results on a shared A given as
values are held bit for bit against the dense shared path and, at float64,
against the JAX package with the tolerances of ``tests/test_torch_pdhg.py``
(bound 1e-7 relative, ``v``/``y_dual`` 1e-5 of the field's scale, steps
within one chunk).
"""

import contextlib
import ctypes
import inspect
import re
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_enable_x64", True)

from distilp_torch import kernels  # noqa: E402
from distilp_torch.kernels import build  # noqa: E402
from distilp_torch.ops import pdhg as P  # noqa: E402
from distilp_torch.ops.ipm import LPBatch, ipm_sparsity  # noqa: E402
from distilp_torch.ops.pdhg import (  # noqa: E402
    LONG_NNZ,
    SMEM_LIMIT,
    ElemA,
    PDHGWarmState,
    cast_values,
    cluster_plan,
    cluster_smem_bytes,
    elem_a,
    pdhg_route,
    pdhg_solve_batch,
    shared_a,
)
from distilp_tpu.ops import LPBatch as JBatch  # noqa: E402
from distilp_tpu.ops import pdhg_solve_batch as j_pdhg  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module: the plain PDHG's many small
    products each open a parallel region, which with several test
    processes on few cores costs far more than the product."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GAP = 1e-3
F32, F64 = torch.float32, torch.float64
# The fleet LPs (make_synthetic_fleet(M, seed=123) on the online profile
# stretched to 2M layers) have m = 6M+1 rows, n = 13M+1 columns and 30.75 M
# nonzeros; the route at each M and dtype, and the sizes where it changes
# (chip_smoke.py holds both routes just below and above each edge).
ROUTES = {(4, F32): 1, (4, F64): 1, (16, F32): 1, (16, F64): 1, (128, F32): 1,
          (128, F64): 2, (512, F32): 4, (512, F64): 8, (2048, F32): 0, (2048, F64): 0}
EDGES = {F32: [(181, 1), (182, 2), (341, 2), (342, 4), (609, 4), (610, 8), (1002, 8),
               (1003, 0)],
         F64: [(105, 1), (106, 2), (196, 2), (197, 4), (344, 4), (345, 8), (553, 8),
               (554, 0)]}
_STRUCTURES = {}


def _fleet_roots(M):
    """The M-device fleet's root batch (host numpy, float64)."""
    from pathlib import Path

    from distilp_torch.common import load_model_profile
    from distilp_torch.solver.api import _build_instance
    from distilp_torch.solver.backend_torch import device_arrays
    from distilp_torch.solver.standard_form import build_standard_form
    from distilp_torch.utils import make_synthetic_fleet, stretch_model_for_fleet

    model = load_model_profile(
        Path(__file__).parent / "profiles" / "llama_3_70b" / "online" / "model_profile.json")
    if M > model.L:
        model = stretch_model_for_fleet(model, M)
    Ks, _, coeffs, arrays = _build_instance(make_synthetic_fleet(M, seed=123), model, None,
                                            "4bit", None, None)
    feasible = [(k, model.L // k) for k in Ks if model.L // k >= M]
    host = device_arrays(build_standard_form(arrays, coeffs, feasible))
    return tuple(np.asarray(host[k], np.float64) for k in ("A", "b_k", "c_k", "lo_k", "hi_k"))


def _structure(M):
    if M not in _STRUCTURES:
        _STRUCTURES[M] = ipm_sparsity(torch.as_tensor(_fleet_roots(M)[0] != 0))
    return _STRUCTURES[M]


def _fleet_shape(M):
    return 6 * M + 1, 13 * M + 1, int(30.75 * M)


# ----------------------------------------------------------- route and plan


@pytest.mark.parametrize("M,dtype", sorted(ROUTES, key=lambda k: (k[0], str(k[1]))))
def test_route_and_ownership_plan(M, dtype):
    """Every row and column owned by exactly one CTA, each CTA's bytes
    (replicas included) within an H100 block's shared memory, the long row
    and column flagged, C the least that fits or the grid route when none
    does. The 2048-device instance (2.6 GB dense in float64) is not built:
    its shape follows the family's (held on the built ones)."""
    C = ROUTES[(M, dtype)]
    if M == 2048:
        assert pdhg_route(*_fleet_shape(M), dtype) == ("grid", 0)
        return
    sp = _structure(M)
    assert (sp.m, sp.n, sp.nnz) == _fleet_shape(M)
    assert pdhg_route(sp.m, sp.n, sp.nnz, dtype) == ("cluster", C)
    assert P.kernel_route(sp, dtype)[:2] == ("cluster", C)
    if C > 1:  # no smaller cluster holds it
        assert pdhg_route(sp.m, sp.n, sp.nnz, dtype, c_max=C // 2) == ("grid", 0)
    t = torch.empty((), dtype=dtype).element_size()
    plan = cluster_plan(sp, t, C)
    assert plan.C == C and plan.rows[0] == 0 and plan.rows[-1] == sp.m
    assert plan.cols[0] == 0 and plan.cols[-1] == sp.n
    assert list(plan.rows) == sorted(plan.rows) and list(plan.cols) == sorted(plan.cols)
    parts = sp.parts()
    a_ptr, t_ptr = parts["a_ptr"].numpy(), parts["t_ptr"].numpy()
    rlen, clen = np.diff(a_ptr), np.diff(t_ptr)
    long_r, long_c = [], []
    for r in range(C):
        r0, r1, c0, c1 = plan.rows[r], plan.rows[r + 1], plan.cols[r], plan.cols[r + 1]
        assert plan.counts[r] == (r1 - r0, c1 - c0, a_ptr[r1] - a_ptr[r0], t_ptr[c1] - t_ptr[c0])
        assert plan.bytes[r] == cluster_smem_bytes(sp.m, sp.n, *plan.counts[r], t)
        assert plan.bytes[r] <= SMEM_LIMIT
        long_r += [r0 + i for i in plan.long_rows[r]]
        long_c += [c0 + j for j in plan.long_cols[r]]
    assert plan.smem == max(plan.bytes)
    assert long_r == np.nonzero(rlen > LONG_NNZ)[0].tolist()
    assert long_c == np.nonzero(clen > LONG_NNZ)[0].tolist()
    if M > LONG_NNZ:  # the M-long row and the 2M-long column
        assert rlen.max() == M and rlen[long_r].min() == M
        assert clen.max() == 2 * M and 2 * M in clen[long_c]
    buf = plan.buf.tolist()
    assert buf[:C + 1] == list(plan.rows) and buf[C + 1:2 * C + 2] == list(plan.cols)
    assert len(buf) == 4 * (C + 1) + len(long_r) + len(long_c)
    assert cluster_plan(sp, t, C) is plan  # once per structure


@pytest.mark.parametrize("dtype", [F32, F64])
def test_route_edges(dtype):
    """The sizes of the fleet family where the cluster size changes, and
    where the grid route takes over."""
    for M, C in EDGES[dtype]:
        assert pdhg_route(*_fleet_shape(M), dtype) == (("cluster", C) if C else ("grid", 0)), M


def test_route_respects_the_cards_largest_cluster():
    m, n, nnz = _fleet_shape(512)
    assert pdhg_route(m, n, nnz, F32, c_max=8) == ("cluster", 4)
    assert pdhg_route(m, n, nnz, F32, c_max=2) == ("grid", 0)
    assert pdhg_route(m, n, nnz, F32, c_max=0) == ("grid", 0)


# ------------------------------------------------------- shared A as values


def _random_batch(B=3, m=6, n=11, seed=3):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)) * (rng.random((m, n)) < 0.5)
    l = rng.uniform(-1, 0, (B, n))
    u = l + rng.uniform(0.5, 2, (B, n))
    x = l + rng.random((B, n)) * (u - l)
    return LPBatch(*(torch.tensor(a) for a in (A, x @ A.T, rng.normal(size=(B, n)), l, u)))


def test_shared_values_keep_a_batch_stride_of_zero():
    batch = _random_batch()
    sp = ipm_sparsity(batch.A != 0)
    ea = shared_a(batch.A, 3, sp)
    assert ea.shared and ea.values.shape == (3, sp.nnz) and ea.values.stride() == (0, 1)
    assert torch.equal(ea.matrix(), batch.A)
    assert torch.equal(ea.dense(), batch.A.expand(3, *batch.A.shape))
    one = shared_a(batch.A, 1, sp)
    assert one.shared and one.values.stride(0) == 0
    v32 = cast_values(ea.values, F32)
    assert v32.stride() == (0, 1) and torch.equal(v32[2], ea.values[0].float())
    assert not elem_a(batch.A.expand(3, *batch.A.shape).clone(), sp).shared
    assert ea._replace(values=ea.values[1:3]).shared


@pytest.mark.parametrize("kw", [dict(iters=64), dict(iters=96, chunk=8, trace=True),
                                dict(iters=64, dtype="f32"), "warm"])
def test_2d_a_with_sparsity_equals_the_dense_shared_path(kw):
    """A 2-D A with ``sparsity=`` (its values with a batch stride of 0) and
    the dense shared path agree bit for bit in the plain version."""
    batch = _random_batch()
    if kw == "warm":
        pre = pdhg_solve_batch(batch, iters=16)
        kw = dict(iters=64, skip=torch.tensor([False, True, False]),
                  warm=PDHGWarmState(pre.v, pre.y_dual, pre.z_dual, pre.f_dual,
                                     torch.tensor([True, True, False])))
    sp = ipm_sparsity(batch.A != 0)
    dense = pdhg_solve_batch(batch, **kw)
    vals = pdhg_solve_batch(batch, sparsity=sp, **kw)
    for f in dense._fields:
        a, b = getattr(dense, f), getattr(vals, f)
        assert (a is None and b is None) or torch.equal(a, b), f


def test_2d_a_refuses_a_structure_it_does_not_fit():
    batch = _random_batch()
    short = batch.A != 0
    short[tuple(t[0] for t in short.nonzero(as_tuple=True))] = False
    with pytest.raises(ValueError, match="outside the sparsity pattern"):
        pdhg_solve_batch(batch, iters=4, sparsity=ipm_sparsity(short))
    with pytest.raises(ValueError, match="dense"):
        pdhg_solve_batch(batch._replace(A=shared_a(batch.A, 3)), iters=4,
                         sparsity=ipm_sparsity(batch.A != 0))


@pytest.mark.parametrize("M", [4, 16])
def test_2d_a_with_sparsity_matches_jax_on_halda_roots(M):
    """The HALDA roots at float64 with A given as its structure and values,
    against the JAX package's dense shared A."""
    arrs = _fleet_roots(M)
    port = LPBatch(*(torch.tensor(a) for a in arrs))
    got = pdhg_solve_batch(port, iters=2000, sparsity=ipm_sparsity(port.A != 0))
    ref = j_pdhg(JBatch(*(jax.numpy.asarray(a) for a in arrs)), iters=2000)
    b_ref = np.asarray(ref.bound)
    np.testing.assert_allclose(got.bound.numpy(), b_ref, rtol=1e-7,
                               atol=1e-7 * max(1.0, float(np.abs(b_ref).max())))
    for f in ("v", "y_dual"):
        r = np.asarray(getattr(ref, f))
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(getattr(got, f).numpy(), r, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=f)
    d_it = np.abs(got.iters_run.numpy().astype(np.int64) - np.asarray(ref.iters_run))
    assert d_it.max() <= P.PDHG_DEFAULT_CHUNK
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))


# ------------------------------------------------------------- the search


def test_shared_sweep_builds_structure_and_values_once(monkeypatch):
    """A ``halda_solve(lp_backend='pdhg')`` sweep on one shared A, on the
    host loop (the route of the row mesh and the convergence log), builds
    its structure and gathers its values once, hands every round the values
    with a batch stride of 0, and lands exactly where the dense shared path
    does (the north star's pin)."""
    from pathlib import Path

    from distilp_torch.common import load_model_profile
    from distilp_torch.solver import device_loop as DL
    from distilp_torch.solver import halda_solve
    from distilp_torch.solver import packed as PK
    from distilp_torch.solver import search as S
    from distilp_torch.utils import make_synthetic_fleet

    model = load_model_profile(
        Path(__file__).parent / "profiles" / "llama_3_70b" / "online" / "model_profile.json")
    calls = {"node_sparsity": 0, "sweep_values": 0}
    seen = []
    # The structure and values are built once per static entry (the
    # sweep's A on the device, cached across solves): start without one.
    PK.clear_static_cache()
    for name in calls:
        real = getattr(S, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(S, name, counted)
    real_solve = S.pdhg_solve_batch
    monkeypatch.setattr(S, "pdhg_solve_batch",
                        lambda batch, **kw: seen.append(batch.A) or real_solve(batch, **kw))

    def solve():
        with warnings.catch_warnings(), DL.host_loop():
            warnings.simplefilter("ignore")
            return halda_solve(make_synthetic_fleet(16, seed=123), model, mip_gap=GAP,
                               kv_bits="4bit", device="cpu", lp_backend="pdhg")

    got = solve()
    assert calls == {"node_sparsity": 1, "sweep_values": 1}
    assert seen and all(isinstance(a, ElemA) and a.shared for a in seen)
    rounds = len(seen)
    # The dense shared path: no values for the sweep.
    monkeypatch.setattr(S, "sweep_values", lambda *a, **k: (None, None))
    PK.clear_static_cache()
    seen.clear()
    dense = solve()
    # No entry built with the stand-in's values may outlive this test.
    PK.clear_static_cache()
    assert seen and all(isinstance(a, torch.Tensor) and a.dim() == 2 for a in seen)
    assert len(seen) == rounds
    assert (got.k, got.w, got.n, got.obj_value, got.certified) == \
        (dense.k, dense.w, dense.n, dense.obj_value, dense.certified)
    assert got.certified and got.k == 1
    assert got.obj_value == pytest.approx(-38.374803, rel=2 * GAP)


# ------------------------------------------------- the wrapper's launches


class _Lib:
    """Stands in for the built libraries: records each launch's arguments."""

    def __init__(self, c_max=8):
        self.c_max = c_max
        self.cluster, self.grid = [], []

    def dtk_pdhgc_max_cluster(self, is_f64):
        return self.c_max

    def dtk_pdhgc_smem_bytes(self, m, n, nr, nc, zr, zc, is_f64):
        return cluster_smem_bytes(m, n, nr, nc, zr, zc, 8 if is_f64 else 4)

    def _cluster(self, sp, plan, C, nnz, vals, vstride, *rest):
        self.cluster.append(dict(C=C, nnz=nnz, vstride=vstride, B=rest[8], smem=rest[16],
                                 long_nnz=rest[15]))
        return 0

    dtk_pdhgc_f32 = dtk_pdhgc_f64 = _cluster

    def dtk_pdhg_grid(self, is_f64):
        return 132

    def dtk_pdhg_ws_bytes(self, B, m, n, is_f64):
        return 64

    def _grid(self, sp, nnz, vals, vstride, *rest):
        self.grid.append(dict(nnz=nnz, vstride=vstride, B=rest[8]))
        return 0

    dtk_pdhg_elem_f32 = dtk_pdhg_elem_f64 = _grid


@pytest.fixture
def lib(monkeypatch):
    fake = _Lib()
    monkeypatch.setattr(build, "library", lambda name: fake)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: ctypes.c_void_p(None))
    monkeypatch.setattr(P, "_cluster_max", lambda dev, f64: fake.c_max)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    kernels.reset_launch_counts()
    yield fake
    kernels.reset_launch_counts()


def _launch(batch, **kw):
    tol = P._default_tol_pdhg(batch.b.dtype)
    return P._pdhg_kernel(batch, kw.pop("iters", 64), tol, 0.2, kw.pop("warm", None),
                          None, P.PDHG_DEFAULT_CHUNK, kw.pop("trace", False))


def test_wrapper_launches_the_cluster_route_once(lib):
    """A shared A (stride 0) counts as "pdhg", a per-element one (stride
    nnz) as "pdhg_elem", a traced launch as "pdhg_trace"; each one launch
    for the whole batch, its shape key ending in the route."""
    batch = _random_batch(B=20)
    sp = ipm_sparsity(batch.A != 0)
    _launch(batch._replace(A=shared_a(batch.A, 20, sp)))
    A3 = batch.A.expand(20, *batch.A.shape) * torch.linspace(1, 2, 20)[:, None, None]
    _launch(batch._replace(A=elem_a(A3, sp)))
    _launch(batch._replace(A=shared_a(batch.A, 20, sp)), trace=True)
    assert [(c["C"], c["vstride"], c["B"], c["long_nnz"]) for c in lib.cluster] == \
        [(1, 0, 20, LONG_NNZ), (1, sp.nnz, 20, LONG_NNZ), (1, 0, 20, LONG_NNZ)]
    assert all(c["smem"] == cluster_plan(sp, 8, 1).smem for c in lib.cluster)
    assert kernels.LAUNCHES["pdhg"] == kernels.LAUNCHES["pdhg_elem"] == 1
    assert kernels.LAUNCHES["pdhg_trace"] == 1 and not lib.grid
    key = "B=20 m=6 n=11 route=cluster1"
    assert kernels.SHAPES["pdhg"] == {key: 1} and kernels.SHAPES["pdhg_trace"] == {key: 1}
    assert kernels.SHAPES["pdhg_elem"] == {
        f"B=20 m=6 n=11 per-element A nnz={sp.nnz} route=cluster1": 1}


def test_wrapper_takes_the_grid_route_past_every_cluster(lib):
    """With no cluster the card schedules, the grid route in slices of
    BMAX elements, a shared A still at stride 0."""
    lib.c_max = 0
    batch = _random_batch(B=20)
    _launch(batch._replace(A=shared_a(batch.A, 20)))
    assert not lib.cluster and [(g["vstride"], g["B"]) for g in lib.grid] == [(0, 16), (0, 4)]
    assert kernels.SHAPES["pdhg"] == {"B=20 m=6 n=11 route=grid": 2}


def test_wrapper_reads_a_as_values_only(lib):
    batch = _random_batch()
    with pytest.raises(TypeError, match="ElemA"):
        _launch(batch)


def test_kernel_sources_and_layout_agree_and_the_dense_route_is_gone():
    """The cluster kernel is built and described, its layout constants are
    the wrapper's, and no entry reads a dense A any more."""
    assert build.SOURCES["pdhg_cluster"] == ("pdhg_cluster_kernel.cu", [])
    text = (build.CSRC / "pdhg_cluster_kernel.cu").read_text()
    assert "Replaces distilp_tpu/ops/pdhg.py::_pdhg_single" in text
    assert "What bounds it on an H100" in text and "pdhg_cluster_kernel" in text
    for name, v in (("HEAD_BYTES", P.HEAD_BYTES), ("SMEM_LIMIT", SMEM_LIMIT),
                    ("CLUSTER_MAX", P.CLUSTER_SIZES[-1])):
        assert re.search(rf"constexpr \w+ {name} = {v};", text), name
    for enum, n in (("V_CSA", P.N_COLV), ("R_ROWS", P.N_ROWV)):
        body = re.search(rf"enum {{ ({enum}[^}}]*)}};", text).group(1)
        assert len(body.split(",")) - 1 == n, enum
    for fn in ("dtk_pdhgc_f32", "dtk_pdhgc_f64", "dtk_pdhgc_max_cluster",
               "dtk_pdhgc_smem_bytes"):
        assert fn in build.SIGNATURES["pdhg_cluster"] and re.search(rf"\b{fn}\(", text), fn
    grid = (build.CSRC / "pdhg_kernel.cu").read_text()
    assert "dtk_pdhg_f32" not in grid and "launch_shared" not in grid and "kElem" not in grid
    assert set(build.SIGNATURES["pdhg"]) == {"dtk_pdhg_grid", "dtk_pdhg_ws_bytes",
                                             "dtk_pdhg_elem_f32", "dtk_pdhg_elem_f64"}
    assert ".t().contiguous()" not in inspect.getsource(P)
