"""K6b's two CUDA routes (``distilp_torch/ops/meshlp.py``) on the CPU: which
route a mesh takes, the fused launch's group split, and how the host packs a
slice for the fused entry (every shard's slots side by side, one launch and
one count a slice) and for the sequenced one (a launch per phase per shard).

The kernels need the card; here a stand-in library records the calls the
wrappers make, so the tests see the arguments and the counts, not the
arithmetic (``chip_smoke.py`` holds the two routes bit for bit on the card;
the plain version's parity with the JAX package is ``test_torch_meshlp.py``).
"""

import contextlib
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distilp_torch import kernels  # noqa: E402
from distilp_torch.kernels import build  # noqa: E402
from distilp_torch.ops import meshlp  # noqa: E402
from distilp_torch.ops.ipm import LPBatch  # noqa: E402
from distilp_torch.ops.meshlp import (  # noqa: E402
    N_INT,
    N_PTR,
    P_COMMIT,
    P_SETUP_A,
    P_STEP,
    group_blocks,
    kernel_route,
    sharded_pdhg,
)
from distilp_torch.ops.pdhg import BMAX, PDHGWarmState, elem_a  # noqa: E402
from distilp_torch.parallel import Mesh  # noqa: E402

CUDA0 = torch.device("cuda", 0)
CPU = torch.device("cpu")


def _batch(B, m=7, n=9, elem=False, seed=5):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)) * (rng.random((m, n)) < 0.6)
    if elem:
        A = np.stack([A * rng.uniform(0.5, 1.5, (m, n)) for _ in range(B)])
    l = rng.uniform(-1, 0, (B, n))
    u = l + rng.uniform(0.5, 2, (B, n))
    x = l + rng.random((B, n)) * (u - l)
    b = np.einsum("bmn,bn->bm", A, x) if elem else x @ A.T
    t = [torch.tensor(a) for a in (A, b, rng.normal(size=(B, n)), l, u)]
    if elem:
        t[0] = elem_a(t[0], None)
    return LPBatch(*t)


class _Lib:
    """Stands in for the built library: records each launch's arguments."""

    def __init__(self, grid=8, fail=0):
        self.grid, self.fail = grid, fail
        self.fused, self.phases = [], []

    def dtk_pdhgs_fused_grid(self, is_f64, elem):
        return self.grid

    def dtk_pdhgs_fused_max_shards(self):
        return 64

    def dtk_pdhgs_grid(self, is_f64):
        return self.grid

    dtk_pdhgs_elem_grid = dtk_pdhgs_grid

    def dtk_pdhgs_ws_bytes(self, B, ms, n, G, is_f64):
        return 64

    def _fused(self, S, P, I, D, ws, warm, stream):
        self.fused.append(dict(S=S, P=list(P), I=list(I), ws=list(ws)[:S], warm=warm))
        return self.fail

    dtk_pdhgs_fused_f32 = dtk_pdhgs_fused_f64 = _fused
    dtk_pdhgs_elem_fused_f32 = dtk_pdhgs_elem_fused_f64 = _fused

    def _phase(self, phase, P, I, D, ws_len, stream):
        self.phases.append((phase, I[6]))
        return self.fail

    dtk_pdhgs_f32 = dtk_pdhgs_f64 = dtk_pdhgs_elem_f32 = dtk_pdhgs_elem_f64 = _phase


@pytest.fixture
def lib(monkeypatch):
    """The stand-in library behind ``library("pdhg_sharded")``, CPU tensors
    taken for CUDA ones by the wrapper."""
    fake = _Lib()
    monkeypatch.setattr(build, "library", lambda name: fake)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: ctypes.c_void_p(None))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    kernels.reset_launch_counts()
    yield fake
    kernels.reset_launch_counts()


def _run(batch, S, sequenced=False, warm=None, iters=32):
    mesh = Mesh((CPU,) * S, True)
    m = batch.b.shape[1]
    A_b, b_b, wv, wy_b, wok = meshlp.shard_rows(batch, S, warm)
    return meshlp._sharded_kernel(A_b, b_b, batch, wv, wy_b, wok, None, mesh, iters, 1e-6,
                                  0.2, 16, False, m, sequenced)


def test_route_follows_the_mesh_layout():
    """Every shard on one device: fused; shards over distinct devices:
    sequenced; CPU tensors: the plain version, whatever the layout."""
    assert kernel_route(Mesh((CUDA0,) * 4, True), True) == "fused"
    assert kernel_route(Mesh((CUDA0,), False), True) == "fused"
    two = Mesh((CUDA0, torch.device("cuda", 1)), False)
    assert kernel_route(two, True) == "sequenced"
    assert kernel_route(Mesh(two.devices * 2, True), True) == "sequenced"
    for mesh in (Mesh((CPU,) * 4, True), two):
        assert kernel_route(mesh, False) == "plain"


@pytest.mark.parametrize("G,S,Gs", [(132, 1, 132), (132, 2, 66), (132, 4, 33), (132, 5, 26),
                                    (132, 64, 2), (4, 4, 1)])
def test_group_split(G, S, Gs):
    """S groups of G // S blocks, every group the same size."""
    assert group_blocks(G, S, 64) == Gs
    assert S * Gs <= G


@pytest.mark.parametrize("G,S", [(3, 4), (60, 61), (1, 2)])
def test_group_split_raises_when_shards_outnumber_blocks(G, S):
    with pytest.raises(ValueError, match="co-resident blocks"):
        group_blocks(G, S, 64)


@pytest.mark.parametrize("S", [65, 132])
def test_group_split_raises_past_the_launch_capacity(S):
    """A fused launch carries at most the library's count of shards."""
    with pytest.raises(ValueError, match="at most 64 shards"):
        group_blocks(132, S, 64)


@pytest.mark.parametrize("elem", [False, True])
@pytest.mark.parametrize("B", [3, BMAX + 2])
def test_fused_route_packs_every_shard_into_one_launch_a_slice(lib, elem, B):
    """One fused launch (and one count, under the entry's name and the
    fused route) per slice of at most BMAX elements; each launch carries
    the S shards' slots one after another, the group size G // S in every
    shard's grid slot, no phase launch and no collective."""
    S = 3
    _run(_batch(B, elem=elem), S)
    slices = -(-B // BMAX)
    assert len(lib.fused) == slices and not lib.phases
    for call, width in zip(lib.fused, (min(B, BMAX), B - BMAX)):
        assert call["S"] == S and call["warm"] == 0
        assert len(call["P"]) == S * N_PTR and len(call["I"]) == S * N_INT
        ints = [call["I"][s * N_INT:(s + 1) * N_INT] for s in range(S)]
        assert all(i[0] == width and i[6] == group_blocks(lib.grid, S, 64) for i in ints)
        # each shard's own buffers: no two shards share a workspace
        ws = [call["P"][s * N_PTR + 10] for s in range(S)]
        assert len(set(ws)) == S and call["ws"] == [64] * S
    name = "pdhg_sharded_elem" if elem else "pdhg_sharded"
    assert kernels.LAUNCHES[name] == slices and kernels.LAUNCHES["collective"] == 0
    (shape, count), = kernels.SHAPES[name].items()
    assert shape.endswith(" route=fused") and count == slices


def test_fused_route_passes_the_warm_flag(lib):
    batch = _batch(3)
    B, n = batch.c.shape
    zeros = dict(dtype=torch.float64)
    warm = PDHGWarmState(v=batch.l.clone(), y=torch.zeros(B, batch.b.shape[1], **zeros),
                         z=torch.zeros(B, n, **zeros), f=torch.zeros(B, n, **zeros),
                         ok=torch.ones(B, dtype=torch.bool))
    _run(batch, 2, warm=warm)
    assert [c["warm"] for c in lib.fused] == [1]


def test_sequenced_route_runs_phases_at_the_group_grid(lib):
    """The card check's sequenced route on one device: a launch per phase per
    shard at the fused route's per-shard grid, the collectives between
    them, counted under the sequenced route."""
    S = 2
    _run(_batch(3), S, sequenced=True, iters=32)
    assert not lib.fused
    phases = [p for p, _ in lib.phases]
    assert phases[:S] == [P_SETUP_A] * S
    assert phases.count(P_STEP) == phases.count(P_COMMIT) == 32 * S
    assert {g for _, g in lib.phases} == {group_blocks(lib.grid, S, 64)}
    (shape, count), = kernels.SHAPES["pdhg_sharded"].items()
    assert shape.endswith(" route=sequenced") and count == len(lib.phases)
    assert kernels.LAUNCHES["collective"] == 0  # CPU parts: the plain collectives


def test_fused_launch_failure_raises_and_never_falls_back(lib):
    lib.fail = 700
    with pytest.raises(RuntimeError, match="pdhg_sharded fused kernel launch failed"):
        _run(_batch(3), 2)
    assert len(lib.fused) == 1 and not lib.phases
    assert kernels.LAUNCHES["pdhg_sharded"] == 0


def test_fused_route_raises_when_shards_outnumber_the_card(lib):
    lib.grid = 3
    with pytest.raises(ValueError, match="co-resident blocks"):
        _run(_batch(3), 4)
    assert not lib.fused and not lib.phases


def test_private_sequenced_flag_keeps_the_plain_version_on_the_cpu(monkeypatch):
    """CPU tensors take the plain version whatever the flag: the same bits."""
    monkeypatch.setenv("DISTILP_TORCH_VIRTUAL_DEVICES", "4")
    batch = _batch(3)
    a = sharded_pdhg(batch, 2, 200, 1e-6, 0.2)
    b = sharded_pdhg(batch, 2, 200, 1e-6, 0.2, _sequenced=True)
    for x, y in zip(a, b):
        if x is not None:
            assert torch.equal(x, y)
