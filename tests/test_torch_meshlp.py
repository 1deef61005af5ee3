"""The port's row-sharded PDHG (K6b, ``distilp_torch/ops/meshlp.py``) and its
collectives against the JAX package's ``ops/meshlp.py`` on the CPU, with one
shared A and with one A per element (MoE nodes: the port's ``ElemA``, each
element's values on one union structure, split by row block).

The JAX side runs ``shard_map`` on conftest's eight virtual CPU devices; the
port runs its plain versions (a loop over the shards inside each step, the
collectives as fixed-order sums) on a virtual CPU mesh. Inputs are made from
a seed with numpy. Tolerances are the reference's own
(``tests/test_meshlp.py``): objectives and bounds within 1e-9 (relative and
absolute), duals within 1e-7 relative, 1e-9 absolute; the same hold against
the port's unsharded engine, and one shard is the unsharded call bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from distilp_tpu.ops import LPBatch as JBatch  # noqa: E402
from distilp_tpu.ops import pdhg_solve_batch as jax_pdhg  # noqa: E402
from distilp_tpu.ops import pdhg_solve_batch_sharded as jax_sharded  # noqa: E402
from distilp_tpu.ops.pdhg import PDHGWarmState as JWarm  # noqa: E402

from distilp_torch.common import load_from_profile_folder, load_model_profile  # noqa: E402
from distilp_torch.ops.ipm import LPBatch  # noqa: E402
from distilp_torch.ops.meshlp import (  # noqa: E402
    pad_rows_to,
    pdhg_solve_batch_mp,
    pdhg_solve_batch_sharded,
    row_blocks,
    shard_rows,
    sharded_pdhg,
    sharded_pdhg_reference,
)
from distilp_torch.ops.pdhg import (  # noqa: E402
    ElemA,
    PDHGWarmState,
    elem_a,
    pdhg_solve_batch,
    pdhg_solve_batch_reference,
)
from distilp_torch.parallel import (  # noqa: E402
    VIRTUAL_DEVICES_ENV,
    Mesh,
    force_virtual_devices,
    shard_mesh,
)
from distilp_torch.parallel.collectives import (  # noqa: E402
    AllReduce,
    all_gather,
    allreduce_reference,
    pmax,
    psum,
)
from distilp_torch.solver import StreamingReplanner, halda_solve  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402

SHARDS = 4
GAP = 1e-3
GOLDEN = [
    ("hermes_70b", 40, 29.643569),
    ("llama_3_70b/4bit", 8, 12.834690),
    ("llama_3_70b/online", 2, 1.934942),
    ("qwen3_32b/bf16", 16, 12.072837),
]
NORTH_STAR_GAP3 = -38.36824122348659  # the JAX package at gap 1e-3
# Mixtral 8x7B on make_synthetic_fleet(4, seed=7, pool_bytes=64e9), kv 8bit,
# gap 1e-3, PDHG engine: the JAX package's optimum on 2 shards (and on 1).
MIXTRAL_M4 = (4, -132.93320566181376, [1, 5, 1, 1])


@pytest.fixture
def one_thread():
    """One intra-op thread for the test: the per-element plain versions'
    many small batched products each open a parallel region, which with
    several test processes on few cores costs far more than the product."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def vmesh(monkeypatch):
    """A virtual mesh of 8 devices declared for the test (the counterpart of
    conftest's forced host-device count)."""
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "8")


def _random_feasible(rng, m, n, B, fix_frac=0.2):
    """B feasible boxed LPs sharing one A, with their HiGHS optima."""
    from scipy.optimize import linprog

    A = rng.normal(size=(m, n))
    bs, cs, ls, us, refs = [], [], [], [], []
    for _ in range(B):
        l = rng.uniform(-2, 0, n)
        u = l + rng.uniform(0.5, 3, n)
        u = np.where(rng.random(n) < fix_frac, l, u)
        x = l + rng.uniform(0, 1, n) * (u - l)
        b = A @ x
        c = rng.normal(size=n)
        r = linprog(c, A_eq=A, b_eq=b, bounds=np.stack([l, u], 1), method="highs")
        assert r.status == 0
        refs.append(r.fun)
        bs.append(b)
        cs.append(c)
        ls.append(l)
        us.append(u)
    return (A, np.array(bs), np.array(cs), np.array(ls), np.array(us)), np.array(refs)


def _random_feasible_elem(rng, m, n, B):
    """B feasible boxed LPs with an A each on one sparse pattern (about 60%
    nonzero; element 0 has an explicit zero inside the union), with their
    HiGHS optima."""
    from scipy.optimize import linprog

    pattern = rng.random((m, n)) < 0.6
    A3 = np.where(pattern, rng.normal(size=(B, m, n)), 0.0)
    A3[0][np.argwhere(pattern)[0][0], np.argwhere(pattern)[0][1]] = 0.0
    bs, cs, ls, us, refs = [], [], [], [], []
    for e in range(B):
        l = rng.uniform(-2, 0, n)
        u = l + rng.uniform(0.5, 3, n)
        x = l + rng.uniform(0, 1, n) * (u - l)
        b = A3[e] @ x
        c = rng.normal(size=n)
        r = linprog(c, A_eq=A3[e], b_eq=b, bounds=np.stack([l, u], 1), method="highs")
        assert r.status == 0
        refs.append(r.fun)
        bs.append(b)
        cs.append(c)
        ls.append(l)
        us.append(u)
    return (A3, np.array(bs), np.array(cs), np.array(ls), np.array(us)), np.array(refs)


def _port(arrs, dtype=torch.float64):
    return LPBatch(*(torch.tensor(np.asarray(a), dtype=dtype) for a in arrs))


def _jax(arrs, dtype=jnp.float64):
    return JBatch(*(jnp.asarray(np.asarray(a), dtype) for a in arrs))


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


# ------------------------------------------------------------- kernel level


def test_sharded_matches_jax_and_unsharded(vmesh):
    """m=10 rows on 4 shards (padded to 12) against the JAX package's
    sharded solve and the port's unsharded one."""
    arrs, refs = _random_feasible(np.random.default_rng(42), m=10, n=25, B=6)
    assert pad_rows_to(10, SHARDS) == 12
    got = pdhg_solve_batch_sharded(_port(arrs), tol=1e-8, mesh_shards=SHARDS, iters=20000)
    want = jax_sharded(_jax(arrs), tol=1e-8, mesh_shards=SHARDS, iters=20000)
    flat = pdhg_solve_batch(_port(arrs), iters=20000, tol=1e-8)
    assert bool(got.converged.all())
    assert got.y_dual.shape == (6, 10)
    for ref in (want, flat):
        _close(got.obj, ref.obj, 1e-9, 1e-9)
        _close(got.bound, ref.bound, 1e-9, 1e-9)
        _close(got.y_dual, ref.y_dual, 1e-7, 1e-9)
    np.testing.assert_array_equal(got.iters_run.numpy(), np.asarray(want.iters_run))
    assert np.all(got.bound.numpy() <= refs + 1e-6)


def test_one_shard_is_the_unsharded_call_bit_for_bit():
    arrs, _ = _random_feasible(np.random.default_rng(7), m=9, n=20, B=4)
    one = pdhg_solve_batch_sharded(_port(arrs), mesh_shards=1, iters=5000)
    flat = pdhg_solve_batch(_port(arrs), iters=5000)
    for f in one._fields:
        a, b = getattr(one, f), getattr(flat, f)
        assert (a is None and b is None) or torch.equal(a, b), f


def test_sharded_plain_version_over_its_blocks(vmesh):
    """The plain version over the row blocks equals the padded-row solve,
    and its padded rows carry a zero dual."""
    arrs, _ = _random_feasible(np.random.default_rng(5), m=10, n=25, B=3)
    batch = _port(arrs)
    A_b, b_b, *_ = shard_rows(batch, SHARDS)
    assert [a.shape[0] for a in A_b] == [3] * 4 and float(A_b[-1][-2:].abs().sum()) == 0.0
    res = sharded_pdhg_reference(A_b, b_b, batch.c, batch.l, batch.u, 20000, 1e-8, 0.2)
    assert res.y_dual.shape == (3, 12) and float(res.y_dual[:, 10:].abs().max()) == 0.0
    full = sharded_pdhg(batch, SHARDS, 20000, 1e-8, 0.2)
    assert torch.equal(full.y_dual, res.y_dual[:, :10]) and torch.equal(full.bound, res.bound)


def test_sharded_trace_matches_the_unsharded_trace(vmesh):
    arrs, _ = _random_feasible(np.random.default_rng(8), m=10, n=25, B=3)
    got = pdhg_solve_batch_sharded(_port(arrs), mesh_shards=SHARDS, iters=2000, trace=True)
    flat = pdhg_solve_batch(_port(arrs), iters=2000, trace=True)
    assert got.trace_buf.shape == flat.trace_buf.shape
    np.testing.assert_array_equal(got.trace_buf[..., [0, 4, 5]].numpy(),
                                  flat.trace_buf[..., [0, 4, 5]].numpy())
    _close(got.trace_buf, flat.trace_buf, 1e-7, 1e-9)


def test_sharded_warm_states_interchange(vmesh):
    """Warm states cross the mesh boundary both ways and across the two
    packages: full-array coordinates, no shard count baked in."""
    B = 6
    arrs, refs = _random_feasible(np.random.default_rng(11), m=10, n=25, B=B)
    cold = pdhg_solve_batch_sharded(_port(arrs), tol=1e-8, mesh_shards=SHARDS, iters=20000)
    assert bool(cold.converged.all())
    warm = PDHGWarmState(cold.v, cold.y_dual, cold.z_dual, cold.f_dual,
                         torch.ones(B, dtype=torch.bool))
    w_u = pdhg_solve_batch(_port(arrs), iters=20000, tol=1e-8, warm=warm)
    assert bool(w_u.converged.all())
    assert int(w_u.iters_run.max()) < int(cold.iters_run.max())
    _close(w_u.obj, refs, 1e-5, 1e-5)
    # The port's sharded iterate warm-starts the JAX package's sharded and
    # unsharded solves.
    jw = JWarm(*(jnp.asarray(t.numpy()) for t in warm))
    for j in (jax_sharded(_jax(arrs), tol=1e-8, warm=jw, mesh_shards=SHARDS, iters=20000),
              jax_pdhg(_jax(arrs), iters=20000, tol=1e-8, warm=jw)):
        assert np.all(np.asarray(j.converged))
        assert np.asarray(j.iters_run).max() < int(cold.iters_run.max())
    # The JAX package's unsharded iterate warm-starts the port's sharded
    # solve; the skip mask freezes an element on every shard.
    ju = jax_pdhg(_jax(arrs), iters=20000, tol=1e-8)
    skip = torch.zeros(B, dtype=torch.bool)
    skip[3] = True
    w_s = pdhg_solve_batch_sharded(
        _port(arrs), tol=1e-8, mesh_shards=SHARDS, iters=20000, skip=skip,
        warm=PDHGWarmState(*(torch.tensor(np.asarray(a)) for a in
                             (ju.v, ju.y_dual, ju.z_dual, ju.f_dual)),
                           torch.ones(B, dtype=torch.bool)))
    runs = w_s.iters_run.numpy()
    assert runs[3] == 0
    live = np.delete(np.arange(B), 3)
    assert np.all(runs[live] > 0) and runs[live].max() < int(cold.iters_run.max())


def test_mp_float32_with_shards_is_sound(vmesh):
    arrs, refs = _random_feasible(np.random.default_rng(21), m=10, n=25, B=8)
    rep: dict = {}
    r32 = pdhg_solve_batch_mp(_port(arrs), mesh_shards=SHARDS, iters=40000, dtype="f32",
                              fallback_report=rep)
    r64 = pdhg_solve_batch_mp(_port(arrs), mesh_shards=SHARDS, iters=40000, dtype="f64")
    j32 = jax_sharded(_jax(arrs), mesh_shards=SHARDS, iters=40000, dtype="f32")
    assert rep["n_fallback"] == 0
    assert bool(r32.converged.all()) and bool(r64.converged.all())
    assert np.all(r32.bound.numpy() <= refs + 1e-5)
    assert np.all(r64.bound.numpy() <= refs + 1e-6)
    _close(r32.obj, refs, 2e-3, 2e-3)
    _close(r64.obj, refs, 1e-5, 1e-5)
    # The float32 certificate against the JAX package's sharded float32 run.
    _close(r32.bound, np.asarray(j32.bound), 1e-3, 1e-3)


def test_mp_nonfinite_float32_falls_back_with_shards(vmesh):
    arrs, _ = _random_feasible(np.random.default_rng(33), m=8, n=18, B=4)
    batch = _port(arrs)
    b_bad = batch.b.clone()
    b_bad[0] *= 1e39
    poisoned = batch._replace(b=b_bad)
    rep: dict = {}
    res = pdhg_solve_batch_mp(poisoned, mesh_shards=SHARDS, iters=4000, dtype="f32",
                              fallback_report=rep)
    r32 = pdhg_solve_batch_mp(poisoned, mesh_shards=SHARDS, iters=4000, dtype="f32",
                              f64_fallback=False)
    r64 = pdhg_solve_batch_mp(poisoned, mesh_shards=SHARDS, iters=4000, dtype="f64")
    bad = ~r32.converged | ~torch.isfinite(r32.bound)
    assert rep["n_fallback"] >= 1 and bool(bad[0])
    assert torch.equal(res.obj[bad], r64.obj.to(res.obj.dtype)[bad])
    assert torch.equal(res.obj[~bad], r32.obj[~bad])
    assert bool(torch.isfinite(res.bound[~bad]).all())


def test_sharded_refuses_a_per_element_a(one_thread, vmesh):
    """A per-element (B, m, n) A (m=10 rows on 2 and 4 shards, padded to 12
    on 4) against the JAX package's sharded solve of the same 3-D A and the
    port's unsharded per-element solve, at the shared-A test's tolerances."""
    arrs, refs = _random_feasible_elem(np.random.default_rng(3), m=10, n=25, B=5)
    flat = pdhg_solve_batch(_port(arrs), iters=20000, tol=1e-8)
    for S in (2, SHARDS):
        got = pdhg_solve_batch_sharded(_port(arrs), tol=1e-8, mesh_shards=S, iters=20000)
        want = jax_sharded(_jax(arrs), tol=1e-8, mesh_shards=S, iters=20000)
        assert bool(got.converged.all()) and got.y_dual.shape == (5, 10)
        for ref in (want, flat):
            _close(got.obj, ref.obj, 1e-9, 1e-9)
            _close(got.bound, ref.bound, 1e-9, 1e-9)
            _close(got.y_dual, ref.y_dual, 1e-7, 1e-9)
            _close(got.v, ref.v, 1e-7, 1e-9)
            _close(got.reduced, ref.reduced, 1e-7, 1e-9)
        np.testing.assert_array_equal(got.iters_run.numpy(), np.asarray(want.iters_run))
        np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
        assert np.all(got.bound.numpy() <= refs + 1e-6)


def test_sharded_elem_plain_version_over_its_blocks(one_thread, vmesh):
    """Each shard's values are the full values restricted to its row block,
    on a structure of its own; the plain version over those blocks equals
    the unsharded per-element plain version, and padded rows carry a zero
    dual."""
    arrs, _ = _random_feasible_elem(np.random.default_rng(5), m=10, n=25, B=3)
    batch = _port(arrs)
    A = elem_a(batch.A)
    A_b, b_b, *_ = shard_rows(batch._replace(A=A), SHARDS)
    dense = A.dense()
    for s, blk in enumerate(A_b):
        assert isinstance(blk, ElemA) and (blk.sparsity.m, blk.sparsity.n) == (3, 25)
        rows = dense[:, 3 * s:3 * s + 3]
        want = torch.cat([rows, rows.new_zeros((3, 3 - rows.shape[1], 25))], 1)
        assert torch.equal(blk.dense(), want)
    assert sum(b.sparsity.nnz for b in A_b) == A.sparsity.nnz
    res = sharded_pdhg_reference(A_b, b_b, batch.c, batch.l, batch.u, 20000, 1e-7, 0.2)
    assert res.y_dual.shape == (3, 12) and float(res.y_dual[:, 10:].abs().max()) == 0.0
    flat = pdhg_solve_batch_reference(batch, 20000, 1e-7, 0.2)
    _close(res.obj, flat.obj, 1e-9, 1e-9)
    _close(res.bound, flat.bound, 1e-9, 1e-9)
    _close(res.y_dual[:, :10], flat.y_dual, 1e-7, 1e-9)
    np.testing.assert_array_equal(res.iters_run.numpy(), flat.iters_run.numpy())
    full = sharded_pdhg(batch, SHARDS, 20000, 1e-7, 0.2, sparsity=A.sparsity)
    assert torch.equal(full.y_dual, res.y_dual[:, :10]) and torch.equal(full.bound, res.bound)
    with pytest.raises(ValueError, match="sparsity"):
        sharded_pdhg(batch._replace(A=batch.A[0]), SHARDS, 10, 1e-8, 0.2,
                     sparsity=A.sparsity)


def test_sharded_elem_trace_and_warm_states(one_thread, vmesh):
    """The per-element sharded trace equals the unsharded one, and warm
    states interchange between the sharded and unsharded per-element runs."""
    B = 4
    arrs, refs = _random_feasible_elem(np.random.default_rng(8), m=10, n=25, B=B)
    got = pdhg_solve_batch_sharded(_port(arrs), mesh_shards=SHARDS, iters=2000, trace=True)
    flat = pdhg_solve_batch(_port(arrs), iters=2000, trace=True)
    assert got.trace_buf.shape == flat.trace_buf.shape
    np.testing.assert_array_equal(got.trace_buf[..., [0, 4, 5]].numpy(),
                                  flat.trace_buf[..., [0, 4, 5]].numpy())
    _close(got.trace_buf, flat.trace_buf, 1e-7, 1e-9)
    cold = pdhg_solve_batch(_port(arrs), tol=1e-8, iters=20000)
    assert bool(cold.converged.all())
    warm = PDHGWarmState(cold.v, cold.y_dual, cold.z_dual, cold.f_dual,
                         torch.ones(B, dtype=torch.bool))
    w_s = pdhg_solve_batch_sharded(_port(arrs), tol=1e-8, mesh_shards=SHARDS, iters=20000,
                                   warm=warm)
    assert bool(w_s.converged.all())
    assert int(w_s.iters_run.max()) < int(cold.iters_run.max())
    _close(w_s.obj, refs, 1e-5, 1e-5)
    back = PDHGWarmState(w_s.v, w_s.y_dual, w_s.z_dual, w_s.f_dual,
                         torch.ones(B, dtype=torch.bool))
    w_u = pdhg_solve_batch(_port(arrs), tol=1e-8, iters=20000, warm=back)
    assert bool(w_u.converged.all())
    assert int(w_u.iters_run.max()) < int(cold.iters_run.max())


def test_mp_float32_elem_with_shards_falls_back(one_thread, vmesh):
    """The float32 run with a per-element A on shards: the poisoned element
    is re-solved in float64 and spliced in, the others stay float32's."""
    arrs, _ = _random_feasible_elem(np.random.default_rng(33), m=8, n=18, B=2)
    batch = _port(arrs)
    b_bad = batch.b.clone()
    b_bad[0] *= 1e39
    poisoned = batch._replace(b=b_bad)
    rep: dict = {}
    res = pdhg_solve_batch_mp(poisoned, mesh_shards=2, iters=4000, dtype="f32",
                              fallback_report=rep)
    r32 = pdhg_solve_batch_mp(poisoned, mesh_shards=2, iters=4000, dtype="f32",
                              f64_fallback=False)
    r64 = pdhg_solve_batch_mp(poisoned, mesh_shards=2, iters=4000, dtype="f64")
    bad = ~r32.converged | ~torch.isfinite(r32.bound)
    assert rep["n_fallback"] >= 1 and bool(bad[0])
    assert torch.equal(res.obj[bad], r64.obj.to(res.obj.dtype)[bad])
    assert torch.equal(res.obj[~bad], r32.obj[~bad])
    assert bool(torch.isfinite(res.bound[~bad]).all())


# ------------------------------------------------------------- the mesh


def test_shard_mesh_needs_devices_or_a_declared_virtual_mesh(monkeypatch):
    monkeypatch.delenv(VIRTUAL_DEVICES_ENV, raising=False)
    assert shard_mesh(1, "cpu").size == 1
    with pytest.raises(ValueError, match=VIRTUAL_DEVICES_ENV):
        shard_mesh(4, "cpu")
    with pytest.raises(ValueError, match="mesh_shards"):
        shard_mesh(0, "cpu")
    assert force_virtual_devices(4) is True
    assert force_virtual_devices(8) is False  # the first declaration stands
    mesh = shard_mesh(4, "cpu")
    assert mesh.virtual and mesh.devices == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError):
        shard_mesh(5, "cpu")
    # GPUs: the first S visible ones; past them, shard i on GPU i mod count.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    real = shard_mesh(2, "cuda")
    assert not real.virtual and [d.index for d in real.devices] == [0, 1]
    virt = shard_mesh(4, "cuda")
    assert virt.virtual and [d.index for d in virt.devices] == [0, 1, 0, 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_collectives_are_fixed_order_reductions(dtype):
    mesh = Mesh((torch.device("cpu"),) * 3, True)
    rng = np.random.default_rng(4)
    host = [rng.normal(size=(2, 5)) for _ in range(3)]
    host[1][0, 2] = np.nan
    parts = [torch.tensor(h, dtype=dtype) for h in host]
    total = parts[0] + parts[1] + parts[2]
    for out in psum(parts, mesh):
        assert torch.equal(out.nan_to_num(7.0), total.nan_to_num(7.0))
    mx = pmax(parts, mesh)
    want = torch.maximum(torch.maximum(parts[0], parts[1]), parts[2])
    for out in mx:
        assert torch.equal(out.nan_to_num(7.0), want.nan_to_num(7.0))
        assert bool(torch.isnan(out[0, 2]))
    outs = [torch.empty_like(parts[0]) for _ in range(3)]
    plan = AllReduce(parts, outs, mesh, "sum")
    plan()
    assert all(torch.equal(o.nan_to_num(7.0), total.nan_to_num(7.0)) for o in outs)
    assert torch.equal(allreduce_reference(parts, "sum").nan_to_num(7.0),
                       total.nan_to_num(7.0))
    for g in all_gather(parts, mesh, dim=1):
        assert torch.equal(g.nan_to_num(7.0), torch.cat(parts, 1).nan_to_num(7.0))
    with pytest.raises(ValueError, match="parts"):
        psum(parts[:2], mesh)


# ------------------------------------------------------------- solver level


@pytest.mark.parametrize("folder,k_star,obj", GOLDEN)
def test_sharded_solver_matches_golden(profiles_dir, vmesh, folder, k_star, obj):
    devs, model = load_from_profile_folder(profiles_dir / folder)
    tm: dict = {}
    r = halda_solve(devs, model, mip_gap=1e-4, kv_bits="4bit", device="cpu",
                    lp_backend="pdhg", mesh_shards=SHARDS, timings=tm)
    assert tm["mesh_shards"] == SHARDS and tm["lp_backend"] == "pdhg"
    assert r.k == k_star and r.certified
    assert r.obj_value == pytest.approx(obj, rel=2e-4)
    assert sum(r.w) * r.k == model.L


def test_sharded_north_star_in_both_precisions(profiles_dir, vmesh):
    """The north star on 4 shards in float32 and float64 iterates, each
    certified within 2x gap of the JAX package's objective; one shard is
    bit-identical to the default path."""
    model = load_model_profile(profiles_dir / "llama_3_70b" / "online" / "model_profile.json")
    devs = make_synthetic_fleet(16, seed=123)
    base = halda_solve(devs, model, mip_gap=GAP, kv_bits="4bit", device="cpu",
                       lp_backend="pdhg")
    one = halda_solve(devs, model, mip_gap=GAP, kv_bits="4bit", device="cpu",
                      lp_backend="pdhg", mesh_shards=1)
    assert (one.k, one.w, one.n, one.obj_value) == (base.k, base.w, base.n, base.obj_value)
    for dtype in (None, "f64"):
        r = halda_solve(devs, model, mip_gap=GAP, kv_bits="4bit", device="cpu",
                        lp_backend="pdhg", mesh_shards=SHARDS, pdhg_dtype=dtype)
        assert r.certified and sum(r.w) * r.k == model.L
        assert r.obj_value == pytest.approx(NORTH_STAR_GAP3, rel=2 * GAP)
        assert r.obj_value == pytest.approx(base.obj_value, rel=2 * GAP)


def test_mesh_knob_validation(one_thread, profiles_dir, vmesh):
    devs, model = load_from_profile_folder(profiles_dir / "llama_3_70b" / "online")
    with pytest.raises(ValueError, match="mesh_shards"):
        halda_solve(devs, model, device="cpu", lp_backend="ipm", mesh_shards=2)
    with pytest.raises(ValueError, match="mesh_shards"):
        halda_solve(devs, model, device="cpu", lp_backend="pdhg", mesh_shards=0)
    mdevs, mmodel = load_from_profile_folder(profiles_dir / "mixtral_8x7b")
    tm: dict = {}
    r = halda_solve(mdevs, mmodel, mip_gap=GAP, kv_bits="8bit", device="cpu",
                    lp_backend="pdhg", mesh_shards=2, timings=tm)
    assert tm["mesh_shards"] == 2 and r.certified and r.k * sum(r.w) == mmodel.L
    assert sum(r.y) == mmodel.n_routed_experts


@pytest.fixture(scope="module")
def mixtral_m4():
    from distilp_torch.profiler import profile_model

    model = profile_model("tests/configs/mixtral_8x7b.json", batch_sizes=[1],
                          sequence_length=128).to_model_profile()
    return make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9)), model


@pytest.mark.parametrize("shards", [2, SHARDS])
def test_sharded_mixtral_m4_matches_jax(one_thread, vmesh, mixtral_m4, shards):
    """MoE nodes on the row mesh: K6b's per-element route through every LP
    round, at the JAX package's optimum."""
    devs, model = mixtral_m4
    tm: dict = {}
    r = halda_solve(devs, model, mip_gap=GAP, kv_bits="8bit", device="cpu",
                    lp_backend="pdhg", mesh_shards=shards, timings=tm)
    k, obj, w = MIXTRAL_M4
    assert tm["mesh_shards"] == shards and tm["bnb_rounds"] >= 1
    assert r.certified and r.k == k and r.w == w
    assert r.obj_value == pytest.approx(obj, rel=2 * GAP)


def test_sharded_mixtral_value_maps(one_thread, vmesh, mixtral_m4):
    """The sweep's per-shard value maps: each shard's values of a round's
    nodes are node_values restricted to its row block."""
    from distilp_torch.solver.api import _build_instance
    from distilp_torch.solver.backend_torch import _prepare, _search_params, lane_input
    from distilp_torch.solver.search import node_values

    devs, model = mixtral_m4
    Ks, _, coeffs, arrays = _build_instance(devs, model, None, "8bit", None, None)
    kWs = [(k, model.L // k) for k in Ks]
    lane = lane_input(arrays, coeffs, kWs, [(k, W) for k, W in kWs if W >= len(devs)])
    params = _search_params(lane.sf, None, None, None, None, None, "pdhg", None, SHARDS,
                            None, False)
    mesh = shard_mesh(SHARDS, "cpu")
    d = _prepare([lane], params, GAP, torch.device("cpu"), shared_A=True, row_mesh=mesh).data
    fresh = row_blocks(d.A_sparsity, SHARDS)
    assert all(torch.equal(a, b) for a, b in zip(d.A_shards.take, fresh.take))
    n_k = d.ks.shape[1]
    kidx = torch.arange(n_k)
    vals = node_values(d, kidx, torch.zeros(n_k, dtype=torch.long))
    dense = ElemA(vals, d.A_sparsity).dense()
    m = dense.shape[1]
    ms = pad_rows_to(m, SHARDS) // SHARDS
    for s, (sp, take) in enumerate(zip(d.A_shards.sparsity, d.A_shards.take)):
        rows = dense[:, s * ms:min(m, (s + 1) * ms)]
        pad = rows.new_zeros((n_k, ms - rows.shape[1], dense.shape[2]))
        assert torch.equal(ElemA(vals.index_select(1, take), sp).dense(),
                           torch.cat([rows, pad], 1))


def test_sharded_warm_blob_roundtrips_and_crosses_mesh_sizes(profiles_dir, vmesh):
    """A sharded replanner's warm blob restores bit-exactly into another
    sharded replanner, carries no shard count, and warm-starts an
    unsharded replanner and the JAX package's own replanner."""
    from distilp_tpu.common import load_model_profile as jload_model
    from distilp_tpu.solver.streaming import StreamingReplanner as JReplanner
    from distilp_tpu.utils import make_synthetic_fleet as jfleet

    path = profiles_dir / "llama_3_70b" / "online" / "model_profile.json"
    model = load_model_profile(path)
    devs = make_synthetic_fleet(16, seed=123)
    search = {"lp_backend": "pdhg", "mesh_shards": SHARDS}
    planner = StreamingReplanner(mip_gap=GAP, kv_bits="4bit", device="cpu", search=dict(search))
    assert planner.step(devs, model).certified
    blob = planner.dump_warm_state()
    assert "mesh_shards" not in str(sorted(blob))
    rng = np.random.default_rng(7)
    for d in devs:
        d.t_comm = max(0.0, d.t_comm * float(rng.uniform(0.95, 1.05)))
    uninterrupted = planner.step(devs, model)
    assert planner.last_tick_mode == "warm"
    restored = StreamingReplanner(mip_gap=GAP, kv_bits="4bit", device="cpu",
                                  search=dict(search))
    restored.load_warm_state(blob)
    resumed = restored.step(devs, model)
    assert restored.last_tick_mode == "warm"
    assert (resumed.obj_value, resumed.k, resumed.w, resumed.n) == (
        uninterrupted.obj_value, uninterrupted.k, uninterrupted.w, uninterrupted.n)
    unsharded = StreamingReplanner(mip_gap=GAP, kv_bits="4bit", device="cpu",
                                   search={"lp_backend": "pdhg"})
    unsharded.load_warm_state(blob)
    crossed = unsharded.step(devs, model)
    assert unsharded.last_tick_mode == "warm" and crossed.certified
    assert crossed.obj_value == pytest.approx(uninterrupted.obj_value, rel=2 * GAP)
    jdevs = jfleet(16, seed=123)
    for d, p in zip(jdevs, devs):
        d.t_comm = p.t_comm
    theirs = JReplanner(mip_gap=GAP, kv_bits="4bit", backend="jax",
                        search={"lp_backend": "pdhg"})
    theirs.load_warm_state(blob)
    jr = theirs.step(jdevs, jload_model(path))
    assert theirs.last_tick_mode == "warm" and jr.certified
    assert jr.obj_value == pytest.approx(uninterrupted.obj_value, rel=2 * GAP)
