"""K1's sparse structure of A (``distilp_torch.ops.ipm.ipm_sparsity``) on the
repository's own LP families.

The kernel forms the normal matrix A diag(theta) A' + reg I entry by entry
over each structural entry's contributing columns, in ascending j, with the
dense sum's expression. ``_sparse_normal`` below is the plain version of that
loop, computed from the structure alone; it must equal the dense sum taken in
ascending j bit for bit in float64 (the skipped terms are exact zeros), and a
non-finite theta must leave it non-finite everywhere, as the dense product
is. The instances: the four golden fixtures, the north star
(``make_synthetic_fleet(16, seed=123)``), the 128-device fleet's standard
form and a MoE per-node batch at the DeepSeek-V3 flagship's shapes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distilp_torch.common import load_from_profile_folder  # noqa: E402
from distilp_torch.ops.ipm import IPMSparsity, ipm_sparsity  # noqa: E402
from distilp_torch.solver.api import _build_instance  # noqa: E402
from distilp_torch.solver.backend_torch import device_arrays  # noqa: E402
from distilp_torch.solver.standard_form import build_standard_form  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet, stretch_model_for_fleet  # noqa: E402

GOLDEN = ["hermes_70b", "llama_3_70b/4bit", "llama_3_70b/online", "qwen3_32b/bf16"]


def _host(devs, model, kv_bits="4bit"):
    Ks, _, coeffs, arrays = _build_instance(devs, model, None, kv_bits, None, None)
    feasible = [(k, model.L // k) for k in Ks if model.L // k >= len(devs)]
    sf = build_standard_form(arrays, coeffs, feasible)
    return sf, device_arrays(sf)


def _fleet_A(profiles_dir, M: int, seed: int) -> torch.Tensor:
    _, model = load_from_profile_folder(profiles_dir / "llama_3_70b" / "online")
    if M > model.L:
        model = stretch_model_for_fleet(model, M)
    _, host = _host(make_synthetic_fleet(M, seed=seed), model)
    return torch.as_tensor(host["A"])


def _sparse_normal(sp: IPMSparsity, vals, cs, theta, reg) -> torch.Tensor:
    """The kernel's normal matrix, from the structure alone (lower triangle
    of an (m, m) matrix): each entry sums ((A[i,j] cs_j) theta_j) (A[k,j]
    cs_j) over its contributing columns in ascending j, then adds reg on the
    diagonal; a non-finite theta leaves it all NaN (the factor fails)."""
    m = sp.m
    if not bool(torch.isfinite(theta).all()):
        return torch.full((m, m), float("nan"), dtype=vals.dtype)
    P = {k: v.long() for k, v in sp.parts().items()}
    j = P["w_j"]
    c = cs[j]
    prod = ((vals[P["w_pi"]] * c) * theta[j]) * (vals[P["w_pk"]] * c)
    counts = P["w_ptr"][1:] - P["w_ptr"][:-1]
    ent = torch.repeat_interleave(torch.arange(sp.nent), counts)
    rank = torch.arange(sp.ncontrib) - P["w_ptr"][ent]
    acc = torch.zeros(sp.nent, dtype=vals.dtype)
    for r in range(int(counts.max()) if sp.ncontrib else 0):
        sel = rank == r
        acc[ent[sel]] += prod[sel]  # one contribution per entry and rank
    diag = P["w_row"] == P["w_col"]
    acc[diag] = acc[diag] + reg
    W = torch.zeros((m, m), dtype=vals.dtype)
    W[P["w_row"], P["w_col"]] = acc
    return W


def _dense_normal(A, cs, theta, reg) -> torch.Tensor:
    """A diag(cs) diag(theta) diag(cs) A' + reg I, summed over j ascending."""
    As = A * cs
    W = torch.zeros((A.shape[0], A.shape[0]), dtype=A.dtype)
    for j in range(A.shape[1]):
        W += (As[:, j] * theta[j])[:, None] * As[None, :, j]
    return W + reg * torch.eye(A.shape[0], dtype=A.dtype)


def _theta_cs(rng, n):
    cs = torch.as_tensor(np.where(rng.random(n) < 0.8, rng.uniform(0.5, 40.0, n), 1.0))
    theta = torch.as_tensor(rng.uniform(1e-3, 10.0, n) * (rng.random(n) < 0.9))
    return cs, theta


def _assert_bit_equal(A: torch.Tensor, sp: IPMSparsity, rng, reg=1e-10):
    A = A.to(torch.float64)
    vals = A.reshape(-1)[sp.src]
    cs, theta = _theta_cs(rng, A.shape[1])
    got = torch.tril(_sparse_normal(sp, vals, cs, theta, reg))
    want = torch.tril(_dense_normal(A, cs, theta, reg))
    assert torch.equal(got, want)
    assert bool(torch.isfinite(got).all())


def _assert_structure_is_A(A: torch.Tensor, sp: IPMSparsity):
    """The structure's rows and columns rebuild A, and A's products over the
    nonzeros agree with the dense ones."""
    m, n = A.shape
    P = {k: v.long() for k, v in sp.parts().items()}
    vals = A.reshape(-1)[sp.src]
    rows = torch.repeat_interleave(torch.arange(m), P["a_ptr"][1:] - P["a_ptr"][:-1])
    back = torch.zeros_like(A)
    back[rows, P["a_col"]] = vals[P["a_pos"]]
    assert torch.equal(back, A)
    cols = torch.repeat_interleave(torch.arange(n), P["t_ptr"][1:] - P["t_ptr"][:-1])
    back = torch.zeros_like(A)
    back[P["t_row"], cols] = vals
    assert torch.equal(back, A)
    assert sp.nnz == int((A != 0).sum())


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_normal_matrix_equals_the_dense_sum(profiles_dir, name):
    devs, model = load_from_profile_folder(profiles_dir / name)
    _, host = _host(devs, model)
    A = torch.as_tensor(host["A"])
    sp = ipm_sparsity(A != 0)
    _assert_structure_is_A(A, sp)
    _assert_bit_equal(A, sp, np.random.default_rng(5))


@pytest.mark.parametrize("M,seed", [(16, 123), (128, 123)])
def test_fleet_normal_matrix_equals_the_dense_sum(profiles_dir, M, seed):
    A = _fleet_A(profiles_dir, M, seed)
    sp = ipm_sparsity(A != 0)
    _assert_structure_is_A(A, sp)
    _assert_bit_equal(A, sp, np.random.default_rng(M))


# (M, fleet seed) -> (m, n, nnz(A), W's structural lower entries, the
# multiply-adds that form them): the table K1's redesign was sized from.
@pytest.mark.parametrize("M,seed,want", [
    (16, 123, (97, 209, 492, 873, 1488)),
    (32, 32, (193, 417, 984, 2769, 4000)),
    (128, 123, (769, 1665, 3936, 35649, 40576)),
])
def test_structure_counts_reproduce_the_sizing_table(profiles_dir, M, seed, want):
    A = _fleet_A(profiles_dir, M, seed)
    sp = ipm_sparsity(A != 0)
    assert (sp.m, sp.n, sp.nnz, sp.nent, sp.ncontrib) == want
    assert sp.ncontrib == int(sum(c * (c + 1) // 2 for c in (A != 0).sum(0).tolist()))


def test_moe_per_node_normal_matrices_equal_the_dense_sums(profiles_dir):
    """The flagship's shapes (DeepSeek-V3, E=256, 32 devices): one structure
    for every node (the base's nonzeros and the 2M expert-busy entries
    ``node_A`` scatters in), each node's values gathered from its own A."""
    from distilp_torch.profiler import profile_model
    from distilp_torch.solver.search import SweepData, node_A, node_sparsity
    from distilp_torch.solver.standard_form import rounding_arrays_np

    model = profile_model("tests/configs/deepseek_v3.json", batch_sizes=[1],
                          sequence_length=128).to_model_profile()
    M = 32
    devs = make_synthetic_fleet(M, seed=11, pool_bytes=int(32e9))
    Ks, _, coeffs, arrays = _build_instance(devs, model, None, "8bit", None, None)
    feasible = [(k, model.L // k) for k in Ks if model.L // k >= M]
    sf = build_standard_form(arrays, coeffs, feasible)
    host = device_arrays(sf, rounding_arrays_np(coeffs, arrays.moe)["g_raw"])
    A = torch.as_tensor(host["A"])
    data = SweepData(A=A, b_k=None, c_k=None, int_mask=None, ks=None, Ws=None,
                     obj_const=None, rd=None, gky=torch.as_tensor(host["gky"])[None])
    sp = node_sparsity(A, M, moe=True)
    kidx = torch.arange(4) % host["gky"].shape[0]
    A_p = node_A(data, kidx, M, torch.zeros(4, dtype=torch.int64)).to(torch.float64)
    assert A_p.shape == (4, 258, 513)
    assert not bool(((A_p != 0).any(0) & ~(sp_dense := _pattern(sp))).any())
    vals = A_p.reshape(4, -1)[:, sp.src]
    rng = np.random.default_rng(11)
    for e in range(A_p.shape[0]):
        cs, theta = _theta_cs(rng, A_p.shape[2])
        got = torch.tril(_sparse_normal(sp, vals[e], cs, theta, 1e-10))
        assert torch.equal(got, torch.tril(_dense_normal(A_p[e], cs, theta, 1e-10)))
    assert bool(sp_dense.sum() == sp.nnz)


def _pattern(sp: IPMSparsity) -> torch.Tensor:
    P = {k: v.long() for k, v in sp.parts().items()}
    rows = torch.repeat_interleave(torch.arange(sp.m), P["a_ptr"][1:] - P["a_ptr"][:-1])
    pat = torch.zeros((sp.m, sp.n), dtype=torch.bool)
    pat[rows, P["a_col"]] = True
    return pat


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_non_finite_theta_makes_the_whole_matrix_non_finite(profiles_dir, bad):
    A = _fleet_A(profiles_dir, 16, 123).to(torch.float64)
    sp = ipm_sparsity(A != 0)
    cs, theta = _theta_cs(np.random.default_rng(2), A.shape[1])
    theta[17] = bad
    dense = _dense_normal(A, cs, theta, 1e-10)
    assert not bool(torch.isfinite(dense).any())
    sparse = _sparse_normal(sp, A.reshape(-1)[sp.src], cs, theta, 1e-10)
    assert not bool(torch.isfinite(sparse).any())


def test_empty_rows_keep_their_diagonal():
    """A row of A with no nonzero still has its diagonal entry (reg alone),
    and a column with none contributes nothing."""
    A = torch.tensor([[1.0, 0.0, 2.0, 0.0], [0.0, 0.0, 0.0, 0.0], [3.0, 0.0, 0.0, 4.0]],
                     dtype=torch.float64)
    sp = ipm_sparsity(A != 0)
    P = sp.parts()
    assert (sp.nnz, sp.nent, sp.ncontrib) == (4, 4, 5)
    assert P["w_row"].tolist() == [0, 2, 1, 2] and P["w_col"].tolist() == [0, 0, 1, 2]
    cs = torch.tensor([2.0, 1.0, 0.5, 3.0])
    theta = torch.tensor([0.25, 7.0, 1.5, 2.0])
    got = _sparse_normal(sp, A.reshape(-1)[sp.src], cs, theta, 1e-3)
    assert torch.equal(torch.tril(got), torch.tril(_dense_normal(A, cs, theta, 1e-3)))
    assert float(got[1, 1]) == 1e-3


def _small_batch(per_node: bool) -> "LPBatch":
    from distilp_torch.ops.ipm import LPBatch

    rng = np.random.default_rng(3)
    A = rng.standard_normal((3, 6)) * (rng.random((3, 6)) < 0.5)
    A[:, 0] = 1.0
    A = np.broadcast_to(A, (2, 3, 6)).copy() if per_node else A
    T = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    return LPBatch(A=T(A), b=T(np.ones((2, 3))), c=T(rng.random((2, 6))),
                   l=T(np.zeros((2, 6))), u=T(np.full((2, 6), 4.0)))


@pytest.mark.parametrize("per_node", [False, True])
def test_a_pattern_that_misses_a_nonzero_is_refused(per_node):
    """The kernel reads only the pattern's values, so a pattern that misses
    a nonzero of A (of any element) is refused before either route runs."""
    from distilp_torch.ops.ipm import check_sparsity, ipm_solve_batch

    batch = _small_batch(per_node)
    A = batch.A
    pattern = (A != 0) if A.dim() == 2 else (A != 0).any(0)
    i, j = (int(t[0]) for t in pattern.nonzero(as_tuple=True))
    short = pattern.clone()
    short[i, j] = False
    with pytest.raises(ValueError, match="outside the sparsity pattern"):
        ipm_solve_batch(batch, iters=2, sparsity=ipm_sparsity(short))
    if per_node:  # one element's nonzero outside the pattern is enough
        zi, zj = (int(t[0]) for t in (~pattern).nonzero(as_tuple=True))
        A1 = A.clone()
        A1[1, zi, zj] = 5.0
        with pytest.raises(ValueError, match="outside the sparsity pattern"):
            check_sparsity(A1, ipm_sparsity(pattern))
    with pytest.raises(ValueError, match="sparsity of a"):
        ipm_solve_batch(batch, iters=2, sparsity=ipm_sparsity(pattern[:, :-1]))


@pytest.mark.parametrize("per_node", [False, True])
def test_a_pattern_that_holds_every_nonzero_is_accepted(per_node):
    """A's own pattern, or a superset of it (the union pattern of a per-node
    A), passes, and the solve is the one without a pattern."""
    from distilp_torch.ops.ipm import check_sparsity, ipm_solve_batch

    batch = _small_batch(per_node)
    pattern = (batch.A != 0) if batch.A.dim() == 2 else (batch.A != 0).any(0)
    wider = pattern.clone()
    wider[:, 1] = True
    for sp in (ipm_sparsity(pattern), ipm_sparsity(wider)):
        check_sparsity(batch.A, sp)
        got = ipm_solve_batch(batch, iters=3, sparsity=sp)
        want = ipm_solve_batch(batch, iters=3)
        assert got.trace_buf is None and want.trace_buf is None
        assert all(torch.equal(a, b) for a, b in zip(got[:-1], want[:-1]))
