"""The MoE part of the port's rounding (plain version of kernel K2's MoE
mode) against the JAX package's ``_round_to_incumbent(moe=True)``.

Three modes, on seeded rows: LP points (floor + largest-remainder
redistribution of y, 8 expert-move steps), Lagrangian-primal hints
(``y_steps = E + 4`` exact-priced repair steps) and warm rows (integer
points, 2 move steps). Objectives within 1e-12 relative (the port sums the
devices' costs in device order, the reference in XLA's order); the integer
vectors equal, or, where a tie broke another way, pricing equal under the
reference's own ``price_fixed_assignment``.

The kernel prices candidates from a per-device delta table (each device's
ok, lin and cycle term at y + delta for delta in {0, +-1, +-2, +-4, +-8,
+-16}); a torch emulation of that algorithm (build the table, price every
candidate from it, re-price after each step) equals the plain version bit
for bit on Mixtral, Qwen3 and flagship rows in all three modes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from distilp_torch.profiler import profile_model  # noqa: E402
from distilp_torch.solver import rounding as R  # noqa: E402
from distilp_torch.solver.api import _build_instance  # noqa: E402
from distilp_torch.solver.standard_form import (  # noqa: E402
    MOE_LOCAL_MOVES,
    MOE_LOCAL_MOVES_WARM,
    rounding_arrays_np,
)
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402
from distilp_tpu.solver import backend_jax as BJ  # noqa: E402

TOL = 1e-12
CASES = {
    "mixtral_M4": ("mixtral_8x7b", 4, 7, 64e9),
    "qwen3_30b_a3b_M8": ("qwen3_30b_a3b_8bit", 8, 1, 64e9),
}
# The DeepSeek-V3 flagship (E=256 over 32 devices, 32e9-byte pools), for
# the delta-table emulation; its rows spread y near evenly (a Dirichlet of
# concentration 50) and sum within 5% of E: a device far over E / M prices
# +inf, and an LP row's redistribution moves at most M + 4 units.
FLAGSHIP = ("deepseek_v3", 32, 11, 32e9)
B = 12


def _instance(name):
    cfg, M, seed, pool = FLAGSHIP if name == "flagship_M32" else CASES[name]
    model = profile_model(
        f"tests/configs/{cfg}.json", batch_sizes=[1], sequence_length=128
    ).to_model_profile()
    devs = make_synthetic_fleet(M, seed=seed, pool_bytes=int(pool))
    Ks, _, coeffs, arrays = _build_instance(devs, model, None, "8bit", None, None)
    feas = [(k, model.L // k) for k in Ks if model.L // k >= M]
    return M, feas, rounding_arrays_np(coeffs, arrays.moe), arrays.layout.n_vars + 6 * M


def _rows(M, feas, E, nf, mode, seed=1, y_conc=1.0, y_off=0.4):
    """B seeded rows: near-feasible LP points (w summing near W, n in
    [0, w], y summing to E times 1 +- ``y_off``, spread by a Dirichlet of
    concentration ``y_conc``); warm rows are their integer roundings."""
    rng = np.random.default_rng(seed)
    kidx = rng.integers(0, len(feas), B)
    W = np.array([feas[j][1] for j in kidx], np.float64)
    k = np.array([feas[j][0] for j in kidx], np.float64)
    v = np.zeros((B, nf))
    for r in range(B):
        w = rng.dirichlet(np.ones(M)) * (W[r] - M) + 1.0
        v[r, :M] = w
        v[r, M : 2 * M] = w * rng.random(M)
        v[r, 2 * M : 3 * M] = rng.dirichlet(np.full(M, y_conc)) * E * rng.uniform(1 - y_off, 1 + y_off)
    if mode == "warm":
        v[:, : 3 * M] = np.round(v[:, : 3 * M])
    return v, W, k


MODES = {
    "lp": {"moves": MOE_LOCAL_MOVES},
    "hint": {"y_steps": None, "moves": MOE_LOCAL_MOVES},  # y_steps set to E + 4
    "warm": {"moves": MOE_LOCAL_MOVES_WARM},
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(CASES))
def test_moe_rounding_matches_jax(name, mode):
    M, feas, rd_np, nf = _instance(name)
    E = float(rd_np["E"])
    kw = dict(MODES[mode])
    if mode == "hint":
        kw["y_steps"] = int(E) + 4
    v, W, k = _rows(M, feas, E, nf, mode)
    jrd = BJ.RoundingData(**{f: jnp.asarray(x, jnp.float64) for f, x in rd_np.items()})
    ref = jax.vmap(
        lambda vr, Wr, kr: BJ._round_to_incumbent(vr, M, Wr, kr, jrd, moe=True, **kw)
    )(jnp.asarray(v), jnp.asarray(W), jnp.asarray(k))
    ref = [np.asarray(x) for x in ref]
    got = R.round_to_incumbent(
        torch.tensor(v), torch.tensor(W), torch.tensor(k),
        R.rounding_data(rd_np, "cpu"), moe=True, **kw,
    )
    got = [x.numpy() for x in got]
    assert np.array_equal(np.isfinite(got[0]), np.isfinite(ref[0]))
    fin = np.isfinite(ref[0])
    assert fin.any(), "no row rounded to a feasible point"
    assert np.max(np.abs(got[0][fin] - ref[0][fin]) / np.abs(ref[0][fin])) <= TOL
    assert np.array_equal(got[1], ref[1]) and np.array_equal(got[2], ref[2])
    differ = np.nonzero((got[3] != ref[3]).any(axis=1))[0]
    for r in differ:
        # A tie the two sums broke apart: the port's vector must price as
        # the reference's under the reference's own pricer.
        price = float(BJ.price_fixed_assignment(jrd, k[r], W[r], got[1][r], got[2][r], got[3][r]))
        assert abs(price - ref[0][r]) <= TOL * abs(ref[0][r])
    assert np.all(got[3][fin].sum(axis=1) == E)


def test_moe_rounding_dense_call_keeps_its_output():
    """Without ``moe`` the rounding returns (obj, w, n), as before."""
    M, feas, rd_np, nf = _instance("mixtral_M4")
    v, W, k = _rows(M, feas, float(rd_np["E"]), nf, "lp")
    out = R.round_to_incumbent(torch.tensor(v), torch.tensor(W), torch.tensor(k),
                               R.rounding_data(rd_np, "cpu"))
    assert len(out) == 3


def test_hint_repair_reaches_E_from_far_off():
    """A hint short of E by more than M experts is repaired to sum E."""
    M, feas, rd_np, nf = _instance("qwen3_30b_a3b_M8")
    E = float(rd_np["E"])
    v, W, k = _rows(M, feas, E, nf, "lp", seed=3)
    v[:, 2 * M : 3 * M] *= 0.3  # ~90 experts short
    got = R.round_to_incumbent(torch.tensor(v), torch.tensor(W), torch.tensor(k),
                               R.rounding_data(rd_np, "cpu"), moe=True,
                               y_steps=int(E) + 4)
    fin = torch.isfinite(got[0])
    assert bool(fin.any())
    assert bool((got[3][fin].sum(1) == E).all())


# ------------------------------------------------- the kernel's delta table

# The table's deltas in the kernel's entry order: 0, then +q, -q for q in
# MOVE_QUANTA (entry 1 + 2 log2 q is +q, 2 + 2 log2 q is -q).
DELTAS = (0.0,) + tuple(d for q in R.MOVE_QUANTA for d in (q, -q))


def _delta_table(pricer, rd, y):
    """(ok, lin, cy), each (B, 11, M): every device's share of the price at
    y + delta, with the plain pricer's expressions (an entry depends on its
    own device's y only, so re-pricing the moved devices after a step, as
    the kernel does, gives this table)."""
    Y = y[:, None, :] + torch.tensor(DELTAS, dtype=y.dtype)[None, :, None]
    bp = rd.bprime
    viol_ram = torch.clamp(pricer.base_res + rd.eb_ram * Y - rd.ram_rhs, min=0.0)
    s_ram = torch.ceil(viol_ram / bp - 1e-9)
    viol_vram = torch.clamp(torch.maximum(pricer.bn + rd.eb_vram * Y - rd.cuda_rhs,
                                          pricer.bn + rd.eb_metal * Y - rd.metal_rhs), min=0.0)
    viol_vram = torch.where(torch.isfinite(viol_vram), viol_vram, 0.0)
    t = torch.ceil(viol_vram / bp - 1e-9)
    ok = (s_ram <= pricer.wcap) & (t <= pricer.n_tol)
    lin = (pricer.aw_bn + (rd.pen_set * s_ram + rd.pen_vram * t)) + pricer.g_k * Y
    return ok, lin, (lin + rd.busy_const) + pricer.half_fetch


def _price_from_table(table, k_f, sel):
    """(B, C) prices of candidates that read entry ``sel`` (B, C, M) of each
    device: infeasible if any entry is, else (k - 1) max(cy) + the linear
    costs summed in device order from 0."""
    B, C, M = sel.shape
    rows = torch.arange(B)[:, None, None]
    dev = torch.arange(M)[None, None, :]
    ok, lin, cy = (x[rows, sel, dev] for x in table)
    total = torch.zeros((B, C), dtype=lin.dtype)
    for j in range(M):
        total = total + lin[..., j]
    obj = (k_f - 1.0) * cy.amax(-1) + total
    return torch.where(ok.all(-1), obj, float("inf"))


def _round_moe_by_table(v, W, k, rd, y_steps=None, moves=MOE_LOCAL_MOVES):
    """The MoE rounding kernel's algorithm: y rounded as the plain version
    rounds it, then every repair and move candidate priced from the delta
    table."""
    f64 = torch.float64
    M = rd.a.shape[0]
    v = v.to(f64)
    B = v.shape[0]
    E = rd.E.to(f64)
    w, n, valid = R._round_w_n(v, W, rd)
    pricer = R._MoEPricer(w, n, W, k, rd)
    zero = torch.zeros((), dtype=f64)
    rows = torch.arange(B)
    none = torch.zeros((B, 1, M), dtype=torch.int64)
    y_frac = v[:, 2 * M : 3 * M]
    if y_steps is None:
        y = R._int_redistribute(R._clip(torch.floor(y_frac), zero, E),
                                y_frac - torch.floor(y_frac), zero, E, E.expand(B))
    else:
        y = R._clip(torch.round(y_frac), zero, E)
        one = torch.eye(M, dtype=torch.int64)[None]  # (1, M candidates, M devices)
        for _ in range(y_steps):
            d = E - y.sum(1)
            if not bool((d != 0).any()):
                break
            table = _delta_table(pricer, rd, y)
            add = torch.where(y < E, _price_from_table(table, pricer.k_f, one.expand(B, -1, -1)),
                              float("inf")).argmin(1)
            sub = torch.where(y > 0, _price_from_table(table, pricer.k_f,
                                                       2 * one.expand(B, -1, -1)),
                              float("inf")).argmin(1)
            step = torch.where(d > 0, 1.0, torch.where(d < 0, -1.0, 0.0)).to(f64)
            y = y + step[:, None] * torch.eye(M, dtype=f64)[torch.where(d > 0, add, sub)]
    valid = valid & (y.sum(1) == E)
    # Move (q, i, j): device i at entry 2 + 2 log2 q (-q), j at 1 + 2 log2 q.
    qi, i, j = (t.reshape(-1) for t in torch.meshgrid(
        torch.arange(len(R.MOVE_QUANTA)), torch.arange(M), torch.arange(M), indexing="ij"))
    sel = torch.zeros((len(qi), M), dtype=torch.int64)
    sel[torch.arange(len(qi)), j] = 1 + 2 * qi
    sel[torch.arange(len(qi)), i] = 2 + 2 * qi  # i == j is no candidate
    q = torch.tensor(R.MOVE_QUANTA, dtype=f64)[qi]
    for _ in range(moves):
        table = _delta_table(pricer, rd, y)
        feas = (i != j)[None] & (y[:, i] >= q) & (y[:, j] + q <= E)
        objs = torch.where(feas, _price_from_table(table, pricer.k_f, sel[None].expand(B, -1, -1)),
                           float("inf"))
        flat = objs.argmin(1)
        cur = _price_from_table(table, pricer.k_f, none)[:, 0]
        better = objs[rows, flat] < cur - 1e-12
        moved = y.clone()
        moved[rows, i[flat]] -= q[flat]
        moved[rows, j[flat]] += q[flat]
        y = torch.where(better[:, None], moved, y)
    obj = _price_from_table(_delta_table(pricer, rd, y), pricer.k_f, none)[:, 0]
    return torch.where(valid, obj, float("inf")), w, n, y


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(CASES) + ["flagship_M32"])
def test_delta_table_pricing_equals_the_plain_version(name, mode):
    """The kernel's algorithm, emulated in torch, gives the plain version's
    (obj, w, n, y) bit for bit: LP rows (8 moves), hint rows repaired with
    ``y_steps = E + 4`` (then 8 moves) and warm rows (2 moves)."""
    M, feas, rd_np, nf = _instance(name)
    E = float(rd_np["E"])
    kw = dict(MODES[mode])
    if mode == "hint":
        kw["y_steps"] = int(E) + 4
    spread = dict(y_conc=50.0, y_off=0.05) if name == "flagship_M32" else {}
    v, W, k = (torch.tensor(x) for x in _rows(M, feas, E, nf, mode, **spread))
    rd = R.rounding_data(rd_np, "cpu")
    ref = R.round_moe_reference(v, W, k, rd, **kw)
    got = _round_moe_by_table(v, W, k, rd, **kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert bool(torch.isfinite(ref[0]).any()), "no row rounded to a feasible point"


class _TabLib:
    """Stands in for the built rounding library's table-size query."""

    def __init__(self, nbytes):
        self.nbytes = nbytes

    def dtk_round_moe_tab_bytes(self, M, B):
        return self.nbytes if self.nbytes <= 0 else self.nbytes * B


@pytest.mark.parametrize("nbytes", [0, 187 * 700, -1])
def test_moe_table_workspace_follows_the_library(nbytes):
    """No workspace where a block's shared memory holds the table (the
    library answers 0), the library's size where it does not, and a
    library error raises."""
    lib = _TabLib(nbytes)
    if nbytes < 0:
        with pytest.raises(RuntimeError, match="round_moe"):
            R.moe_table_workspace(lib, 700, 3, "cpu")
        return
    ws = R.moe_table_workspace(lib, 700, 3, "cpu")
    if nbytes == 0:
        assert ws is None
    else:
        assert ws.dtype == torch.uint8 and ws.numel() == 3 * nbytes
