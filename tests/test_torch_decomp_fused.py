"""K7's fused ascent (``ops/decomp.py::ascend_fused``: the whole multiplier
ascent in one cooperative launch) on the CPU.

The kernel needs the card (``chip_smoke.py`` holds the fused launch against
the host loop over the per-step entry there, at 3 and 300 steps, cold,
warm-started and with lanes). Here:
- a stand-in library records what the wrapper launches: the argument
  layout, the (steps, 3) Adam table equal to ``_adam_constants``, Adam's
  float32 constants, one launch per call for any ``steps`` and none at
  ``steps=0``; ``decomp_bound_roots`` makes at most two K7 launches;
- the work-unit plan (``unit_plan``) at M in {4, 16, 32} and S in {1, 4},
  and where the owner states go (``ascent_layout``): shared memory sized
  by the plan, global memory where shared memory cannot hold them;
- the plain ascent (``ascend_stepwise``, what the kernel computes) against
  the JAX package's ``_decomp_bound_roots``, warm-started from
  ``init_params`` and with two lanes in lockstep: per-k bounds within 1e-4
  relative, as ``tests/test_torch_decomp.py`` holds a cold ascent (Adam
  normalizes a gradient entry JAX computes as ~1e-7 where the port
  computes 0: the multipliers drift apart, the bounds barely).
"""

import contextlib
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from distilp_torch import kernels  # noqa: E402
from distilp_torch.kernels import build  # noqa: E402
from distilp_torch.ops import decomp as D  # noqa: E402
from distilp_torch.profiler import profile_model  # noqa: E402
from distilp_torch.solver.api import _build_instance  # noqa: E402
from distilp_torch.solver.rounding import rounding_data, stack_rounding_data  # noqa: E402
from distilp_torch.solver.standard_form import rounding_arrays_np  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402
from distilp_tpu.solver import backend_jax as BJ  # noqa: E402

TOL_ASCENT = 1e-4
GRID = 264  # the stand-in card: 132 SMs, two blocks each
FLEETS = {"mixtral_M4": ("mixtral_8x7b", 4, 7, 64e9),
          "mixtral_M4_seed8": ("mixtral_8x7b", 4, 8, 64e9),
          "qwen3_30b_a3b_M4": ("qwen3_30b_a3b_8bit", 4, 7, 64e9)}
_MODELS = {}


def _problem(name):
    """(p32, p64, rd_np, ks, Ws, w_max, e_max) of one fleet, on the CPU."""
    cfg, M, seed, pool = FLEETS[name]
    if cfg not in _MODELS:
        _MODELS[cfg] = profile_model(f"tests/configs/{cfg}.json", batch_sizes=[1],
                                     sequence_length=128).to_model_profile()
    model = _MODELS[cfg]
    devs = make_synthetic_fleet(M, seed=seed, pool_bytes=int(pool))
    Ks, _, coeffs, arrays = _build_instance(devs, model, None, "8bit", None, None)
    feas = [(k, model.L // k) for k in Ks if model.L // k >= M]
    rd_np = rounding_arrays_np(coeffs, arrays.moe)
    ks = np.array([k for k, _ in feas], np.float64)
    Ws = np.array([W for _, W in feas], np.float64)
    w_max, e_max = int(Ws.max()), int(rd_np["E"])
    p32, p64 = (D.decomp_problem(rd_np, ks, Ws, w_max, e_max, dt, "cpu")
                for dt in (torch.float32, torch.float64))
    return p32, p64, rd_np, ks, Ws, w_max, e_max


def _batch(names):
    probs = [_problem(n) for n in names]
    b32 = D.stack_problems([p[0] for p in probs])
    b64 = D.stack_problems([p[1] for p in probs])
    rd = stack_rounding_data([rounding_data(p[2], "cpu") for p in probs])
    return b32, b64, rd, probs


def _init(S, n_k, M, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(0.0, 0.5, (S, n_k)).astype(np.float32),
            rng.normal(0.0, 0.1, (S, n_k)).astype(np.float32),
            rng.normal(0.0, 0.5, (S, n_k, M)).astype(np.float32))


# ------------------------------------------------- the wrapper's launches


def _floats(ptr, n):
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr.value)).copy()


class _Lib:
    """Stands in for the built decomposition library: records each launch;
    the ascent returns its starting point as the best multipliers."""

    def __init__(self, max_per_block=None):
        self.ascents, self.evals64, self.folds = [], [], []
        self.max_per_block = max_per_block  # owner states shared memory holds

    def dtk_decomp_ascent_grid(self, M, per_block):
        fits = self.max_per_block is None or per_block <= self.max_per_block
        return GRID if fits else -720  # cudaErrorCooperativeLaunchTooLarge

    def dtk_decomp_ascent_ws_bytes(self, units, cells, M, per_block):
        return 2 * 32 * units + 8 * cells + (0 if per_block else 4 * units * (5 * M + 8))

    def dtk_decomp_ascent_f32(self, rdv, bp, E, ks, Ws, S, n_k, M, w_max, e_max, adam, steps,
                              b1, one_b1, b2, one_b2, eps, P0, chunk_w, n_chunks, G,
                              per_block, ws, ws_len, best, stream):
        n = S * n_k * (2 + M)
        self.ascents.append(dict(
            S=S, n_k=n_k, M=M, w_max=w_max, e_max=e_max, steps=steps,
            adam=_floats(adam, 3 * steps).reshape(steps, 3), consts=(b1, one_b1, b2, one_b2, eps),
            P0=_floats(P0, n).reshape(S, -1), plan=(chunk_w, n_chunks, G), per_block=per_block,
            ws_len=ws_len))
        ctypes.memmove(best.value, P0.value, 4 * n)
        return 0

    def dtk_decomp_f64_ws_bytes(self, units, Y):
        return 8 * units * (Y + 2)

    def dtk_decomp_eval_f64(self, rdv, bp, E, ks, Ws, S, n_k, M, w_max, e_max, lam, mu, theta,
                            track_hint, chunk_w, n_chunks, ws, ws_len, count, *outs):
        self.evals64.append(dict(S=S, track_hint=track_hint, plan=(chunk_w, n_chunks),
                                 count=_floats(count, S * n_k * M).view(np.int32)))
        return 0

    def dtk_decomp_theta_f64(self, P32, tau, ks, S, n_k, M, lam, mu, tau_out, theta, stream):
        self.folds.append("theta")
        return 0

    def dtk_decomp_bound_f64(self, m_y, any_ok, lam, mu, Ws, E, S, n_k, M, Y, bound, stream):
        self.folds.append("bound")
        return 0


@pytest.fixture
def lib(monkeypatch):
    fake = _Lib()
    monkeypatch.setattr(build, "library", lambda name: fake)
    monkeypatch.setattr(kernels, "on_cuda", lambda *t: True)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: ctypes.c_void_p(None))
    monkeypatch.setattr(D, "_sm_count", lambda dev: GRID // 2)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    D._ascent_grid.cache_clear()
    kernels.reset_launch_counts()
    yield fake
    D._ascent_grid.cache_clear()
    kernels.reset_launch_counts()


@pytest.mark.parametrize("steps", [1, 3, 300])
def test_fused_ascent_is_one_launch_whatever_the_steps(lib, steps):
    """One launch a call: the packed start, the (steps, 3) table of
    ``_adam_constants`` (float32), Adam's float32 constants, the plan."""
    b32, _, _, _ = _batch(["mixtral_M4"])
    S, n_k = b32.ks.shape
    M = b32.rdv.shape[-1]
    lam, mu, tau = D.ascend(b32, steps)
    assert kernels.LAUNCHES["decomp"] == 1 and kernels.SHAPES["decomp"] == {"ascent": 1}
    (a,) = lib.ascents
    assert (a["S"], a["n_k"], a["M"], a["w_max"], a["e_max"], a["steps"]) == \
        (S, n_k, M, b32.w_max, b32.e_max, steps)
    assert np.array_equal(a["adam"], np.array(D._adam_constants(steps), np.float32))
    assert a["consts"] == tuple(float(np.float32(x)) for x in (0.9, 1 - 0.9, 0.999,
                                                               1 - 0.999, 1e-12))
    plan = D.unit_plan(S, n_k, M, b32.w_max, b32.e_max,
                       min(GRID, D.ASCENT_BLOCKS_PER_SM * GRID // 2))
    assert a["plan"] == (plan.chunk_w, plan.n_chunks, plan.grid)
    assert a["per_block"] == -(-plan.units // plan.grid)  # owner states in shared memory
    cells = S * n_k * M * b32.w_max * (b32.e_max + 1) * 5  # the cells' cache
    assert a["ws_len"] == lib.dtk_decomp_ascent_ws_bytes(plan.units, cells, M, a["per_block"])
    assert not a["P0"].any()  # a cold start: zeros
    assert lam.shape == (S, n_k) and mu.shape == (S, n_k) and tau.shape == (S, n_k, M)


def test_fused_ascent_starts_from_init_params(lib):
    b32, _, _, _ = _batch(["mixtral_M4", "mixtral_M4_seed8"])
    S, n_k = b32.ks.shape
    M = b32.rdv.shape[-1]
    init = _init(S, n_k, M)
    out = D.ascend(b32, 5, tuple(torch.tensor(x) for x in init))
    (a,) = lib.ascents
    assert np.array_equal(a["P0"], np.concatenate(
        [init[0], init[1], init[2].reshape(S, -1)], axis=1))
    for got, want in zip(out, init):  # the stand-in returns the start
        assert np.array_equal(got.numpy(), want)
    assert kernels.LAUNCHES["decomp_lanes"] == 1 and kernels.LAUNCHES["decomp"] == 0
    assert kernels.SHAPES["decomp_lanes"] == {"ascent": 1}


def test_zero_steps_skip_the_ascent(lib):
    """``steps=0``: no ascent launch, the float64 evaluation only (without
    the hint); a cold root bound: the ascent and the evaluation, two
    launches. Each evaluation has its two float64 folds (theta before it,
    the bound after it), counted apart from K7's launches."""
    b32, b64, rd, _ = _batch(["mixtral_M4"])
    assert [x.abs().sum().item() for x in D.ascend(b32, 0)] == [0.0, 0.0, 0.0]
    assert not lib.ascents and kernels.LAUNCHES["decomp"] == 0
    D.decomp_bound_roots(b32, b64, rd, 0)
    assert kernels.SHAPES["decomp"] == {"eval64": 1} and not lib.ascents
    assert lib.evals64[-1]["track_hint"] == 0
    assert lib.folds == ["theta", "bound"]
    assert kernels.LAUNCHES["decomp_theta"] == 1 and kernels.LAUNCHES["decomp_bound"] == 1
    kernels.reset_launch_counts()
    D.decomp_bound_roots(b32, b64, rd, 300)
    assert kernels.SHAPES["decomp"] == {"ascent": 1, "eval64": 1}
    assert kernels.LAUNCHES["decomp"] == 2 and lib.evals64[-1]["track_hint"] == 1
    M, n_k = b64.rdv.shape[-1], b64.ks.shape[1]
    plan = D.unit_plan(1, n_k, M, b64.w_max, b64.e_max, GRID)
    assert lib.evals64[-1]["plan"] == (plan.chunk_w, plan.n_chunks)
    assert not lib.evals64[-1]["count"].any()  # the fold counters start at 0


@pytest.mark.parametrize("S", [1, 40, 400])
def test_owner_states_follow_the_plan(lib, S):
    """A block keeps ceil(units / grid) owner states in shared memory,
    whatever S; where shared memory cannot hold that many (here more than
    16), every unit's state goes to the workspace and the launch stays one:
    no batch is refused or sliced."""
    lib.max_per_block = 16
    one, _, _, _ = _batch(["mixtral_M4"])
    b32 = D.stack_problems([one.instance(0)] * S)
    n_k, M = b32.ks.shape[1], b32.rdv.shape[-1]
    D.ascend(b32, 3)
    (a,) = lib.ascents
    plan = D.unit_plan(S, n_k, M, b32.w_max, b32.e_max, GRID)
    per = -(-plan.units // plan.grid)
    assert a["plan"] == (plan.chunk_w, plan.n_chunks, plan.grid) and a["S"] == S
    assert a["per_block"] == (per if per <= 16 else 0)
    assert (a["per_block"] == 0) == (S == 400)  # 6400 rows: 25 a block
    cells = S * n_k * M * b32.w_max * (b32.e_max + 1) * 5
    assert a["ws_len"] == lib.dtk_decomp_ascent_ws_bytes(plan.units, cells, M, a["per_block"])
    assert kernels.SHAPES["decomp" if S == 1 else "decomp_lanes"] == {"ascent": 1}


def test_ascent_layout_refuses_a_card_without_room():
    with pytest.raises(RuntimeError, match="no block fits"):
        D.ascent_layout(1, 4, 4, 32, 8, 132, lambda per_block: 0)


# ------------------------------------------------- work units

# (n_k, w_max, e_max) of the instances at each M: Mixtral 8x7B on 4, Qwen3
# on 16, the DeepSeek-V3 flagship on 32 (chip_smoke.py's MoE cases).
SHAPES_AT = {4: (4, 32, 8), 16: (3, 48, 128), 32: (1, 61, 256)}


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("M", [4, 16, 32])
def test_unit_plan_covers_every_cell_once(M, S):
    n_k, w_max, e_max = SHAPES_AT[M]
    rows = S * n_k * M
    pairs = w_max * (e_max + 1)
    for target in (1, 132, GRID, 528):
        p = D.unit_plan(S, n_k, M, w_max, e_max, target)
        assert p.n_chunks * p.chunk_w >= w_max > (p.n_chunks - 1) * p.chunk_w
        assert p.units == rows * p.n_chunks and 1 <= p.grid <= min(target, p.units)
        assert p.units <= max(target, rows)  # a chunk more would pass the target
        # A unit's share of its row: UNIT_MIN_PAIRS (w, y) pairs or the row.
        assert p.n_chunks == 1 or pairs // p.n_chunks >= D.UNIT_MIN_PAIRS
        # Each w of each row in exactly one unit.
        ws = sorted(w for c in range(p.n_chunks)
                    for w in range(1 + c * p.chunk_w, min(w_max, (c + 1) * p.chunk_w) + 1))
        assert ws == list(range(1, w_max + 1))
    if (M, S) == (32, 1):  # the flagship's 32 rows in 8 chunks of 8 w
        assert D.unit_plan(S, n_k, M, w_max, e_max, GRID) == (8, 8, 256, 256)
    if M == 4:  # Mixtral's rows (32 w x 9 y) are one unit each
        assert D.unit_plan(S, n_k, M, w_max, e_max, GRID).n_chunks == 1


# ------------------------------------------------- the plain ascent vs JAX


def _jax_bounds(prob, steps, init):
    _, _, rd_np, ks, Ws, w_max, e_max = prob
    jrd = BJ.RoundingData(**{k: jnp.asarray(v, jnp.float64) for k, v in rd_np.items()})
    out = BJ._decomp_bound_roots(jrd, jnp.asarray(ks), jnp.asarray(Ws), w_max, e_max,
                                 steps=steps, moe=True,
                                 init_params=None if init is None
                                 else tuple(jnp.asarray(x) for x in init))
    return np.asarray(out[0])


@pytest.mark.parametrize("name", ["mixtral_M4", "qwen3_30b_a3b_M4"])
def test_plain_ascent_warm_started_matches_jax(name):
    b32, b64, rd, probs = _batch([name])
    S, n_k = b32.ks.shape
    M = b32.rdv.shape[-1]
    init = _init(S, n_k, M)
    out = D.decomp_bound_roots(b32, b64, rd, 20, tuple(torch.tensor(x) for x in init))
    tb, jb = out[0][0].numpy(), _jax_bounds(probs[0], 20, tuple(x[0] for x in init))
    assert np.all(np.isfinite(tb)) == np.all(np.isfinite(jb))
    assert np.max(np.abs(tb - jb) / np.abs(jb)) <= TOL_ASCENT
    # The ascent only improves on its starting point.
    start = D.eval64(b64, *(torch.tensor(x).double() for x in init), False)[0][0]
    assert np.all(tb >= start.numpy() - 1e-9 * np.abs(start.numpy()))


def test_plain_ascent_lanes_in_lockstep_match_jax():
    """Two Mixtral fleets as lanes of one ascent, each warm-started from its
    own multipliers: each lane's bounds are the reference's for that
    instance alone."""
    names = ["mixtral_M4", "mixtral_M4_seed8"]
    b32, b64, rd, probs = _batch(names)
    S, n_k = b32.ks.shape
    M = b32.rdv.shape[-1]
    init = _init(S, n_k, M, seed=9)
    out = D.decomp_bound_roots(b32, b64, rd, 20, tuple(torch.tensor(x) for x in init))
    for s, prob in enumerate(probs):
        tb = out[0][s].numpy()
        jb = _jax_bounds(prob, 20, tuple(x[s] for x in init))
        assert np.max(np.abs(tb - jb) / np.abs(jb)) <= TOL_ASCENT
        one = D.decomp_bound_roots(*_batch([names[s]])[:3], 20,
                                   tuple(torch.tensor(x[s:s + 1]) for x in init))
        assert torch.equal(one[0][0], out[0][s])  # a lane is its instance alone
