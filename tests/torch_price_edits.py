"""Fixed MoE assignments that break one validity test of
``price_fixed_assignment`` each, built from a solved one. Shared by
``tests/test_torch_routing.py`` and ``chip_smoke.py``; numpy only, so the
smoke can import it without JAX."""

import numpy as np

# Names of the edits, in the order validity_edits returns them after the
# solved assignment.
EDITS = ("sum w != W", "w < 1", "sum y != E", "RAM slack > min(w, W)", "VRAM slack > n")


def caps_hold(rd_np, W, w, n, y):
    """(RAM slack within min(w, W), VRAM slack within n) of an assignment,
    in numpy, by the JAX package's formulas."""
    bp = float(rd_np["bprime"])
    w, n, y = (np.asarray(v, np.float64) for v in (w, n, y))
    resident = bp * w - bp * n * rd_np["ram_minus_n"] + rd_np["eb_ram"] * y
    s_ram = np.ceil(np.maximum(resident - rd_np["ram_rhs"], 0.0) / bp - 1e-9)
    with np.errstate(invalid="ignore"):
        viol = np.maximum(np.maximum(bp * n + rd_np["eb_vram"] * y - rd_np["cuda_rhs"],
                                     bp * n + rd_np["eb_metal"] * y - rd_np["metal_rhs"]), 0.0)
    t = np.ceil(np.where(np.isfinite(viol), viol, 0.0) / bp - 1e-9)
    return bool(np.all(s_ram <= np.minimum(w, W))), bool(np.all(t <= n + 1e-9))


def validity_edits(W, w, n, y, rd_np):
    """[(name, w, n, y)]: the solver's assignment, then edits that break one
    validity test each: sum w, w >= 1, sum y, then (found by search over the
    devices) the RAM slack cap alone and the VRAM slack cap alone. An edit
    the search does not find is missing from the list."""
    M, E = len(w), sum(y)
    out = [("as solved", w, n, y)]
    w2 = list(w)
    w2[0] += 1
    out.append((EDITS[0], w2, n, y))
    i = int(np.argmax(w))
    w3, n3 = list(w), list(n)
    w3[(i + 1) % M] += w3[i]
    w3[i] = n3[i] = 0
    out.append((EDITS[1], w3, n3, y))
    y2 = list(y)
    y2[0] += 1
    out.append((EDITS[2], w, n, y2))
    # Then the slack caps, each alone: device d holds m E experts and device
    # d' 1 - m of them (sum y stays E; the pricer does not test y >= 0), on
    # a single layer (RAM) or with all its layers on its GPU (VRAM), for
    # the first (m, d) where only that cap breaks.
    for name, target in ((EDITS[3], (False, True)), (EDITS[4], (True, False))):
        found = False
        for m in range(1, 9):
            for d in range(M):
                wd = [1] * M
                wd[d if target[0] else (d + 1) % M] += W - M
                nd = [0] * M
                if not target[1]:
                    nd[d] = wd[d]
                yd = [0] * M
                yd[d] = m * E
                yd[(d + 1) % M] += (1 - m) * E
                if caps_hold(rd_np, W, wd, nd, yd) == target:
                    out.append((name, wd, nd, yd))
                    found = True
                    break
            if found:
                break
    return out
