"""Hand-made dial windows for K12 ``readout`` (csrc/angles.cu), shared by
the CPU tests and the card tests (no JAX).

``hand_regions`` builds needle regions [B, D, 4096] bool from a camera's
geometry, one case a window, every case on every dial: no needle (n = 0,
so den = 0), arcs of 1 to 6 annulus slots pulled to the momentum's side
(n = 1..6, across the trim's cut steps), an arc across the 0.75-turn tail
(up, where the angle wraps), the whole annulus with and without a pull
(every annulus slot in the needle), a needle ray and random speckle.
``okey3_of`` writes the same needles as okey3 with keymax, window by
window in turn as the closed bit (keymax -1), a small blob (area2 200:
the closed bit) and a big blob (area2 201: the owner), the other bits
noise. ``CARRY_EDGES`` are dial positions on assemble_value's carry edges,
for rendered crops.
"""
import numpy as np

W = 64
N = W * W
ARCS = tuple(range(1, 7))
CASES = ("empty",) + tuple(f"arc{k}" for k in ARCS) + (
    "tail", "ring", "ring_pulled", "ray", "speckle")
# rows of (r4, r3, r2, r1) around the carry edges: r4 near 2 and 8, the
# coarser dials' fractions near 0.45 and 0.55
CARRY_EDGES = [[1.97, 2.44, 7.56, 0.5], [8.03, 3.56, 2.44, 9.99],
               [2.02, 9.45, 0.55, 4.0], [7.98, 0.46, 9.54, 5.0],
               [0.1, 4.5, 5.5, 3.0], [9.9, 0.52, 9.48, 0.0]]


def _slot_xy(host, d):
    """Disk (x, y) of each valid disk slot and annulus (x, y, angle) of
    each valid annulus slot of dial d, relative to the dial centre."""
    dv = host.disk_valid[d]
    dx = np.sign(host.disk_sx2[d][dv]) * np.sqrt(np.abs(host.disk_sx2[d][dv]))
    dy = np.sign(host.disk_sy2[d][dv]) * np.sqrt(np.abs(host.disk_sy2[d][dv]))
    av = host.ann_valid[d]
    return (host.disk_idx[d][dv], dx, dy, host.ann_idx[d][av],
            host.ann_x[d][av], host.ann_y[d][av], host.ann_angle[d][av])


def _pull(host, d, ux, uy, region):
    """Set the disk pixels in a wedge toward (ux, uy) for a dial of
    positive momentum (not its annulus slots, which would be kept), away
    from it for a negative one (annulus slots too: they lie on the side
    that is not kept), so that the momentum points at (ux, uy)."""
    didx, dx, dy, aidx = _slot_xy(host, d)[:4]
    sign = 1 if host.neg_sign[d] > 0 else -1
    r = np.hypot(dx, dy)
    cos = (dx * ux + dy * uy) / np.maximum(r, 1e-9) / np.hypot(ux, uy)
    wedge = (sign * cos > 0.8) & (r > 0)
    if sign > 0:
        wedge &= ~np.isin(didx, aidx)
    region[didx[wedge]] = True


def _case(host, d, name, rng):
    region = np.zeros(N, bool)
    didx, dx, dy, aidx, ax, ay, ang = _slot_xy(host, d)
    if name == "empty":
        return region
    if name.startswith("arc"):
        k = int(name[3:])
        # away from the wrap, so that no slot of the arc is a tail
        j0 = int(rng.integers(len(aidx) // 8, len(aidx) * 5 // 8))
        sel = np.arange(j0, j0 + k)
        region[aidx[sel]] = True
        _pull(host, d, ax[sel].mean(), ay[sel].mean(), region)
    elif name == "tail":
        sel = (ang > 0.97) | (ang < 0.03)
        region[aidx[sel]] = True
        _pull(host, d, 0.0, -1.0, region)      # angle 0 is up
    elif name == "ring":
        region[aidx] = True
    elif name == "ring_pulled":
        region[aidx] = True
        t = rng.uniform(0, 2 * np.pi)
        _pull(host, d, np.sin(t), -np.cos(t), region)
    elif name == "ray":
        t = rng.uniform(0, 2 * np.pi)
        ux, uy = np.sin(t), -np.cos(t)
        for idx, x, y in ((didx, dx, dy), (aidx, ax, ay)):
            region[idx[(np.abs(x * uy - y * ux) < 1.6)
                       & (x * ux + y * uy > 0)]] = True
    elif name == "speckle":
        region[rng.random(N) < 0.3] = True
    else:
        raise ValueError(name)
    return region


def hand_regions(host, seed: int = 0) -> np.ndarray:
    """[len(CASES), D, N] bool: window (b, d) holds case (b + d) % len
    (CASES), so every dial meets every case."""
    rng = np.random.default_rng(seed)
    D = host.disk_idx.shape[0]
    B = len(CASES)
    out = np.zeros((B, D, N), bool)
    for b in range(B):
        for d in range(D):
            out[b, d] = _case(host, d, CASES[(b + d) % B], rng)
    return out


def okey3_of(region: np.ndarray, seed: int = 0):
    """The needles of ``region`` [B, D, N] as (okey3 [B, D, N] i32, keymax
    [B, D] i32): window (b, d) takes the closed bit under keymax -1, the
    closed bit under a small blob's key (area2 200) or the owner of a big
    blob (area2 201), in turn; the other bits are noise."""
    rng = np.random.default_rng(seed)
    B, D, _ = region.shape
    low = rng.integers(0, 4, (B, D, N))                  # masked, boundary
    owner = rng.integers(0, N + 1, (B, D, N))
    closed = rng.random((B, D, N)) < 0.5
    sel = rng.integers(0, N, (B, D))
    kind = (np.arange(B)[:, None] + 2 * np.arange(D)[None]) % 3
    keymax = np.where(kind == 0, -1, np.where(kind == 1, 200, 201) << 12
                      | sel).astype(np.int32)
    big = (kind == 2)[..., None]
    owner = np.where(big, np.where(region, sel[..., None],
                                   np.where(owner == sel[..., None], N,
                                            owner)), owner)
    closed = np.where(big, closed, region)
    okey3 = (owner * 8 + closed * 4 + low).astype(np.int32)
    return okey3, keymax
