"""The recording's route: a ring of robot loops laid out to KITTI 00's length.

Robot r drives one closed loop per pass, the boundary of sector r of an
annulus around the origin (sectors of 2 pi / n). The loop is four
streets, driven in this order from the outer end of radial street r:

    radial street r, inward       (shared with robot r - 1)
    inner arc of sector r
    radial street r + 1, outward  (shared with robot r + 1)
    outer arc of sector r, back to the start

With `same_direction`, odd robots drive their loop the other way round,
starting at the inner end of radial street r: with two robots both then
drive each shared street in the same direction and lane, as KITTI 00's
revisits are driven.

The two radial streets take `street_share` of the loop. With
`revisit=True` the sectors touch, so neighbouring robots drive the same
radial street (in opposite lanes): that share of each robot's keyframes
lies within a few metres of another robot's, the revisits of KITTI 00's
crossing routes. With `revisit=False` each loop is moved far from the
others and no robot meets another. The radii follow from the loop
length and the share, so both layouts drive the same loops.

`start_offset_m[r]` moves robot r's start that far along its loop.

Every robot drives on the right, `lane` metres off the street's centre
line; positions are sampled every `spacing` metres of the loop. Headings
come from the sampled centre line; the world is flat (z = 0).
"""

import math
from typing import Dict, List, Tuple

import numpy as np

# loops laid out apart are this far from each other (metres)
APART_M = 5000.0
# centre-line polylines are sampled this finely (metres)
POLY_STEP_M = 0.5


def ring_radii(loop_m: float, street_share: float, n: int):
    """(inner, outer) radius of a sector loop of length `loop_m` whose two
    radial streets take `street_share` of it."""
    radial = street_share * loop_m / 2.0
    arcs = (1.0 - street_share) * loop_m          # inner + outer arc
    r_sum = arcs * n / (2.0 * math.pi)
    inner = (r_sum - radial) / 2.0
    if inner <= 0:
        raise ValueError(f"no ring of {n} loops of {loop_m} m with "
                         f"street share {street_share}")
    return inner, inner + radial


def _arc(radius, a0, a1):
    n = max(2, int(abs(a1 - a0) * radius / POLY_STEP_M) + 1)
    a = np.linspace(a0, a1, n)
    return np.stack([radius * np.cos(a), radius * np.sin(a)], axis=1)


def _line(p0, p1):
    n = max(2, int(np.linalg.norm(p1 - p0) / POLY_STEP_M) + 1)
    s = np.linspace(0.0, 1.0, n)[:, None]
    return p0[None] * (1 - s) + p1[None] * s


def streets(n: int, inner: float, outer: float) -> Dict[Tuple, np.ndarray]:
    """The ring's streets as centre-line polylines (m, (K, 2)):
    ("radial", i) runs outward along angle 2 pi i / n; ("inner", r) and
    ("outer", r) are sector r's arcs, counter-clockwise."""
    out = {}
    for i in range(n):
        a = 2.0 * math.pi * i / n
        d = np.array([math.cos(a), math.sin(a)])
        out["radial", i] = _line(inner * d, outer * d)
        a1 = 2.0 * math.pi * (i + 1) / n
        out["inner", i] = _arc(inner, a, a1)
        out["outer", i] = _arc(outer, a, a1)
    return out


def loop_polyline(r: int, n: int, street: Dict,
                  same_direction: bool = False) -> np.ndarray:
    """Robot r's loop centre line, closed, in driving order."""
    if same_direction and r % 2:
        parts = [street["radial", r], street["outer", r],
                 street["radial", (r + 1) % n][::-1],
                 street["inner", r][::-1]]
    else:
        parts = [street["radial", r][::-1], street["inner", r],
                 street["radial", (r + 1) % n], street["outer", r][::-1]]
    return np.concatenate(parts)


def loop_offset(r: int, revisit: bool) -> np.ndarray:
    """Where robot r's loop is moved to (the origin when they touch)."""
    return np.zeros(2) if revisit else np.array([APART_M * (r + 1), 0.0])


def sample_loop(poly: np.ndarray, spacing: float, lane: float):
    """(K, 2) positions and (K,) yaws every `spacing` metres of the closed
    polyline, offset `lane` metres to the right of the direction of
    travel."""
    seg = np.linalg.norm(np.diff(poly, axis=0), axis=1)
    keep = np.concatenate([[True], seg > 1e-9])
    poly = poly[keep]
    cum = np.concatenate([[0.0], np.cumsum(np.linalg.norm(
        np.diff(poly, axis=0), axis=1))])
    count = int(round(cum[-1] / spacing))
    s = np.arange(count) * spacing
    x = np.interp(s, cum, poly[:, 0])
    y = np.interp(s, cum, poly[:, 1])
    ahead = (s + 0.5) % cum[-1]
    back = (s - 0.5) % cum[-1]
    dx = np.interp(ahead, cum, poly[:, 0]) - np.interp(back, cum, poly[:, 0])
    dy = np.interp(ahead, cum, poly[:, 1]) - np.interp(back, cum, poly[:, 1])
    yaw = np.arctan2(dy, dx)
    right = np.stack([np.sin(yaw), -np.cos(yaw)], axis=1)
    pos = np.stack([x, y], axis=1) + lane * right
    return pos, yaw


def yaw_rotations(yaw: np.ndarray) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.zeros((len(yaw), 3, 3))
    R[:, 0, 0], R[:, 0, 1] = c, -s
    R[:, 1, 0], R[:, 1, 1] = s, c
    R[:, 2, 2] = 1.0
    return R


def so3_exp(w: np.ndarray) -> np.ndarray:
    """(K, 3) rotation vectors -> (K, 3, 3), Rodrigues in float64."""
    th = np.linalg.norm(w, axis=1)
    K = np.zeros((len(w), 3, 3))
    K[:, 0, 1], K[:, 0, 2] = -w[:, 2], w[:, 1]
    K[:, 1, 0], K[:, 1, 2] = w[:, 2], -w[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -w[:, 1], w[:, 0]
    small = th < 1e-8
    ts = np.where(small, 1.0, th)
    a = np.where(small, 1.0, np.sin(ts) / ts)
    b = np.where(small, 0.5, (1.0 - np.cos(ts)) / (ts * ts))
    return (np.eye(3)[None] + a[:, None, None] * K
            + b[:, None, None] * (K @ K))


def drifted_odometry(R: np.ndarray, t: np.ndarray, sigma_rot: float,
                     sigma_trans: float, rng: np.random.Generator):
    """Odometry of a true trajectory ((K, 3, 3), (K, 3)): each relative
    pose perturbed by a rotation of sigma_rot rad and a translation of
    sigma_trans m per axis, then integrated from the true first pose."""
    k = len(t)
    Rrel = np.einsum("kji,kjl->kil", R[:-1], R[1:])
    trel = np.einsum("kji,kj->ki", R[:-1], t[1:] - t[:-1])
    noise = rng.standard_normal((k - 1, 6))
    Rrel = Rrel @ so3_exp(noise[:, :3] * sigma_rot)
    trel = trel + noise[:, 3:] * sigma_trans
    oR = np.empty_like(R)
    ot = np.empty_like(t)
    oR[0], ot[0] = R[0], t[0]
    for i in range(1, k):
        ot[i] = ot[i - 1] + oR[i - 1] @ trel[i - 1]
        oR[i] = oR[i - 1] @ Rrel[i - 1]
    return oR, ot


class Route:
    """Every robot's true poses along its loop, sampled every `spacing`
    metres: `R[r]` (K, 3, 3) and `t[r]` (K, 3), float64."""

    def __init__(self, n: int, loop_m: float, street_share: float,
                 revisit: bool, spacing: float, lane: float,
                 same_direction: bool = False, start_offset_m=None):
        self.n = n
        self.inner, self.outer = ring_radii(loop_m, street_share, n)
        self.street = streets(n, self.inner, self.outer)
        self.revisit = revisit
        self.R: List[np.ndarray] = []
        self.t: List[np.ndarray] = []
        for r in range(n):
            pos, yaw = sample_loop(
                loop_polyline(r, n, self.street, same_direction), spacing,
                lane)
            pos = pos + loop_offset(r, revisit)
            if start_offset_m:
                shift = int(round(start_offset_m[r] / spacing))
                pos, yaw = np.roll(pos, -shift, 0), np.roll(yaw, -shift)
            self.R.append(yaw_rotations(yaw))
            self.t.append(np.concatenate([pos, np.zeros((len(pos), 1))],
                                         axis=1))

    def street_polylines(self):
        """Every street once, moved with its loop: shared streets appear
        once when the loops touch, once per loop when they are apart."""
        if self.revisit:
            return list(self.street.values())
        out = []
        for r in range(self.n):
            off = loop_offset(r, False)
            for key in (("radial", r), ("inner", r),
                        ("radial", (r + 1) % self.n), ("outer", r)):
                out.append(self.street[key] + off)
        return out
