"""Synthetic geometric-shape dataset for self-training the learned
front-end (SuperPoint detector/descriptor + LightGlue matcher).

A copy of cslam_tpu/models/synthetic_shapes.py (numpy only; the port
imports nothing of the reference package): the same seeds give
bit-identical renders, corners, homographies and warps. Renderings of
simple geometric primitives whose corner locations are known exactly,
plus random homographies for correspondence supervision (the MagicPoint
stage of DeTone et al., 2018).

Everything is plain numpy on the host: image synthesis is data loading,
not device math. Images are float32 in [0, 1], corner coordinates are
(x, y) pixel positions.
"""

import numpy as np

# ----------------------------------------------------------------------
# rasterization helpers (vectorized over the pixel grid)
# ----------------------------------------------------------------------


def _grid(H, W):
    yy, xx = np.mgrid[0:H, 0:W]
    return xx.astype(np.float32), yy.astype(np.float32)


def _draw_line(img, p0, p1, value, thickness=1.0):
    """Draw segment p0-p1 by thresholding distance-to-segment."""
    H, W = img.shape
    xx, yy = _grid(H, W)
    d = np.asarray(p1, np.float32) - np.asarray(p0, np.float32)
    L2 = max(float(d @ d), 1e-6)
    t = ((xx - p0[0]) * d[0] + (yy - p0[1]) * d[1]) / L2
    t = np.clip(t, 0.0, 1.0)
    px = p0[0] + t * d[0]
    py = p0[1] + t * d[1]
    dist2 = (xx - px) ** 2 + (yy - py) ** 2
    img[dist2 <= thickness ** 2] = value
    return img


def _fill_convex(img, pts, value):
    """Fill a convex polygon given CCW-ordered vertices."""
    H, W = img.shape
    xx, yy = _grid(H, W)
    inside = np.ones((H, W), dtype=bool)
    n = len(pts)
    for i in range(n):
        x0, y0 = pts[i]
        x1, y1 = pts[(i + 1) % n]
        # CCW: interior is to the left of each directed edge
        cross = (x1 - x0) * (yy - y0) - (y1 - y0) * (xx - x0)
        inside &= cross >= 0
    img[inside] = value
    return img


def _convex_polygon(rng, H, W, n_max=6):
    """Random convex polygon: sorted angles around a random center."""
    n = int(rng.integers(3, n_max + 1))
    cx = rng.uniform(0.25 * W, 0.75 * W)
    cy = rng.uniform(0.25 * H, 0.75 * H)
    radius = rng.uniform(0.12, 0.35) * min(H, W)
    angles = np.sort(rng.uniform(0, 2 * np.pi, size=n))
    # reject near-duplicate angles (degenerate corners)
    if np.min(np.diff(np.concatenate([angles, angles[:1] + 2 * np.pi]))) \
            < 0.35:
        return None
    r = radius * rng.uniform(0.7, 1.0, size=n)
    pts = np.stack([cx + r * np.cos(angles), cy + r * np.sin(angles)],
                   axis=1).astype(np.float32)
    return pts


# ----------------------------------------------------------------------
# primitive generators: each returns (image_mutated, corners (N, 2))
# ----------------------------------------------------------------------


def _prim_polygon(img, rng):
    pts = _convex_polygon(rng, *img.shape)
    if pts is None:
        return img, np.zeros((0, 2), np.float32)
    _fill_convex(img, pts, rng.uniform(0, 1))
    return img, pts


def _prim_lines(img, rng):
    H, W = img.shape
    corners = []
    for _ in range(int(rng.integers(1, 4))):
        p0 = np.array([rng.uniform(0, W - 1), rng.uniform(0, H - 1)])
        p1 = np.array([rng.uniform(0, W - 1), rng.uniform(0, H - 1)])
        if np.hypot(*(p1 - p0)) < 0.2 * min(H, W):
            continue
        _draw_line(img, p0, p1, rng.uniform(0, 1),
                   thickness=rng.uniform(0.8, 2.0))
        corners += [p0, p1]
    return img, (np.stack(corners).astype(np.float32)
                 if corners else np.zeros((0, 2), np.float32))


def _prim_star(img, rng):
    H, W = img.shape
    c = np.array([rng.uniform(0.3 * W, 0.7 * W),
                  rng.uniform(0.3 * H, 0.7 * H)])
    corners = [c]
    n = int(rng.integers(3, 6))
    angles = np.sort(rng.uniform(0, 2 * np.pi, size=n))
    if np.min(np.diff(np.concatenate([angles, angles[:1] + 2 * np.pi]))) \
            < 0.4:
        return img, np.zeros((0, 2), np.float32)
    for a in angles:
        r = rng.uniform(0.15, 0.35) * min(H, W)
        p = c + r * np.array([np.cos(a), np.sin(a)])
        _draw_line(img, c, p, rng.uniform(0, 1),
                   thickness=rng.uniform(0.8, 1.6))
        corners.append(p)
    return img, np.stack(corners).astype(np.float32)


def _prim_checkerboard(img, rng):
    H, W = img.shape
    rows, cols = int(rng.integers(3, 6)), int(rng.integers(3, 6))
    # random affine placement of the unit grid
    origin = np.array([rng.uniform(0.1 * W, 0.4 * W),
                       rng.uniform(0.1 * H, 0.4 * H)])
    ex = rng.uniform(0.08, 0.16) * min(H, W) * np.array(
        [np.cos(a := rng.uniform(0, 2 * np.pi)), np.sin(a)])
    ey_angle = a + np.pi / 2 + rng.uniform(-0.3, 0.3)
    ey = rng.uniform(0.08, 0.16) * min(H, W) * np.array(
        [np.cos(ey_angle), np.sin(ey_angle)])
    shades = rng.uniform(0, 1, size=(rows, cols))
    corners = []
    for i in range(rows):
        for j in range(cols):
            p00 = origin + i * ey + j * ex
            quad = np.stack([p00, p00 + ex, p00 + ex + ey, p00 + ey])
            # _fill_convex needs CCW: our (ex, ey) basis may be CW
            if np.cross(ex, ey) < 0:
                quad = quad[::-1]
            _fill_convex(img, quad.astype(np.float32), shades[i, j])
    for i in range(rows + 1):
        for j in range(cols + 1):
            corners.append(origin + i * ey + j * ex)
    return img, np.stack(corners).astype(np.float32)


def _prim_ellipse(img, rng):
    """Ellipses have no corners — pure distractor (teaches the detector
    to reject curved boundaries)."""
    H, W = img.shape
    xx, yy = _grid(H, W)
    cx = rng.uniform(0.2 * W, 0.8 * W)
    cy = rng.uniform(0.2 * H, 0.8 * H)
    a = rng.uniform(0.05, 0.25) * W
    b = rng.uniform(0.05, 0.25) * H
    th = rng.uniform(0, np.pi)
    xr = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
    yr = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
    img[(xr / a) ** 2 + (yr / b) ** 2 <= 1.0] = rng.uniform(0, 1)
    return img, np.zeros((0, 2), np.float32)


_PRIMITIVES = (_prim_polygon, _prim_lines, _prim_star, _prim_checkerboard,
               _prim_ellipse)


def _box_blur(img, radius=1):
    k = 2 * radius + 1
    out = np.cumsum(np.pad(img, ((radius + 1, radius), (0, 0)),
                           mode="edge"), axis=0)
    img = (out[k:] - out[:-k]) / k
    out = np.cumsum(np.pad(img, ((0, 0), (radius + 1, radius)),
                           mode="edge"), axis=1)
    return (out[:, k:] - out[:, :-k]) / k


_PHOTO = None


def photo_source_path():
    """Where the "photo" background's portrait is looked up: matplotlib's
    bundled grace_hopper.jpg beside numpy, the reference's location."""
    import os
    return os.path.join(os.path.dirname(np.__file__), "..", "matplotlib",
                        "mpl-data", "sample_data", "grace_hopper.jpg")


def _photo_source():
    """Real photographic texture for background augmentation: the same
    public-domain portrait the checked-in real_seq is cut from. Raises
    FileNotFoundError naming the path when it is not installed; no other
    image stands in for it."""
    global _PHOTO
    if _PHOTO is None:
        import os
        from PIL import Image
        src = photo_source_path()
        if not os.path.exists(src):
            raise FileNotFoundError(
                f"the photo background needs {os.path.normpath(src)} "
                f"(matplotlib's sample data), which is not installed")
        _PHOTO = np.asarray(Image.open(src).convert("L"),
                            dtype=np.float32) / 255.0
    return _PHOTO


def _background(rng, H, W, background):
    """Background canvas by mode. 'mixed' samples per image — the
    detector trained on 'gradient' only yielded <10 detections on black
    or random-texture canvases."""
    if background == "mixed":
        background = rng.choice(
            ["gradient", "black", "texture", "photo"],
            p=[0.55, 0.15, 0.15, 0.15])
    xx, yy = _grid(H, W)
    if background == "black":
        img = np.full((H, W), float(rng.uniform(0.0, 0.08)), np.float32)
    elif background == "texture":
        # random low-frequency blobs + broadband noise
        img = np.full((H, W), float(rng.uniform(0.2, 0.7)), np.float32)
        for _ in range(int(rng.integers(4, 10))):
            cx, cy = rng.uniform(0, W), rng.uniform(0, H)
            r = rng.uniform(6, 30)
            blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) /
                            (2 * r * r)))
            img += rng.uniform(-0.3, 0.3) * blob.astype(np.float32)
        img += 0.05 * rng.standard_normal((H, W)).astype(np.float32)
    elif background == "photo":
        photo = _photo_source()
        ph, pw = photo.shape
        y0 = int(rng.integers(0, max(ph - H, 1)))
        x0 = int(rng.integers(0, max(pw - W, 1)))
        img = photo[y0:y0 + H, x0:x0 + W].copy()
        if img.shape != (H, W):  # source smaller than canvas
            img = np.resize(img, (H, W))
        if rng.random() < 0.5:
            img = img[:, ::-1]
        img = img * rng.uniform(0.6, 1.1) + rng.uniform(-0.1, 0.1)
    else:  # gradient (the original distribution)
        g = rng.standard_normal(2)
        img = 0.5 + 0.15 * (g[0] * (xx / W - 0.5) + g[1] * (yy / H - 0.5))
    img = img + 0.03 * rng.standard_normal((H, W))
    return np.clip(img, 0, 1).astype(np.float32)


def background_corner_cells(bg, cell=8, threshold=0.12):
    """(H//cell, W//cell) bool mask of cells where the BACKGROUND
    itself has corner structure (Shi-Tomasi min-eigenvalue of the
    structure tensor, cell-pooled).

    Photo/texture backgrounds contain real corners that carry no
    label; training the detector's dustbin on those cells actively
    teaches it to SUPPRESS real corners (measured round 4: a mixed-
    background continuation run dropped real-photo detections 128 ->
    56-95 and blob-scene detections 26 -> 5). Such cells must be
    EXCLUDED from the detector loss, not labeled empty."""
    gy, gx = np.gradient(bg.astype(np.float32))
    Ixx, Iyy, Ixy = gx * gx, gy * gy, gx * gy
    H, W = bg.shape
    Hc, Wc = H // cell, W // cell

    def pool(a):
        return a[:Hc * cell, :Wc * cell].reshape(
            Hc, cell, Wc, cell).sum(axis=(1, 3))

    sxx, syy, sxy = pool(Ixx), pool(Iyy), pool(Ixy)
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    disc = np.sqrt(np.maximum(tr * tr / 4.0 - det, 0.0))
    lam_min = tr / 2.0 - disc
    # ABSOLUTE threshold (a relative one marks everything on flat
    # canvases whose only signal is sensor noise). Measured cell
    # lam_min: gradient/black backgrounds max 0.05, texture blobs max
    # 0.19, real-photo corners reach 1.6 with p99 0.49 — 0.12 passes
    # noise and smooth blobs, catches photographic structure.
    return lam_min > threshold


def render_shapes(rng, H=120, W=160, n_primitives=None,
                  background="gradient", return_ignore=False):
    """One synthetic image: background + random primitives.

    Returns (image (H, W) float32 [0,1], corners (N, 2) float32 xy)
    — plus, with return_ignore=True, the (H//8, W//8) bool mask of
    cells whose BACKGROUND has its own (unlabeled) corner structure
    (see background_corner_cells).

    background: 'gradient' (the original synthetic_shapes canvas),
    'black', 'texture', 'photo' (real photographic crops), or 'mixed'.
    """
    img = _background(rng, H, W, background)
    ignore = background_corner_cells(img) if return_ignore else None

    n = int(rng.integers(2, 5)) if n_primitives is None else n_primitives
    corners = [np.zeros((0, 2), np.float32)]
    for _ in range(n):
        prim = _PRIMITIVES[rng.integers(len(_PRIMITIVES))]
        img, c = prim(img, rng)
        corners.append(c)
    corners = np.concatenate(corners, axis=0)
    # occlusion pruning: a later primitive may paint over an earlier
    # one's corner; cheap check — keep corners with local contrast
    img = _box_blur(img, 1).astype(np.float32)
    img = np.clip(img + 0.02 * rng.standard_normal((H, W)), 0,
                  1).astype(np.float32)
    keep = (corners[:, 0] >= 2) & (corners[:, 0] <= W - 3) & \
           (corners[:, 1] >= 2) & (corners[:, 1] <= H - 3)
    if return_ignore:
        return img, corners[keep], ignore
    return img, corners[keep]


# ----------------------------------------------------------------------
# homographies
# ----------------------------------------------------------------------


def random_homography(rng, H, W, max_angle=0.6, max_scale=0.25,
                      max_translate=0.15, max_persp=0.0008):
    """Random similarity + perspective homography mapping (x,y,1)."""
    a = rng.uniform(-max_angle, max_angle)
    s = np.exp(rng.uniform(-max_scale, max_scale))
    tx = rng.uniform(-max_translate, max_translate) * W
    ty = rng.uniform(-max_translate, max_translate) * H
    cx, cy = W / 2.0, H / 2.0
    ca, sa = np.cos(a), np.sin(a)
    # rotate+scale around center, then translate
    A = np.array([[s * ca, -s * sa, cx - s * (ca * cx - sa * cy) + tx],
                  [s * sa, s * ca, cy - s * (sa * cx + ca * cy) + ty],
                  [0, 0, 1]], dtype=np.float64)
    P = np.eye(3)
    P[2, 0] = rng.uniform(-max_persp, max_persp)
    P[2, 1] = rng.uniform(-max_persp, max_persp)
    return (A @ P).astype(np.float32)


def apply_homography(Hm, xy):
    """(N, 2) points through 3x3 homography."""
    xy1 = np.concatenate([xy, np.ones((len(xy), 1), np.float32)], axis=1)
    w = xy1 @ Hm.T
    return w[:, :2] / np.maximum(w[:, 2:3], 1e-8)


def warp_image(img, Hm):
    """Inverse-mapped bilinear warp of (H, W) image by homography Hm
    (maps source coords -> target coords). Out-of-bounds = 0."""
    H, W = img.shape
    xx, yy = _grid(H, W)
    Hinv = np.linalg.inv(Hm.astype(np.float64)).astype(np.float32)
    pts = np.stack([xx.ravel(), yy.ravel()], axis=1)
    src = apply_homography(Hinv, pts)
    sx = src[:, 0].reshape(H, W)
    sy = src[:, 1].reshape(H, W)
    x0 = np.floor(sx).astype(np.int32)
    y0 = np.floor(sy).astype(np.int32)
    fx = sx - x0
    fy = sy - y0
    valid = (x0 >= 0) & (x0 < W - 1) & (y0 >= 0) & (y0 < H - 1)
    x0c = np.clip(x0, 0, W - 2)
    y0c = np.clip(y0, 0, H - 2)
    v00 = img[y0c, x0c]
    v01 = img[y0c, x0c + 1]
    v10 = img[y0c + 1, x0c]
    v11 = img[y0c + 1, x0c + 1]
    out = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy) +
           v10 * (1 - fx) * fy + v11 * fx * fy)
    return np.where(valid, out, 0.0).astype(np.float32), \
        valid.astype(np.float32)


# ----------------------------------------------------------------------
# training-sample assembly
# ----------------------------------------------------------------------


def corners_to_cell_labels(corners, H, W, cell=8):
    """(Hc, Wc) int labels in [0, 64]: position index of the corner
    within its 8x8 cell, or 64 (dustbin) when the cell has no corner.
    When several corners land in one cell an arbitrary one wins (matches
    the SuperPoint training setup)."""
    Hc, Wc = H // cell, W // cell
    labels = np.full((Hc, Wc), cell * cell, dtype=np.int32)
    for x, y in corners:
        xi, yi = int(round(x)), int(round(y))
        if not (0 <= xi < Wc * cell and 0 <= yi < Hc * cell):
            continue
        labels[yi // cell, xi // cell] = (yi % cell) * cell + (xi % cell)
    return labels


def make_detector_sample(rng, H=120, W=160, background="gradient"):
    """(image, cell_labels) pair for detector training."""
    img, corners = render_shapes(rng, H, W, background=background)
    return img, corners_to_cell_labels(corners, H, W)


def make_pair_sample(rng, H=120, W=160, background="gradient"):
    """Homography pair for descriptor/matcher training.

    Returns dict with images, the homography, GT corners of the source,
    and the warped validity mask.
    """
    img0, corners, ignore0 = render_shapes(rng, H, W,
                                           background=background,
                                           return_ignore=True)
    Hm = random_homography(rng, H, W)
    img1, valid1 = warp_image(img0, Hm)
    # view-1 ignore mask: warp the per-pixel ignore field like the
    # image (nearest via the same bilinear warp thresholded)
    ig_px = np.repeat(np.repeat(ignore0.astype(np.float32), 8, axis=0),
                      8, axis=1)
    ig_px = ig_px[:H, :W]
    pad = np.zeros((H, W), np.float32)
    pad[:ig_px.shape[0], :ig_px.shape[1]] = ig_px
    ig1_px, _ = warp_image(pad, Hm)
    ignore1 = ig1_px[4::8, 4::8][:H // 8, :W // 8] > 0.25
    # brightness/contrast jitter on the warped view
    img1 = np.clip(img1 * rng.uniform(0.7, 1.3) +
                   rng.uniform(-0.12, 0.12), 0, 1).astype(np.float32)
    img1 = np.clip(img1 + 0.02 * rng.standard_normal((H, W)),
                   0, 1).astype(np.float32)
    labels0 = corners_to_cell_labels(corners, H, W)
    c1 = apply_homography(Hm, corners) if len(corners) else corners
    keep = np.ones(len(corners), dtype=bool)
    if len(corners):
        keep = (c1[:, 0] >= 2) & (c1[:, 0] <= W - 3) & \
               (c1[:, 1] >= 2) & (c1[:, 1] <= H - 3)
    labels1 = corners_to_cell_labels(c1[keep] if len(corners) else c1, H, W)
    return {"img0": img0, "img1": img1, "H": Hm, "corners0": corners,
            "corners1": c1[keep] if len(corners) else c1,
            "labels0": labels0, "labels1": labels1, "valid1": valid1,
            "ignore0": ignore0, "ignore1": ignore1}
