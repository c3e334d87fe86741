"""Video kernel-initialization strategies for global-motion-compensated fits.

A copy of smoe_tpu/video/init_strategies.py (numpy + scipy, imports
pointed into the port).  Host-side, run once before the fit.  Mirrors the semantics of
the reference's `do_perspectiveTransform` (reference smoe.py:1895-2138):
the (y, x, t) pixel domain is warped by per-frame affine/homography
matrices (time collapsed onto the -5 plane so motion-compensated kernels
are time-invariant), then one of five strategies places kernels on the
warped domain:

  init_flag 1    : regular-grid cells -> mean warped coordinate per cell
  init_flag 2/2.5: 2D grid tiled over the warped extent, kmeans assignment;
                   kernels per site from LUMINANCE variance (2: time means
                   from data span, 2.5: center at t=.5)
  init_flag 3/3.5: like 2 but kernels per site from the FRAME count
  init_flag 4    : 3D grid tiled over the warped extent, 3D kmeans,
                   keep non-empty sites
  init_flag 5    : 2D grid scaled (x1.1 sqrt(kpd_t)) to the warped extent,
                   2D kmeans, keep non-empty sites

The reference additionally concatenates a second, initially-disabled kernel
set living on the RAW domain ("dual model", reference smoe.py:280-329);
`dual_model_concat` builds that layout plus the per-kernel model mask.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from smoe_tpu_torch.video.motion import TIME_PLANE


def warp_domain(image: np.ndarray, affines: np.ndarray,
                num_params_model: int) -> np.ndarray:
    """Warp the (H, W, T) coordinate grid by per-frame matrices.

    image: (H, W, T, C); affines: (T, 2|3, 3) pixel-unit cv2-style matrices
    (translations scaled by the image size like reference smoe.py:1899-1913).
    Returns (H, W, T, 3) warped [y, x, t=TIME_PLANE] coordinates.

    DELIBERATE DEVIATION: the reference's do_perspectiveTransform divides
    the x translation by (H-1) and the y translation by (W-1)
    (smoe.py:1901-1908) — swapped relative to its OWN training transform,
    which initializes h13 = tx/(W-1), h23 = ty/(H-1) (smoe.py:560-566).
    We normalize like the training transform so the init warp and the
    trained gating agree (warp_domain == transform_coords, invisible on
    square frames, misplaces init kernels on non-square ones otherwise).
    """
    h, w, t = image.shape[:3]
    yy = np.linspace(0.0, 1.0, h)[:, None, None]
    xx = np.linspace(0.0, 1.0, w)[None, :, None]
    y = np.broadcast_to(yy, (h, w, t)).astype(np.float64)
    x = np.broadcast_to(xx, (h, w, t)).astype(np.float64)
    out = np.empty((h, w, t, 3), np.float32)

    for ti, m in enumerate(affines):
        if num_params_model == 2:
            xd = x[:, :, ti] + m[0, 2] / (w - 1)
            yd = y[:, :, ti] + m[1, 2] / (h - 1)
        elif num_params_model == 4:
            xd = m[0, 0] * x[:, :, ti] + m[0, 1] * y[:, :, ti] + m[0, 2] / (w - 1)
            yd = -m[0, 1] * x[:, :, ti] + m[0, 0] * y[:, :, ti] + m[1, 2] / (h - 1)
        else:
            yd = m[1, 0] * x[:, :, ti] + m[1, 1] * y[:, :, ti] + m[1, 2] / (h - 1)
            xd = m[0, 0] * x[:, :, ti] + m[0, 1] * y[:, :, ti] + m[0, 2] / (w - 1)
            if num_params_model == 8 and affines.shape[1] == 3:
                wd = m[2, 0] * x[:, :, ti] + m[2, 1] * y[:, :, ti] + 1.0
                xd = xd / wd
                yd = yd / wd
        out[:, :, ti, 0] = yd
        out[:, :, ti, 1] = xd
    out[..., 2] = TIME_PLANE
    return out


def motion_from_affines(affines: np.ndarray, image_shape: Tuple[int, ...]
                        ) -> np.ndarray:
    """(8, T) h-parameter rows [h11..h32] from cv2 affine matrices
    (reference smoe.py:558-575: translations normalized by image size)."""
    t = affines.shape[0]
    h, w = image_shape[0], image_shape[1]
    m = np.zeros((8, t), np.float32)
    m[0] = affines[:, 0, 0]
    m[1] = affines[:, 0, 1]
    m[2] = affines[:, 0, 2] / (w - 1)
    m[3] = affines[:, 1, 0]
    m[4] = affines[:, 1, 1]
    m[5] = affines[:, 1, 2] / (h - 1)
    if affines.shape[1] == 3:
        m[6] = affines[:, 2, 0]
        m[7] = affines[:, 2, 1]
    return m


def _flat_grid(kpd, dims: int) -> np.ndarray:
    """Regular inset grid of centers, (prod(kpd), dims)."""
    axes = [np.linspace(0.5 / n, 1.0 - 0.5 / n, int(n)) for n in kpd[:dims]]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack(grids, -1).reshape(-1, dims)


def _tile_over_extent(centers: np.ndarray, warped: np.ndarray) -> np.ndarray:
    """Replicate a [0,1]-grid over all integer (y, x) shifts covering the
    warped coordinate extent (reference smoe.py:1969-1983).

    The lower shift uses sign(min)*ceil(|min|) exactly like the reference
    (smoe.py:1969-1972) — for a POSITIVE fractional minimum this rounds
    away from zero (0.3 -> 1), skipping the first tile; kmeans then assigns
    those pixels to the nearest remaining centers, as in the reference."""
    mn_y = np.sign(warped[..., 0].min()) * np.ceil(abs(warped[..., 0].min()))
    mn_x = np.sign(warped[..., 1].min()) * np.ceil(abs(warped[..., 1].min()))
    mx_y = np.ceil(warped[..., 0].max())
    mx_x = np.ceil(warped[..., 1].max())
    shifted = []
    for yy in range(int(mn_y), max(int(mx_y), int(mn_y) + 1)):
        for xx in range(int(mn_x), max(int(mx_x), int(mn_x) + 1)):
            s = centers.copy()
            s[:, 0] += yy
            s[:, 1] += xx
            shifted.append(s)
    return np.vstack(shifted)


def _diag_A(kpd, time_bw: float, d: int = 3) -> np.ndarray:
    a = np.zeros((d, d), np.float32)
    a[0, 0] = 2.0 * (kpd[0] + 1)
    a[1, 1] = 2.0 * (kpd[1] + 1)
    a[2, 2] = time_bw
    return a


def video_kernel_init(image: np.ndarray, warped: np.ndarray,
                      kernels_per_dim, init_flag: float) -> Dict[str, np.ndarray]:
    """Kernel set on the warped domain per strategy (see module docstring).

    Returns dict(musX (K,3), A (K,3,3), nu_e (K,C), gamma_e (K,3,C),
    pis (K,)).  K is data-dependent for flags >= 2.
    """
    from scipy.cluster.vq import kmeans2

    kpd = list(kernels_per_dim)
    if len(kpd) == 1:
        kpd = kpd * 3
    h, w, t, c = image.shape
    lum = image[..., 0].reshape(-1)
    yx = warped[..., :2].reshape(-1, 2).astype(np.float64)
    tcoord_plane = warped[..., 2].reshape(-1)          # all TIME_PLANE

    if init_flag == 1:
        # mean warped coordinate per regular grid cell (smoe.py:1916-1951)
        musX = np.zeros((int(np.prod(kpd)), 3), np.float32)
        cnt = 0
        for xx in range(kpd[1]):
            for yy in range(kpd[0]):
                for zz in range(kpd[2]):
                    ys = int(np.floor(h / kpd[0]) * yy)
                    ye = int(min(np.ceil(h / kpd[0]) * (yy + 1), h))
                    xs = int(np.floor(w / kpd[1]) * xx)
                    xe = int(min(np.ceil(w / kpd[1]) * (xx + 1), w))
                    zs = int(np.floor(t / kpd[2]) * zz)
                    ze = int(min(np.ceil(t / kpd[2]) * (zz + 1), t))
                    musX[cnt] = warped[ys:ye, xs:xe, zs:ze, :].mean((0, 1, 2))
                    cnt += 1
        k = musX.shape[0]
        A = np.tile(np.diag([2.0 * (kpd[0] + 1), 2.0 * (kpd[1] + 1),
                             2.0 * (kpd[2] + 1)]).astype(np.float32)[None],
                    (k, 1, 1))

    elif 2 <= init_flag < 4:
        flat = _tile_over_extent(_flat_grid(kpd, 2), warped)
        _, labels = kmeans2(yx, flat, 1)
        sites = np.unique(labels)
        # kernels per site from luminance variance (smoe.py:1988-1994);
        # one bincount pass: var = E[x^2] - E[x]^2 per label, O(N) instead
        # of a full boolean scan per site
        nmax = int(labels.max()) + 1
        cnt = np.bincount(labels, minlength=nmax).astype(np.float64)
        s1 = np.bincount(labels, weights=lum, minlength=nmax)
        s2 = np.bincount(labels, weights=lum.astype(np.float64) ** 2,
                         minlength=nmax)
        safe = np.maximum(cnt, 1.0)
        lum_var = np.maximum(s2 / safe - (s1 / safe) ** 2, 0.0)[sites]
        varspace = np.linspace(lum_var.min(), lum_var.max(), kpd[2])
        n_per_site = np.argmin(
            np.abs(lum_var[None, :] - varspace[:, None]), axis=0) + 1

        mus, As = [], []
        for i, s in enumerate(sites):
            tc = tcoord_plane[labels == s]
            if len(np.unique(tc)) == 1:
                # the warped t is the constant TIME_PLANE, so this always
                # fires and each site gets ONE kernel — faithfully mirrors
                # the reference, whose identical guard (smoe.py:1994-1995)
                # makes its variance-driven multi-kernel branches
                # unreachable for the same reason (t := -5, smoe.py:1897)
                n_per_site[i] = 1
            if n_per_site[i] == 1:
                if init_flag % 1 == 0.5:
                    mus.append(np.hstack([flat[s], 0.5]))
                    tb = 2.0 * (1 + 1)
                else:
                    mus.append(np.hstack([flat[s], tc.mean()]))
                    tb = min(1.0 / max(np.sqrt(tc.var()), 1e-12),
                             2.0 * (t + 1))
                As.append(_diag_A(kpd, tb))
            elif np.floor(init_flag) == 2:
                tmeans = np.linspace(tc.min(), tc.max(), n_per_site[i])
                tl = np.argmin(np.abs(tc[:, None] - tmeans[None, :]), axis=1)
                nk = len(np.unique(tl))
                for j in np.unique(tl):
                    tb = min(1.0 / (np.sqrt(tc[tl == j].var()) + 1e-5),
                             2.0 * (t + 1) * nk)
                    if np.isnan(tb):
                        continue
                    mus.append(np.hstack([flat[s], tmeans[j]]))
                    As.append(_diag_A(kpd, tb))
            else:   # floor == 3: per-frame-count regular time means
                n_t = int(np.ceil(len(np.unique(tc)) * kpd[2] / t))
                tmeans = (_flat_grid([n_t], 1)[:, 0]
                          * (tc.max() - tc.min()) + tc.min())
                for tm in tmeans:
                    mus.append(np.hstack([flat[s], tm]))
                    As.append(_diag_A(kpd, 2.0 * (len(tmeans) + 1)))
        musX = np.stack(mus).astype(np.float32)
        A = np.stack(As).astype(np.float32)
        k = musX.shape[0]

    elif init_flag in (4, 5):
        kpd2 = list(kpd)
        kpd2[2] = 1
        if init_flag == 5:
            for i in range(2):
                kpd2[i] = int(np.ceil(kpd2[i] * 1.1 * np.sqrt(kpd[2])))
        flat = _flat_grid(kpd2, 3)
        flat[:, 2] = 0.5
        if init_flag == 4:
            flat = _tile_over_extent(flat, warped)
            coords3 = warped.reshape(-1, 3).astype(np.float64)
            _, labels = kmeans2(coords3, flat, 1)
        else:
            mn_y, mx_y = warped[..., 0].min(), warped[..., 0].max()
            mn_x, mx_x = warped[..., 1].min(), warped[..., 1].max()
            flat[:, 0] = flat[:, 0] * (mx_y - mn_y) + mn_y
            flat[:, 1] = flat[:, 1] * (mx_x - mn_x) + mn_x
            _, labels = kmeans2(yx, flat[:, :2], 1)
        musX = flat[np.unique(labels)].astype(np.float32)
        k = musX.shape[0]
        A = np.tile(_diag_A(kpd2, 1.0)[None], (k, 1, 1)).astype(np.float32)
    else:
        raise ValueError(f"invalid init_flag {init_flag}")

    return {
        "musX": musX,
        "A": A,
        "nu_e": np.full((k, c), 0.5, np.float32),
        "gamma_e": np.zeros((k, 3, c), np.float32),
        "pis": np.ones((k,), np.float32),
    }


def dual_model_concat(model0: Dict[str, np.ndarray],
                      model1: Dict[str, np.ndarray]
                      ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Concatenate the motion-compensated set (model 0, evaluated on the
    transformed domain) with the raw-domain set (model 1, pis zeroed so the
    background kernels start disabled) — reference smoe.py:296-306.

    Returns (init dict, model_mask (K,) bool: True -> transformed domain).
    """
    k0 = model0["pis"].shape[0]
    k1 = model1["pis"].shape[0]
    out = {
        "musX": np.concatenate([model0["musX"], model1["musX"]], 0),
        "A": np.concatenate([model0["A"], model1["A"]], 0),
        "nu_e": np.concatenate([model0["nu_e"], model1["nu_e"]], 0),
        "gamma_e": np.concatenate([model0["gamma_e"], model1["gamma_e"]], 0),
        "pis": np.concatenate([model0["pis"],
                               np.zeros_like(model1["pis"])], 0),
    }
    out["musX"][:k0, 2] = TIME_PLANE
    mask = np.concatenate([np.ones((k0,), bool), np.zeros((k1,), bool)])
    return out, mask
