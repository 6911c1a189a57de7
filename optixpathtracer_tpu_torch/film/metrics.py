"""Image quality metrics: MSE, SSIM, and LDR-FLIP (port of
`optixpathtracer_tpu/film/metrics.py`). Each takes tensors (on any device)
or arrays and computes on the host in numpy, as the reference does.

The reference computes MSE/FLIP *outside* the repo with PBRT's image tools
(`README.md:32`, SURVEY.md section 5.5); here they are first-class so every
render can be scored in-repo (BASELINE.md targets).

FLIP follows Andersson et al. 2020 ("FLIP: A Difference Evaluator for
Alternating Images") with the published filter constants; it matches the
official implementation closely (not bit-exact - different resampling edges)
and reports the mean FLIP error like PBRT's tool.
"""
from __future__ import annotations

import numpy as np

from .color import linear_to_srgb, srgb_to_linear
from .exr import to_host


def mse(a, b):
    a = np.asarray(to_host(a), np.float64)
    b = np.asarray(to_host(b), np.float64)
    return float(np.mean((a - b) ** 2))


def sqrt_mse(a, b):
    return float(np.sqrt(mse(a, b)))


def _gaussian_kernel(sigma, radius):
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _filter2d_sep(img, k):
    """Separable 2D convolution with edge replication."""
    r = len(k) // 2
    p = np.pad(img, ((r, r), (0, 0)), mode="edge")
    tmp = np.zeros_like(img)
    for i, w in enumerate(k):
        tmp += w * p[i:i + img.shape[0], :]
    p = np.pad(tmp, ((0, 0), (r, r)), mode="edge")
    out = np.zeros_like(img)
    for i, w in enumerate(k):
        out += w * p[:, i:i + img.shape[1]]
    return out


def ssim(a, b, data_range=1.0, sigma=1.5):
    """Mean SSIM over the luminance of two [H, W, 3] images (standard
    Wang et al. constants)."""
    a = np.asarray(to_host(a), np.float64).mean(axis=-1)
    b = np.asarray(to_host(b), np.float64).mean(axis=-1)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    k = _gaussian_kernel(sigma, radius=5)
    mu_a = _filter2d_sep(a, k)
    mu_b = _filter2d_sep(b, k)
    var_a = _filter2d_sep(a * a, k) - mu_a ** 2
    var_b = _filter2d_sep(b * b, k) - mu_b ** 2
    cov = _filter2d_sep(a * b, k) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)
         / ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)))
    return float(s.mean())


# ---------------------------------------------------------------------------
# FLIP
# ---------------------------------------------------------------------------

_SRGB_TO_XYZ = np.array([
    [0.41239080, 0.35758434, 0.18048079],
    [0.21263901, 0.71516868, 0.07219232],
    [0.01933082, 0.11919478, 0.95053215]])

_D65 = np.array([0.950428545, 1.0, 1.088900371])


def _linrgb_to_ycxcz(rgb):
    xyz = rgb @ _SRGB_TO_XYZ.T
    xyz_n = xyz / _D65
    y = 116.0 * xyz_n[..., 1] - 16.0
    cx = 500.0 * (xyz_n[..., 0] - xyz_n[..., 1])
    cz = 200.0 * (xyz_n[..., 1] - xyz_n[..., 2])
    return np.stack([y, cx, cz], axis=-1)


def _ycxcz_to_linrgb(ycxcz):
    y = (ycxcz[..., 0] + 16.0) / 116.0
    x = ycxcz[..., 1] / 500.0 + y
    z = y - ycxcz[..., 2] / 200.0
    xyz = np.stack([x, y, z], axis=-1) * _D65
    return xyz @ np.linalg.inv(_SRGB_TO_XYZ).T


def _xyz_to_lab(xyz):
    t = xyz / _D65
    delta = 6.0 / 29.0
    ft = np.where(t > delta ** 3, np.cbrt(np.maximum(t, 1e-20)),
                  t / (3 * delta ** 2) + 4.0 / 29.0)
    l = 116.0 * ft[..., 1] - 16.0
    a = 500.0 * (ft[..., 0] - ft[..., 1])
    b = 200.0 * (ft[..., 1] - ft[..., 2])
    return np.stack([l, a, b], axis=-1)


def _linrgb_to_lab(rgb):
    return _xyz_to_lab(np.clip(rgb, 0.0, 1.0) @ _SRGB_TO_XYZ.T)


def _hunt(lab):
    out = lab.copy()
    out[..., 1] *= 0.01 * lab[..., 0]
    out[..., 2] *= 0.01 * lab[..., 0]
    return out


def _hyab(a, b):
    d = a - b
    return np.abs(d[..., 0]) + np.sqrt(d[..., 1] ** 2 + d[..., 2] ** 2)


def _csf_filter(ppd, a1, b1, a2, b2):
    """Spatial-domain CSF kernel (1D separable is not exact for the
    two-Gaussian sum, so build the 2D kernel)."""
    b_max = max(b1, b2)
    radius = int(np.ceil(3.0 * np.sqrt(b_max / (2.0 * np.pi ** 2)) * ppd))
    radius = max(radius, 1)
    ax = np.arange(-radius, radius + 1, dtype=np.float64) / ppd
    xx, yy = np.meshgrid(ax, ax)
    d2 = xx ** 2 + yy ** 2
    g = (a1 * np.sqrt(np.pi / b1) * np.exp(-np.pi ** 2 * d2 / b1)
         + a2 * np.sqrt(np.pi / b2) * np.exp(-np.pi ** 2 * d2 / b2))
    return g / g.sum()


def _conv2d(img, k):
    rh = k.shape[0] // 2
    rw = k.shape[1] // 2
    p = np.pad(img, ((rh, rh), (rw, rw)), mode="edge")
    out = np.zeros_like(img)
    for i in range(k.shape[0]):
        for j in range(k.shape[1]):
            if abs(k[i, j]) < 1e-12:
                continue
            out += k[i, j] * p[i:i + img.shape[0], j:j + img.shape[1]]
    return out


def flip(reference, test, ppd=67.02, inputs_are_linear=True):
    """Mean LDR-FLIP error between two [H, W, 3] images.

    inputs_are_linear: images are linear radiance (clamped/encoded to sRGB
    display first, as PBRT's flip tool does for LDR comparison).
    """
    ref = np.asarray(to_host(reference), np.float64)
    tst = np.asarray(to_host(test), np.float64)
    if inputs_are_linear:
        ref = np.clip(linear_to_srgb(np.clip(ref, 0, 1)).numpy(), 0, 1)
        tst = np.clip(linear_to_srgb(np.clip(tst, 0, 1)).numpy(), 0, 1)

    qc, qf = 0.7, 0.5
    pc, pt = 0.4, 0.95

    # --- color pipeline
    ref_lin = srgb_to_linear(ref).numpy()
    tst_lin = srgb_to_linear(tst).numpy()
    ref_ycc = _linrgb_to_ycxcz(ref_lin)
    tst_ycc = _linrgb_to_ycxcz(tst_lin)

    filters = [
        _csf_filter(ppd, 1.0, 0.0047, 0.0, 1e-5),    # A (achromatic)
        _csf_filter(ppd, 1.0, 0.0053, 0.0, 1e-5),    # RG
        _csf_filter(ppd, 34.1, 0.04, 13.5, 0.025),   # BY
    ]
    ref_f = np.stack([_conv2d(ref_ycc[..., c], filters[c]) for c in range(3)],
                     axis=-1)
    tst_f = np.stack([_conv2d(tst_ycc[..., c], filters[c]) for c in range(3)],
                     axis=-1)

    ref_rgb_f = np.clip(_ycxcz_to_linrgb(ref_f), 0.0, 1.0)
    tst_rgb_f = np.clip(_ycxcz_to_linrgb(tst_f), 0.0, 1.0)
    ref_lab = _hunt(_linrgb_to_lab(ref_rgb_f))
    tst_lab = _hunt(_linrgb_to_lab(tst_rgb_f))
    delta_e = _hyab(ref_lab, tst_lab)

    # normalization constants from the maximal green-blue HyAB distance
    green = _hunt(_linrgb_to_lab(np.array([[[0.0, 1.0, 0.0]]])))
    blue = _hunt(_linrgb_to_lab(np.array([[[0.0, 0.0, 1.0]]])))
    cmax = float(_hyab(green, blue)[0, 0]) ** qc
    delta_e = delta_e ** qc
    pccmax = pc * cmax
    delta_ec = np.where(
        delta_e < pccmax,
        pt / pccmax * delta_e,
        pt + (delta_e - pccmax) / (cmax - pccmax) * (1.0 - pt))

    # --- feature pipeline (edges + points on achromatic channel)
    sigma_f = 0.5 * 0.082 * ppd
    radius = int(np.ceil(3.0 * sigma_f))
    ax = np.arange(-radius, radius + 1, dtype=np.float64)
    xx, yy = np.meshgrid(ax, ax)
    g = np.exp(-(xx ** 2 + yy ** 2) / (2.0 * sigma_f ** 2))
    # first and second partial derivatives of the gaussian
    gx = -xx / sigma_f ** 2 * g
    gxx = (xx ** 2 / sigma_f ** 2 - 1.0) / sigma_f ** 2 * g
    # normalize as the FLIP reference does: positive/negative lobes to +-1
    def _norm(k):
        pos = k[k > 0].sum()
        neg = -k[k < 0].sum()
        out = k.copy()
        if pos > 0:
            out[k > 0] /= pos
        if neg > 0:
            out[k < 0] /= neg
        return out
    gx, gy = _norm(gx), _norm(gx.T)
    gxx, gyy = _norm(gxx), _norm(gxx.T)

    y_ref = (ref_ycc[..., 0] + 16.0) / 116.0
    y_tst = (tst_ycc[..., 0] + 16.0) / 116.0

    def _feat(img, kx, ky):
        fx = _conv2d(img, kx)
        fy = _conv2d(img, ky)
        return np.sqrt(fx ** 2 + fy ** 2)

    edge_diff = np.abs(_feat(y_ref, gx, gy) - _feat(y_tst, gx, gy))
    point_diff = np.abs(_feat(y_ref, gxx, gyy) - _feat(y_tst, gxx, gyy))
    delta_ef = np.clip(
        (1.0 / np.sqrt(2.0)) * np.maximum(edge_diff, point_diff), 0, 1) ** qf

    flip_err = delta_ec ** (1.0 - delta_ef)
    return float(flip_err.mean())
