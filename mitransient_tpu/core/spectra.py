"""Spectral rendering support: CIE colorimetry + hero-wavelength sampling.

JAX counterpart of the Mitsuba pieces the reference's spectral
variants rely on (SURVEY.md §2.2 "Spectral→RGB"): ``mi.sample_rgb_spectrum``
/ ``sample_shifted`` (wavelength importance sampling,
nloscapturemeter.py:169-175) and ``mi.spectrum_to_srgb`` (splat-time
conversion, transient_image_block.py:91).

Design: each lane carries ``N_WL`` hero wavelengths that share one path
(hero-wavelength MIS with equal weights); RGB scene colors are uplifted to
smooth reflectance spectra with the Smits (1999) basis; emission is
modulated by CIE D65.  Radiance samples convert to sRGB *at splat time*, so
films stay 3-channel exactly like the reference's image blocks.

All tables are public standard data (CIE 1931 fits per Wyman, Sloan &
Shirley 2013; Smits' published basis; CIE D65).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

N_WL = 4  # hero wavelengths per lane
WL_MIN, WL_MAX = 360.0, 830.0


# --------------------------------------------------------------------------
# CIE 1931 color matching (multi-Gaussian fits, Wyman/Sloan/Shirley 2013)
# --------------------------------------------------------------------------

def _g(x, alpha, mu, s1, s2):
    s = jnp.where(x < mu, s1, s2)
    t = (x - mu) / s
    return alpha * jnp.exp(-0.5 * t * t)


def cie_xyz(wl):
    """CIE 1931 2-deg color matching functions at wavelength(s) in nm."""
    x = (_g(wl, 0.362, 442.0, 16.0, 26.7)
         + _g(wl, 1.056, 599.8, 37.9, 31.0)
         + _g(wl, -0.065, 501.1, 20.4, 26.2))
    y = (_g(wl, 0.821, 568.8, 46.9, 40.5)
         + _g(wl, 0.286, 530.9, 16.3, 31.1))
    z = (_g(wl, 1.217, 437.0, 11.8, 36.0)
         + _g(wl, 0.681, 459.0, 26.0, 13.8))
    return jnp.stack([x, y, z], axis=-1)


# CIE standard illuminant D65, 360-830 nm at 10 nm (relative SPD, 560=100)
_D65 = np.array([
    46.64, 49.36, 52.09, 51.03, 49.98, 52.31, 54.65, 68.70, 82.75, 87.12,
    91.49, 92.46, 93.43, 90.06, 86.68, 95.77, 104.86, 110.94, 117.01,
    117.41, 117.81, 116.34, 114.86, 115.39, 115.92, 112.37, 108.81, 109.08,
    109.35, 108.58, 107.80, 106.30, 104.79, 106.24, 107.69, 106.05, 104.41,
    104.23, 104.05, 102.02, 100.00, 98.17, 96.33, 96.06, 95.79, 92.24,
    88.69, 89.35, 90.01, 89.80, 89.60, 88.65, 87.70, 85.49, 83.29, 83.49,
    83.70, 81.86, 80.03, 80.12, 80.21, 81.25, 82.28, 80.28, 78.28, 74.00,
    69.72, 70.67, 71.61, 72.98, 74.35, 67.98, 61.60, 65.74, 69.89, 72.49,
    75.09, 69.34, 63.59, 55.01, 46.42, 56.61, 66.81, 65.09, 63.38, 63.84,
    64.30, 61.88, 59.45, 55.71, 51.96, 54.70, 57.44, 58.88, 60.31,
], np.float32)
_D65_WL = np.linspace(360.0, 830.0, len(_D65)).astype(np.float32)


def _ybar_np(wl: np.ndarray) -> np.ndarray:
    """Numpy twin of cie_xyz's ybar fit — import-time normalization must not
    touch the XLA backend (jax.distributed.initialize comes first in
    multi-host programs)."""

    def g(x, a, mu, s1, s2):
        s = np.where(x < mu, s1, s2)
        return a * np.exp(-0.5 * ((x - mu) / s) ** 2)

    return g(wl, 0.821, 568.8, 46.9, 40.5) + g(wl, 0.286, 530.9, 16.3, 31.1)


# normalize so a unit-RGB (1,1,1) emitter keeps its photometric scale
_D65_NORM = float(np.trapezoid(_D65 * _ybar_np(_D65_WL), _D65_WL))
_Y_INT = float(np.trapezoid(_ybar_np(_D65_WL), _D65_WL))


def d65(wl):
    """D65 SPD normalized so that integral(D65 * ybar) == integral(ybar):
    an rgb=(1,1,1) emitter has the same luminance in every variant."""
    v = jnp.interp(wl, _D65_WL, _D65)
    return v * (_Y_INT / _D65_NORM)


# --------------------------------------------------------------------------
# Smits (1999) RGB -> smooth reflectance basis (10 bins, 380-720 nm)
# --------------------------------------------------------------------------

_SMITS_WL = np.linspace(380.0, 720.0, 10).astype(np.float32)
_SMITS = {
    "white":   [1.0000, 1.0000, 0.9999, 0.9993, 0.9992, 0.9998, 1.0000,
                1.0000, 1.0000, 1.0000],
    "cyan":    [0.9710, 0.9426, 1.0007, 1.0007, 1.0007, 1.0007, 0.1564,
                0.0000, 0.0000, 0.0000],
    "magenta": [1.0000, 1.0000, 0.9685, 0.2229, 0.0000, 0.0458, 0.8369,
                1.0000, 1.0000, 0.9959],
    "yellow":  [0.0001, 0.0000, 0.1088, 0.6651, 1.0000, 1.0000, 0.9996,
                0.9586, 0.9685, 0.9840],
    "red":     [0.1012, 0.0515, 0.0000, 0.0000, 0.0000, 0.0000, 0.8325,
                1.0149, 1.0149, 1.0149],
    "green":   [0.0000, 0.0000, 0.0273, 0.7937, 1.0000, 0.9418, 0.1719,
                0.0000, 0.0000, 0.0025],
    "blue":    [1.0000, 1.0000, 0.8916, 0.3323, 0.0000, 0.0000, 0.0003,
                0.0369, 0.0483, 0.0496],
}
_SMITS_ARR = {k: np.array(v, np.float32) for k, v in _SMITS.items()}


def _smits_eval(name, wl):
    return jnp.interp(wl, _SMITS_WL, _SMITS_ARR[name],
                      left=float(_SMITS_ARR[name][0]),
                      right=float(_SMITS_ARR[name][-1]))


def srgb_uplift(rgb, wl):
    """Smits' RGB->reflectance uplift evaluated at ``wl``.

    rgb: (..., 3); wl: (..., K) -> (..., K) reflectance values."""
    r = rgb[..., 0:1]
    g = rgb[..., 1:2]
    b = rgb[..., 2:3]
    w = _smits_eval("white", wl)
    c = _smits_eval("cyan", wl)
    m = _smits_eval("magenta", wl)
    y = _smits_eval("yellow", wl)
    re = _smits_eval("red", wl)
    gr = _smits_eval("green", wl)
    bl = _smits_eval("blue", wl)
    # Smits' decomposition: white part (channel minimum), secondary color
    # (middle - min), primary color (max - middle), per dominant ordering
    r_min = (r <= g) & (r <= b)
    g_min = ~r_min & (g <= b)

    case_r = r * w + jnp.where(g <= b, (g - r) * c + (b - g) * bl,
                               (b - r) * c + (g - b) * gr)
    case_g = g * w + jnp.where(r <= b, (r - g) * m + (b - r) * bl,
                               (b - g) * m + (r - b) * re)
    case_b = b * w + jnp.where(r <= g, (r - b) * y + (g - r) * gr,
                               (g - b) * y + (r - g) * re)
    out = jnp.where(r_min, case_r, jnp.where(g_min, case_g, case_b))
    return jnp.clip(out, 0.0, None)


# --------------------------------------------------------------------------
# Wavelength sampling (mi.sample_rgb_spectrum / pdf_rgb_spectrum)
# --------------------------------------------------------------------------

def sample_rgb_spectrum(u):
    """Importance-sample the visible range with Mitsuba's cosh^-2 proposal
    (good match to the luminous-efficiency bulk)."""
    wl = 538.0 - 138.888889 * jnp.arctanh(0.85691062 - 1.82750197 * u)
    return jnp.clip(wl, WL_MIN, WL_MAX)


def pdf_rgb_spectrum(wl):
    c = jnp.cosh(0.0072 * (wl - 538.0))
    pdf = 0.003939804 / (c * c)
    return jnp.where((wl >= WL_MIN) & (wl <= WL_MAX), pdf, 0.0)


def sample_shifted(u):
    """Hero-wavelength set: one uniform draw -> N_WL stratified wavelengths
    (mi.sample_shifted; nloscapturemeter.py:169-175)."""
    shifts = jnp.arange(N_WL, dtype=jnp.float32) / N_WL
    uu = jnp.mod(u[..., None] + shifts, 1.0)
    wl = sample_rgb_spectrum(uu)
    return wl, pdf_rgb_spectrum(wl)


# --------------------------------------------------------------------------
# Spectral sample -> sRGB (mi.spectrum_to_srgb at splat time)
# --------------------------------------------------------------------------

_XYZ_TO_SRGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311],
], np.float32)


def spectrum_to_srgb(values, wl, pdf):
    """Monte-Carlo estimate of the sRGB tristimulus of a spectral radiance
    sample set: values/pdf averaged over the hero wavelengths against the
    CIE matching functions.

    values, wl, pdf: (..., N_WL) -> (..., 3) linear sRGB."""
    w = jnp.where(pdf > 0.0, 1.0 / (jnp.maximum(pdf, 1e-12) * N_WL), 0.0)
    xyz = jnp.sum(cie_xyz(wl) * (values * w)[..., None], axis=-2) / _Y_INT
    return jnp.matmul(xyz, _XYZ_TO_SRGB.T, precision=jax.lax.Precision.HIGHEST)


# --------------------------------------------------------------------------
# Shared per-wavefront spectral context (used by every integrator that
# supports the spectral variant: path, nlos_path, volpath)
# --------------------------------------------------------------------------

# ascending-wavelength anchors of the B/G/R channels used to interpolate
# per-RGB-channel data (conductor IORs) to arbitrary wavelengths
_ANCHORS = np.array([465.0, 549.0, 611.0], np.float32)


def _interp_rgb(vals3, wl):
    """Interpolate per-RGB-channel values to wavelengths: (n, 3) RGB-ordered
    + (n, K) wl -> (n, K)."""
    v = vals3[:, ::-1]  # B, G, R = ascending wavelength
    t = jnp.clip(
        (wl - _ANCHORS[0]) / (_ANCHORS[2] - _ANCHORS[0]), 0.0, 1.0) * 2.0
    i0 = jnp.clip(t.astype(jnp.int32), 0, 1)
    frac = t - i0
    lo = jnp.take_along_axis(v, i0, axis=1)
    hi = jnp.take_along_axis(v, jnp.minimum(i0 + 1, 2), axis=1)
    return lo * (1 - frac) + hi * frac


class SpectralCtx:
    """Hero-wavelength set for one wavefront: N_WL wavelengths per lane.

    Centralizes the three conversions every spectral integrator needs:
    BSDF-table uplift, emission uplift (x D65 illuminant), and the
    splat-time spectrum->sRGB conversion (transient_image_block.py:91)."""

    __slots__ = ("wl", "wl_pdf")

    def __init__(self, wl, wl_pdf):
        self.wl = wl
        self.wl_pdf = wl_pdf

    @staticmethod
    def make(key, n):
        import jax

        u_wl = jax.random.uniform(
            jax.random.fold_in(key, jnp.uint32(0x57AC)), (n,))
        wl, wl_pdf = sample_shifted(u_wl)
        return SpectralCtx(wl, wl_pdf)

    def _rgb3(self, x):
        return jnp.repeat(x, 3, axis=-1) if x.shape[-1] == 1 else x

    def uplift(self, rgb):
        """Reflectance-like (n, C) RGB -> (n, N_WL)."""
        return srgb_uplift(self._rgb3(rgb), self.wl)

    def emission(self, rgb):
        """Emitted-radiance (n, C) RGB -> (n, N_WL) with D65 shape."""
        return srgb_uplift(self._rgb3(rgb), self.wl) * d65(self.wl)

    def uplift_lb(self, lb):
        """Lift a LaneBSDF's color data to the lane wavelengths."""
        return lb._replace(
            reflectance=self.uplift(lb.reflectance),
            eta_re=_interp_rgb(self._rgb3(lb.eta_re), self.wl),
            eta_im=_interp_rgb(self._rgb3(lb.eta_im), self.wl),
        )

    def to_film(self, vals):
        """(n, N_WL) radiance -> (n, 3) linear sRGB for splatting."""
        return spectrum_to_srgb(vals, self.wl, self.wl_pdf)

    def to_film_stokes(self, vals):
        """(n, 4*N_WL) packed Stokes -> (n, 12): each Stokes component is
        an independent spectral radiance-like quantity, converted to sRGB
        per row (the spectral_polarized splat packing)."""
        n = vals.shape[0]
        x = vals.reshape(n, 4, -1)
        rgb = spectrum_to_srgb(x, self.wl[:, None, :], self.wl_pdf[:, None, :])
        return rgb.reshape(n, 12)
