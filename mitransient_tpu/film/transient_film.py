"""Transient film: time-binned radiance accumulation.

JAX equivalent of the reference's ``TransientHDRFilm`` +
``TransientImageBlock`` pair (/root/reference/mitransient/films/
transient_hdr_film.py, render/transient_image_block.py).

Design notes:
* Because the spatial reconstruction filter is a box (the only filter the
  reference's transient block supports, transient_image_block.py:150-151),
  the *pixel* of every lane is static — lanes are laid out spp-major
  (lane = s*HW + p) so a splat is a per-pixel histogram over time only.
* The transient buffer is ``(C, T + 1, HW)``, filled by XLA's scatter-add.
  Bin T is the overflow slot for out-of-range samples (branchless routing
  instead of predication).  ``develop`` slices and transposes back to
  ``(H, W, T, C)``.
* OPL -> bin mapping mirrors transient_hdr_film.py:263-265:
  ``bin = floor((distance - start_opl) / bin_width_opl)``.
* Values are pre-scaled by the per-sample weight (ray_weight / total_spp)
  before splatting, like add_transient_f (common.py:411-422).
* The steady image accumulates the per-lane total L once per pass
  (common.py:180-206) as a *dense* spp-axis reduction — no scatter at all.
* ``temporal_filter='gaussian'`` splats into a +-3 sigma window of bins with
  normalized Gaussian weights (the transient analogue of the reference's
  gaussian rfilter option, common.py:25-30).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp

from ..scene.schema import FilmConfig


class TransientFilmState(NamedTuple):
    steady: jnp.ndarray  # (HW, C) accumulated radiance * filter weight
    steady_weight: jnp.ndarray  # (HW,) accumulated filter weight
    transient: jnp.ndarray  # (C, T + 1, HW); bin T = overflow (dropped)
    # sample-validation counters (transient_image_block.py:106-125, made
    # jit-safe: dense counts instead of a data-dependent host branch)
    n_negative: jnp.ndarray = None  # () f32 — splats with a value < -1e-5
    n_invalid: jnp.ndarray = None  # () f32 — splats with a non-finite value


def t_pad_of(cfg: FilmConfig) -> int:
    """Time axis length of the transient buffer: T bins + the overflow bin."""
    return cfg.temporal_bins + 1


def film_init(cfg: FilmConfig, channels: int,
              scan_pixels: int | None = None) -> TransientFilmState:
    hw = scan_pixels if scan_pixels is not None else cfg.width * cfg.height
    return TransientFilmState(
        steady=jnp.zeros((hw, channels), jnp.float32),
        steady_weight=jnp.zeros((hw,), jnp.float32),
        transient=jnp.zeros((channels, t_pad_of(cfg), hw), jnp.float32),
        n_negative=jnp.zeros((), jnp.float32),
        n_invalid=jnp.zeros((), jnp.float32),
    )


def time_bin(cfg: FilmConfig, distance: jnp.ndarray):
    """OPL -> (bin index, in-range mask); out-of-range -> overflow bin T."""
    pos = (distance - cfg.start_opl) / cfg.bin_width_opl
    b = jnp.floor(pos).astype(jnp.int32)
    ok = (pos >= 0.0) & (pos < cfg.temporal_bins)
    return jnp.where(ok, b, cfg.temporal_bins), ok


def splat_transient_pair(
    state: TransientFilmState,
    cfg: FilmConfig,
    spp: int,
    dist_a: jnp.ndarray,  # (N,) OPL of event set A (emitter hits)
    val_a: jnp.ndarray,  # (N, C) scaled values
    dist_b: jnp.ndarray | None,  # (N,) OPL of event set B (NEE) or None
    val_b: jnp.ndarray | None,
    active: jnp.ndarray,  # (N,) bool
    temporal_filter: str = "",
    gaussian_stddev: float = 2.0,
) -> TransientFilmState:
    """Accumulate one bounce's transient contributions (both splat events of
    transientpath.py:179-218 in one fused call).  Lanes are spp-major."""
    hw = state.steady.shape[0]
    if (cfg.warn_negative or cfg.warn_invalid) and state.n_negative is not None:
        state = _count_suspect(state, cfg, val_a, val_b, active)
    if temporal_filter == "gaussian":
        tr = _splat_gaussian(state.transient, cfg, spp, hw, dist_a, val_a,
                             active, gaussian_stddev)
        if dist_b is not None:
            tr = _splat_gaussian(tr, cfg, spp, hw, dist_b, val_b, active,
                                 gaussian_stddev)
        return state._replace(transient=tr)

    bins_a, _ = time_bin(cfg, dist_a)
    va = jnp.where(active[:, None], val_a, 0.0)
    if dist_b is not None:
        bins_b, _ = time_bin(cfg, dist_b)
        vb = jnp.where(active[:, None], val_b, 0.0)
    else:
        bins_b, vb = None, None

    tr = _scatter_layout(state.transient, spp, hw, bins_a, va)
    if bins_b is not None:
        tr = _scatter_layout(tr, spp, hw, bins_b, vb)
    return state._replace(transient=tr)


def splat_transient_flat(
    state: TransientFilmState,
    cfg: FilmConfig,
    spp: int,
    hw_total: int,
    dist: jnp.ndarray,  # (N',) OPL, N' = spp * hw_total, spp-major
    val: jnp.ndarray,  # (N', C) scaled values
    active: jnp.ndarray,  # (N',) bool
) -> TransientFilmState:
    """Splat into a film whose pixel axis is an arbitrary flat layout of
    ``hw_total`` slots (used by the exhaustive capture, where slot =
    laser_index * scan_pixels + scan_pixel — the 6-D film of
    transient_image_block.py:63-68 flattened).  Lanes are spp-major over
    the hw_total slots; the steady accumulator is NOT touched."""
    bins, _ = time_bin(cfg, dist)
    v = jnp.where(active[:, None], val, 0.0)
    if (cfg.warn_negative or cfg.warn_invalid) and state.n_negative is not None:
        state = _count_suspect(state, cfg, val, None, active)
    tr = _scatter_layout(state.transient, spp, hw_total, bins, v)
    return state._replace(transient=tr)


def _count_suspect(state: TransientFilmState, cfg: FilmConfig,
                   val_a, val_b, active) -> TransientFilmState:
    """Dense jit-safe version of the reference's warn_negative/warn_invalid
    splat validation (transient_image_block.py:106-125): count offending
    *samples* (any channel) among active lanes; the driver logs once."""
    neg = jnp.zeros((), jnp.float32)
    inv = jnp.zeros((), jnp.float32)
    for v in (val_a, val_b):
        if v is None:
            continue
        if cfg.warn_negative:
            bad = jnp.any(v < -1e-5, axis=-1) & active
            neg = neg + jnp.sum(bad.astype(jnp.float32))
        if cfg.warn_invalid:
            bad = jnp.any(~jnp.isfinite(v), axis=-1) & active
            inv = inv + jnp.sum(bad.astype(jnp.float32))
    return state._replace(n_negative=state.n_negative + neg,
                          n_invalid=state.n_invalid + inv)


def _scatter_layout(tr, spp, hw, bins, vals):
    n = bins.shape[0]
    pix = jnp.arange(n, dtype=jnp.int32) % hw
    c = vals.shape[-1]
    return tr.at[:, bins, pix].add(jnp.moveaxis(vals, -1, 0), mode="drop")


def _splat_gaussian(tr, cfg, spp, hw, distance, value, active, sigma):
    value = jnp.where(active[:, None], value, 0.0)
    radius = max(1, int(math.ceil(3.0 * sigma)))
    pos = (distance - cfg.start_opl) / cfg.bin_width_opl
    center = jnp.floor(pos)
    offs = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    b = center[:, None] + offs[None, :]
    w = jnp.exp(-0.5 * ((b + 0.5 - pos[:, None]) / sigma) ** 2)
    w = w / jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-20)
    ok = (b >= 0) & (b < cfg.temporal_bins)
    bidx = jnp.where(ok, b, cfg.temporal_bins).astype(jnp.int32)
    n, K = bidx.shape
    pix = (jnp.arange(n, dtype=jnp.int32) % hw)[:, None]
    pix2 = jnp.broadcast_to(pix, (n, K)).reshape(-1)
    vals = (value[:, None, :] * w[:, :, None]).reshape(n * K, -1)
    return tr.at[:, bidx.reshape(-1), pix2].add(
        jnp.moveaxis(vals, -1, 0), mode="drop"
    )


def splat_steady(
    state: TransientFilmState,
    spp: int,
    value: jnp.ndarray,  # (N, C) unscaled radiance, spp-major lanes
    weight: jnp.ndarray,  # (N,) filter weight (box: 1)
) -> TransientFilmState:
    """Dense spp-axis reduction (no scatter: pixel is the lane index)."""
    hw = state.steady.shape[0]
    c = value.shape[-1]
    v = (value * weight[:, None]).reshape(spp, hw, c).sum(axis=0)
    w = weight.reshape(spp, hw).sum(axis=0)
    return state._replace(
        steady=state.steady + v,
        steady_weight=state.steady_weight + w,
    )


def develop(state: TransientFilmState, cfg: FilmConfig,
            shape_hw: tuple[int, int] | None = None):
    """Returns (steady (H, W, C), transient (H, W, T, C)) — weight-normalized
    steady, transient already scaled at splat time
    (transient_hdr_film.py:210-248)."""
    h, w = shape_hw if shape_hw is not None else (cfg.height, cfg.width)
    hw = state.steady.shape[0]
    C = state.steady.shape[-1]
    wgt = jnp.where(state.steady_weight == 0.0, 1.0, state.steady_weight)
    steady = (state.steady / wgt[:, None]).reshape(h, w, C)
    T = cfg.temporal_bins
    tr = state.transient[:, :T, :hw]  # (C, T, HW)
    transient = jnp.transpose(tr, (2, 1, 0)).reshape(h, w, T, C)
    return steady, transient


# --------------------------------------------------------------------------
# Film-kind dispatch (transient histogram vs phasor DFT)
# --------------------------------------------------------------------------

def film_init_any(cfg: FilmConfig, channels: int,
                  scan_pixels: int | None = None):
    if cfg.kind == "phasor_hdr_film":
        from .phasor_film import phasor_film_init

        return phasor_film_init(cfg, channels)
    return film_init(cfg, channels, scan_pixels)


def splat_pair_any(state, cfg: FilmConfig, spp, dist_a, val_a, dist_b, val_b,
                   active, temporal_filter="", gaussian_stddev=2.0):
    if cfg.kind == "phasor_hdr_film":
        from .phasor_film import splat_phasor_pair

        return splat_phasor_pair(state, cfg, spp, dist_a, val_a, dist_b,
                                 val_b, active)
    return splat_transient_pair(state, cfg, spp, dist_a, val_a, dist_b,
                                val_b, active, temporal_filter,
                                gaussian_stddev)


def develop_any(state, cfg: FilmConfig, shape_hw=None):
    if cfg.kind == "phasor_hdr_film":
        from .phasor_film import develop_phasor

        return develop_phasor(state, cfg)
    return develop(state, cfg, shape_hw)


def splat_steady_gaussian(
    state: TransientFilmState,
    h: int,
    w: int,
    spp: int,
    value: jnp.ndarray,  # (N, C) per-lane radiance, spp-major lanes
    weight: jnp.ndarray,  # (N,) sample weights
    jitter: jnp.ndarray,  # (N, 2) subpixel position in [0,1)^2
    stddev: float = 0.5,
):
    """Steady-image accumulation under a truncated gaussian spatial
    reconstruction filter (Mitsuba's ``gaussian`` rfilter on the child
    hdrfilm: eval = exp(-x^2/2s^2) - exp(-r^2/2s^2), radius r = 4s).

    Scatter-free: for each of the (2r+1)^2 integer pixel offsets the whole
    wavefront's weighted contribution is a dense spp-reduction followed by a
    statically-shifted image add — the dense form of Mitsuba's
    ImageBlock border splatting."""
    import math as _m

    radius = max(1, int(_m.ceil(4.0 * stddev)))
    C = value.shape[-1]
    v = (value * weight[:, None]).reshape(spp, h, w, C)
    wg = weight.reshape(spp, h, w)
    jx = jitter[:, 0].reshape(spp, h, w)
    jy = jitter[:, 1].reshape(spp, h, w)
    cut = _m.exp(-(radius * radius) / (2.0 * stddev * stddev))

    acc = jnp.zeros((h, w, C), jnp.float32)
    wacc = jnp.zeros((h, w), jnp.float32)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            # distance from the sample position (px + jx) to the center of
            # target pixel (px + dx): (dx + 0.5) - jx
            ox = (dx + 0.5) - jx
            oy = (dy + 0.5) - jy
            fx = jnp.maximum(jnp.exp(-ox * ox / (2.0 * stddev * stddev))
                             - cut, 0.0)
            fy = jnp.maximum(jnp.exp(-oy * oy / (2.0 * stddev * stddev))
                             - cut, 0.0)
            f = fx * fy
            contrib = (v * f[..., None]).sum(axis=0)  # (h, w, C)
            wsum = (wg * f).sum(axis=0)
            # add into the target pixels shifted by (dy, dx)
            ys = slice(max(dy, 0), h + min(dy, 0))
            yd = slice(max(-dy, 0), h + min(-dy, 0))
            xs = slice(max(dx, 0), w + min(dx, 0))
            xd = slice(max(-dx, 0), w + min(-dx, 0))
            acc = acc.at[ys, xs].add(contrib[yd, xd])
            wacc = wacc.at[ys, xs].add(wsum[yd, xd])
    return state._replace(
        steady=state.steady + acc.reshape(h * w, C),
        steady_weight=state.steady_weight + wacc.reshape(h * w),
    )
