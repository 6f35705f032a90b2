"""Phasor-field (frequency-domain) film.

JAX equivalent of the reference's ``PhasorHDRFilm`` +
``PhasorImageBlock`` (/root/reference/mitransient/films/phasor_hdr_film.py,
render/phasor_image_block.py): instead of binning by time, every path
contribution accumulates ``spec * exp(-i 2 pi f * opl)`` for a band of
frequencies — an on-the-fly sparse DFT of the transient signal.

Frequency selection mirrors phasor_hdr_film.py:126-139: a Morlet-style
+-3 sigma band around ``wl_mean`` out of ``fftfreq(temporal_bins,
bin_width_opl)``, clipped to [0, nt/2].

Design: with the spp-major lane layout the pixel is the lane
index, so the accumulation is a *dense* spp-axis reduction per frequency —
no scatters, no Pallas needed; XLA fuses the trig into the reduce.
Monochromatic only (reference phasor_hdr_film.py:118-123); not
differentiable (create_block/gather unimplemented in the reference too).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..scene.schema import FilmConfig


class PhasorFilmState(NamedTuple):
    steady: jnp.ndarray  # (HW, C)
    steady_weight: jnp.ndarray  # (HW,)
    phasor: jnp.ndarray  # (F, 2, HW) accumulated re/im


def phasor_frequencies(cfg: FilmConfig) -> np.ndarray:
    """The tracked frequency band (phasor_hdr_film.py:126-136)."""
    nt = cfg.temporal_bins
    bw = cfg.bin_width_opl
    mean_idx = (nt * bw) / cfg.wl_mean
    sigma_idx = (nt * bw) / (cfg.wl_sigma * 6.0)
    fmin = max(0, int(np.floor(mean_idx - 3 * sigma_idx)))
    fmax = min(nt // 2, int(np.ceil(mean_idx + 3 * sigma_idx)))
    return np.fft.fftfreq(nt, d=bw)[fmin : fmax + 1].astype(np.float32)


def phasor_film_init(cfg: FilmConfig, channels: int) -> PhasorFilmState:
    if channels != 1:
        raise ValueError(
            "phasor_hdr_film supports only monochromatic rendering "
            "(phasor_hdr_film.py:118-123); set_variant('mono')")
    hw = cfg.width * cfg.height
    F = phasor_frequencies(cfg).shape[0]
    return PhasorFilmState(
        steady=jnp.zeros((hw, channels), jnp.float32),
        steady_weight=jnp.zeros((hw,), jnp.float32),
        phasor=jnp.zeros((F, 2, hw), jnp.float32),
    )


def splat_phasor_pair(
    state: PhasorFilmState,
    cfg: FilmConfig,
    spp: int,
    dist_a: jnp.ndarray,
    val_a: jnp.ndarray,  # (N, 1) scaled
    dist_b: jnp.ndarray | None,
    val_b: jnp.ndarray | None,
    active: jnp.ndarray,
) -> PhasorFilmState:
    """Accumulate exp(-i 2 pi f opl) phasors for one bounce's splat events
    (phasor_image_block.py:42-67: opl = distance - start_opl, no binning)."""
    hw = state.steady.shape[0]
    freqs = jnp.asarray(phasor_frequencies(cfg))  # (F,)
    ph = state.phasor

    def acc(ph, dist, val):
        opl = dist - cfg.start_opl
        v = jnp.where(active & jnp.isfinite(opl), val[:, 0], 0.0)
        v2 = v.reshape(spp, hw)
        opl2 = jnp.where(jnp.isfinite(opl), opl, 0.0).reshape(spp, hw)
        # (F, spp, HW) phases reduced over spp -> (F, HW); F is small
        phase = -2.0 * jnp.pi * freqs[:, None, None] * opl2[None, :, :]
        re = jnp.sum(jnp.cos(phase) * v2[None, :, :], axis=1)
        im = jnp.sum(jnp.sin(phase) * v2[None, :, :], axis=1)
        return ph + jnp.stack([re, im], axis=1)

    ph = acc(ph, dist_a, val_a)
    if dist_b is not None:
        ph = acc(ph, dist_b, val_b)
    return state._replace(phasor=ph)


def develop_phasor(state: PhasorFilmState, cfg: FilmConfig):
    """Returns (steady (H, W, 1), phasors (H, W, F, 2))
    (phasor_hdr_film.py:208-238)."""
    h, w = cfg.height, cfg.width
    wgt = jnp.where(state.steady_weight == 0.0, 1.0, state.steady_weight)
    steady = (state.steady / wgt[:, None]).reshape(h, w, -1)
    F = state.phasor.shape[0]
    phasors = jnp.transpose(state.phasor, (2, 0, 1)).reshape(h, w, F, 2)
    return steady, phasors
