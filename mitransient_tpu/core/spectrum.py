"""Variant system + Spectrum representation.

Replaces Mitsuba's compiled variant matrix (``mono``/``rgb`` x ``polarized``)
that the reference gates on at import
(/root/reference/mitransient/__init__.py:3-25) and branches on per-splat
(/root/reference/mitransient/render/transient_image_block.py:90-99).

Design: a *value*, not a compile flag.  A :class:`Variant` travels
with the compiled scene; spectra are plain jnp arrays whose trailing shape
encodes the mode:

* unpolarized: ``(..., C)`` with ``C`` = 1 (mono) or 3 (rgb)
* polarized:   ``(..., 4, 4, C)`` Mueller matrix per channel; radiance that
  reaches the film is the first column (Stokes vector), matching the
  reference's channel packing (transient_image_block.py:90-99).

Because a shape is static under ``jit``, one code path specializes per
variant with zero runtime branching.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class Variant(NamedTuple):
    color_channels: int = 3  # 1 = mono, 3 = rgb (film/table channels)
    polarized: bool = False
    spectral: bool = False  # hero-wavelength sampling; film stays 3-channel

    @property
    def name(self) -> str:
        base = ("spectral" if self.spectral
                else ("mono" if self.color_channels == 1 else "rgb"))
        return base + ("_polarized" if self.polarized else "")


_KNOWN = {
    "mono": Variant(1, False),
    "rgb": Variant(3, False),
    "mono_polarized": Variant(1, True),
    "rgb_polarized": Variant(3, True),
    # spectral: scene tables stay RGB; lanes carry N_WL hero wavelengths
    # uplifted per bounce (core/spectra.py); splats convert to sRGB like
    # the reference's spectrum_to_srgb packing
    "spectral": Variant(3, False, True),
    # spectral_polarized: Mueller chains evaluated per hero wavelength
    # (per-wavelength Fresnel), Stokes splats converted to sRGB per row
    "spectral_polarized": Variant(3, True, True),
}

# Module-global default for API parity with mi.set_variant; compiled scenes
# snapshot it so jitted code never reads the global.
_current = _KNOWN["rgb"]


def set_variant(name) -> None:
    global _current
    if isinstance(name, Variant):  # restore pattern: set_variant(variant())
        _current = name
        return
    # Accept mitsuba-style names like "llvm_ad_rgb" by taking the suffix.
    key = name
    for k in _KNOWN:
        if name == k or name.endswith("_" + k):
            key = k
    if key not in _KNOWN:
        raise ValueError(f"unknown variant {name!r}; choose from {list(_KNOWN)}")
    _current = _KNOWN[key]


def variant() -> Variant:
    return _current


def is_polarized() -> bool:
    return _current.polarized


def is_monochromatic() -> bool:
    return _current.color_channels == 1


def is_rgb() -> bool:
    return _current.color_channels == 3 and not _current.spectral


def is_spectral() -> bool:
    return _current.spectral


# --------------------------------------------------------------------------
# Spectrum ops (shape-polymorphic over the variant encoding above)
# --------------------------------------------------------------------------

def is_polarized_spec(spec: jnp.ndarray) -> bool:
    return spec.ndim >= 3 and spec.shape[-3] == 4 and spec.shape[-2] == 4


def spec_zeros(v: Variant, batch_shape=()) -> jnp.ndarray:
    if v.polarized:
        return jnp.zeros((*batch_shape, 4, 4, v.color_channels), jnp.float32)
    return jnp.zeros((*batch_shape, v.color_channels), jnp.float32)


def spec_identity(v: Variant, batch_shape=()) -> jnp.ndarray:
    """Multiplicative identity: ones for unpolarized, identity Mueller matrix
    for polarized (the reference's beta init before the basis rotation,
    mitransient/utils.py:9-21)."""
    if v.polarized:
        eye = jnp.eye(4, dtype=jnp.float32)[..., None]
        return jnp.broadcast_to(
            eye, (*batch_shape, 4, 4, v.color_channels)
        ).astype(jnp.float32)
    return jnp.ones((*batch_shape, v.color_channels), jnp.float32)


def spec_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Spectrum x Spectrum.  For polarized spectra this is the Mueller matrix
    product ``a @ b`` (order matters: new throughput = beta @ M_bsdf in
    Mitsuba's convention where light flows right-to-left)."""
    ap, bp = is_polarized_spec(a), is_polarized_spec(b)
    if not ap and not bp:
        return a * b
    if ap and bp:
        from .mueller import mueller_product

        return mueller_product(a, b)
    # mixed: scalar-like spectrum scales the Mueller matrix
    if ap:
        return a * b[..., None, None, :]
    return b * a[..., None, None, :]


def spec_scale(spec: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """Multiply a spectrum by a per-lane scalar array ``s`` of shape (...)."""
    if is_polarized_spec(spec):
        return spec * s[..., None, None, None]
    return spec * s[..., None]


def unpolarized(spec: jnp.ndarray) -> jnp.ndarray:
    """Drop polarization info -> ``(..., C)`` intensity (Mueller [0,0]
    element), mirroring ``mi.unpolarized_spectrum``
    (mitransient/integrators/transientpath.py:245)."""
    if is_polarized_spec(spec):
        return spec[..., 0, 0, :]
    return spec


def to_stokes(spec: jnp.ndarray) -> jnp.ndarray:
    """First Mueller column = outgoing Stokes vector ``(..., 4, C)`` given
    unpolarized unit input light (transient_image_block.py:90-99)."""
    if is_polarized_spec(spec):
        return spec[..., :, 0, :]
    raise ValueError("to_stokes requires a polarized spectrum")


def luminance(spec: jnp.ndarray) -> jnp.ndarray:
    """Scalar luminance used for RR throughput decisions — the reference uses
    ``dr.max(unpolarized_spectrum(beta))`` (transientpath.py:245)."""
    return jnp.max(unpolarized(spec), axis=-1)
