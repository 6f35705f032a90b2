"""Polarized (Mueller-matrix) BSDF evaluation.

JAX equivalent of the ``si.to_world_mueller``-wrapped polarized BSDF
evaluations in the reference (/root/reference/mitransient/integrators/
transientpath.py:210,227) and the Mueller Fresnel of the gold-GGX scenes
(/root/reference/examples/polarization).

Factorization: every scalar BSDF value f (already containing the unpolarized
Fresnel average) is lifted to a Mueller matrix ``M = f * P`` where ``P`` is
the *normalized polarization factor* with ``P[0,0] ~= 1``:

* conductor / rough conductor: ``P = M_fresnel / F_unpol`` built from the
  complex-IOR specular-reflection Mueller matrix in the s/p basis, rotated
  into the canonical Stokes bases of the world propagation directions
  (mueller.rotate_mueller_basis — the to_world_mueller step);
* diffuse: ideal depolarizer;
* dielectric reflection: real-IOR specular Mueller; transmission:
  depolarizer (approximation, noted);
* null: identity (polarization passes through unchanged).

Conventions: propagation directions of LIGHT.  At a vertex with camera-ray
direction ``d`` and light direction ``wo_world`` (pointing from the surface
toward the light / next vertex), light propagates in along ``-wo_world`` and
out along ``-d``; Stokes bases are the canonical ``stokes_basis`` of those
world vectors, which makes consecutive vertices' bases agree along shared
segments and composes as beta' = beta @ M (camera-first chain).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.math import cross, dot, normalize
from ..core.mueller import (
    rotate_mueller_product,
    rotate_stokes_basis,
    rotator_angles,
    specular_abcs,
    specular_reflection_mueller,
    specular_sandwich,
    specular_sandwich_col0,
    stokes_basis,
)
from ..scene.scene import (
    BSDF_CONDUCTOR,
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_NULL,
    BSDF_ROUGH_CONDUCTOR,
)
from .api import LaneBSDF
from .fresnel import fresnel_conductor


def _depolarizer_P(n, C):
    P = jnp.zeros((n, 4, 4, C), jnp.float32)
    return P.at[:, 0, 0, :].set(1.0)


def _identity_P(n, C):
    eye = jnp.eye(4, dtype=jnp.float32)[None, :, :, None]
    return jnp.broadcast_to(eye, (n, 4, 4, C))


def _sb_unit(w):
    """stokes_basis for an already-unit direction (skips the normalize)."""
    from ..core.frame import coordinate_system

    return coordinate_system(w)[0]


def _plane_rotators(p_in, p_out, need_in=True):
    """(ci2, si2, co2, so2) rotator angle pairs from the canonical Stokes
    bases into the s/p basis of the (p_in, p_out) incidence plane and back.

    Normalization-free: the s-axis is the raw cross product (any positive
    scale works for :func:`rotator_angles_unnorm`), with the canonical
    basis as the degenerate fallback.  The three per-bounce rotator-angle
    computations measured 17% of the polarized cbox render
    (scripts/r5_pol_ablate.py) before this rewrite."""
    from ..core.mueller import rotator_angles_unnorm

    sp = cross(p_in, p_out)
    sp_len2 = jnp.sum(sp * sp, axis=-1)
    degenerate = sp_len2 < 1e-12
    sb_in = _sb_unit(p_in)
    s_axis = jnp.where(degenerate[:, None], sb_in, sp)
    if need_in:
        ci2, si2 = rotator_angles_unnorm(p_in, sb_in, s_axis)
    else:
        ci2 = si2 = None
    co2, so2 = rotator_angles_unnorm(p_out, s_axis, _sb_unit(p_out))
    return ci2, si2, co2, so2


def polarization_factor(
    lb: LaneBSDF,
    p_in: jnp.ndarray,  # (N, 3) light propagation INTO the surface (world)
    p_out: jnp.ndarray,  # (N, 3) light propagation OUT (toward camera side)
    cos_theta_i: jnp.ndarray,  # (N,) incidence cosine for the Fresnel term
    transmitted: jnp.ndarray | None = None,  # (N,) bool — dielectric refract
) -> jnp.ndarray:
    """Normalized Mueller polarization factor P (N, 4, 4, C).

    Kinds statically absent from the scene (``lb.ks``) skip their Mueller
    construction at trace time (same scene-specialization as bsdf/api.py)."""
    n = p_in.shape[0]
    C = lb.reflectance.shape[-1]
    ks = lb.ks
    has_cond = ks.has(BSDF_CONDUCTOR) or ks.has(BSDF_ROUGH_CONDUCTOR)
    has_diel = ks.has(BSDF_DIELECTRIC)
    has_null = ks.has(BSDF_NULL)

    ci = jnp.clip(jnp.abs(cos_theta_i), 1e-4, 1.0)

    if has_cond or has_diel:
        # rotator angles from canonical bases into the s/p basis and back:
        # basis perpendicular to the plane of incidence (fused closed-form
        # sandwich instead of two unrolled 4x4 products — the polarized hot
        # path's dominant cost)
        ci2, si2, co2, so2 = _plane_rotators(p_in, p_out)
        ci2, si2 = ci2[:, None], si2[:, None]
        co2, so2 = co2[:, None], so2[:, None]

    if has_cond:
        # specular s/p components for complex IOR, normalized by F_unpol
        A, B, Cc, S = specular_abcs(ci[:, None] * jnp.ones((1, C)),
                                    lb.eta_re, lb.eta_im)
        inv_a = 1.0 / jnp.maximum(A, 1e-12)
        M_spec = specular_sandwich(jnp.ones_like(A), B * inv_a, Cc * inv_a,
                                   S * inv_a, ci2, si2, co2, so2)

    if has_diel:
        # dielectric: real-IOR reflection Mueller; transmission ~ depolarizer
        eta_d = lb.eta_ratio[:, None] * jnp.ones((1, C))
        A, B, Cc, S = specular_abcs(ci[:, None] * jnp.ones((1, C)),
                                    eta_d, jnp.zeros_like(eta_d))
        inv_a = 1.0 / jnp.maximum(A, 1e-12)
        M_diel = specular_sandwich(jnp.ones_like(A), B * inv_a, Cc * inv_a,
                                   S * inv_a, ci2, si2, co2, so2)
        if transmitted is not None:
            M_diel = jnp.where(
                transmitted[:, None, None, None], _depolarizer_P(n, C),
                M_diel
            )

    P = _depolarizer_P(n, C)  # diffuse / rough-plastic default
    k = lb.kind[:, None, None, None]
    if has_cond:
        P = jnp.where(
            (k == BSDF_CONDUCTOR) | (k == BSDF_ROUGH_CONDUCTOR), M_spec, P)
    if has_diel:
        P = jnp.where(k == BSDF_DIELECTRIC, M_diel, P)
    if has_null:
        P = jnp.where(k == BSDF_NULL, _identity_P(n, C), P)
    return P


def polarization_factor_col0(
    lb: LaneBSDF,
    p_in: jnp.ndarray,
    p_out: jnp.ndarray,
    cos_theta_i: jnp.ndarray,
) -> jnp.ndarray:
    """Column 0 of :func:`polarization_factor` (N, 4, C) — all an
    UNPOLARIZED source needs (NEE to an emitter: contribution Stokes =
    beta @ (P f)[:, 0] * E), at ~1/8 the cost of building the full P.

    col0 of R_out @ F @ R_in is [A, co2 B, -so2 B, 0] (R_in drops out
    against the unpolarized column e0)."""
    n = p_in.shape[0]
    C = lb.reflectance.shape[-1]
    ks = lb.ks
    has_cond = ks.has(BSDF_CONDUCTOR) or ks.has(BSDF_ROUGH_CONDUCTOR)
    has_null = ks.has(BSDF_NULL)

    # diffuse / rough-plastic / dielectric-NEE default: depolarizer col0 = e0
    e0 = jnp.zeros((n, 4, C), jnp.float32).at[:, 0, :].set(1.0)
    P0 = e0
    if has_cond:
        ci = jnp.clip(jnp.abs(cos_theta_i), 1e-4, 1.0)
        _ci2, _si2, co2, so2 = _plane_rotators(p_in, p_out, need_in=False)
        A, B, _Cc, _S = specular_abcs(ci[:, None] * jnp.ones((1, C)),
                                      lb.eta_re, lb.eta_im)
        Bn = B / jnp.maximum(A, 1e-12)
        col = specular_sandwich_col0(jnp.ones_like(Bn), Bn,
                                     co2[:, None], so2[:, None])
        k = lb.kind[:, None, None]
        P0 = jnp.where(
            (k == BSDF_CONDUCTOR) | (k == BSDF_ROUGH_CONDUCTOR), col, P0)
    if has_null:
        P0 = jnp.where(lb.kind[:, None, None] == BSDF_NULL, e0, P0)
    return P0


def polarization_factor_soa(
    lb: LaneBSDF,
    p_in: jnp.ndarray,
    p_out: jnp.ndarray,
    cos_theta_i: jnp.ndarray,
    transmitted: jnp.ndarray | None = None,
) -> tuple:
    """SoA form of :func:`polarization_factor`: tuple of 16 (N, C) arrays
    (see core/mueller.py msoa_* — avoids carrying rank-4 tensors through
    the wavefront loop).  Entries are numerically identical to the dense version."""
    from ..core.mueller import specular_sandwich_soa

    n = p_in.shape[0]
    C = lb.reflectance.shape[-1]
    ks = lb.ks
    has_cond = ks.has(BSDF_CONDUCTOR) or ks.has(BSDF_ROUGH_CONDUCTOR)
    has_diel = ks.has(BSDF_DIELECTRIC)
    has_null = ks.has(BSDF_NULL)

    ci = jnp.clip(jnp.abs(cos_theta_i), 1e-4, 1.0)

    if has_cond or has_diel:
        ci2, si2, co2, so2 = _plane_rotators(p_in, p_out)
        ci2, si2 = ci2[:, None], si2[:, None]
        co2, so2 = co2[:, None], so2[:, None]

    zz = jnp.zeros((n, C), jnp.float32)
    oo = jnp.ones((n, C), jnp.float32)
    # diffuse / rough-plastic default: ideal depolarizer (entry 0 only)
    P = [oo] + [zz] * 15

    if has_cond:
        A, B, Cc, S = specular_abcs(ci[:, None] * jnp.ones((1, C)),
                                    lb.eta_re, lb.eta_im)
        inv_a = 1.0 / jnp.maximum(A, 1e-12)
        M_spec = specular_sandwich_soa(
            jnp.ones_like(A), B * inv_a, Cc * inv_a, S * inv_a,
            ci2, si2, co2, so2)
        m = ((lb.kind == BSDF_CONDUCTOR)
             | (lb.kind == BSDF_ROUGH_CONDUCTOR))[:, None]
        P = [jnp.where(m, e, p) for e, p in zip(M_spec, P)]

    if has_diel:
        eta_d = lb.eta_ratio[:, None] * jnp.ones((1, C))
        A, B, Cc, S = specular_abcs(ci[:, None] * jnp.ones((1, C)),
                                    eta_d, jnp.zeros_like(eta_d))
        inv_a = 1.0 / jnp.maximum(A, 1e-12)
        M_diel = list(specular_sandwich_soa(
            jnp.ones_like(A), B * inv_a, Cc * inv_a, S * inv_a,
            ci2, si2, co2, so2))
        if transmitted is not None:
            tm = transmitted[:, None]
            depol = [oo] + [zz] * 15
            M_diel = [jnp.where(tm, d, e)
                      for d, e in zip(depol, M_diel)]
        m = (lb.kind == BSDF_DIELECTRIC)[:, None]
        P = [jnp.where(m, e, p) for e, p in zip(M_diel, P)]

    if has_null:
        eye = [oo if i == j else zz for i in range(4) for j in range(4)]
        m = (lb.kind == BSDF_NULL)[:, None]
        P = [jnp.where(m, e, p) for e, p in zip(eye, P)]
    return tuple(P)


def polarization_factor_col0_soa(
    lb: LaneBSDF,
    p_in: jnp.ndarray,
    p_out: jnp.ndarray,
    cos_theta_i: jnp.ndarray,
) -> tuple:
    """SoA column 0 of the polarization factor: tuple of 4 spectral arrays
    ((N, C), or (N,) for squeezed mono tables — integrators/path_regen
    "Mono squeeze"; entries identical to
    :func:`polarization_factor_col0`)."""
    ks = lb.ks
    has_cond = ks.has(BSDF_CONDUCTOR) or ks.has(BSDF_ROUGH_CONDUCTOR)

    spec1 = lb.reflectance.ndim == 1

    def sl(x):
        return x if spec1 else x[:, None]

    zz = jnp.zeros_like(lb.reflectance)
    oo = jnp.ones_like(lb.reflectance)
    P0 = [oo, zz, zz, zz]  # depolarizer / null col0 = e0
    if has_cond:
        ci = jnp.clip(jnp.abs(cos_theta_i), 1e-4, 1.0)
        _ci2, _si2, co2, so2 = _plane_rotators(p_in, p_out, need_in=False)
        A, B, _Cc, _S = specular_abcs(sl(ci) * oo, lb.eta_re, lb.eta_im)
        Bn = B / jnp.maximum(A, 1e-12)
        col = (jnp.ones_like(Bn), sl(co2) * Bn, -sl(so2) * Bn, zz)
        m = sl((lb.kind == BSDF_CONDUCTOR)
               | (lb.kind == BSDF_ROUGH_CONDUCTOR))
        P0 = [jnp.where(m, e, p) for e, p in zip(col, P0)]
    return tuple(P0)


def specular_params_soa(
    lb: LaneBSDF,
    p_in: jnp.ndarray,
    p_out: jnp.ndarray,
    cos_theta_i: jnp.ndarray,
    transmitted: jnp.ndarray | None = None,
):
    """Per-lane STRUCTURED polarization parameters — the inputs of the
    pending-rotator bounce update (core/mueller.py msoa_apply_*), replacing
    :func:`polarization_factor_soa`'s matrix construction:

    Returns (is_spec (N,) bool, A, B, Cc, S spectral ((N, C), or (N,) for
    squeezed mono tables) normalized s/p Fresnel entries, ci2, si2, co2,
    so2 (N,) rotator angle pairs).  Lanes that are NOT specular (diffuse /
    rough-plastic / null / transmitted dielectric) get identity
    parameters; the caller handles the depolarizer (diffuse) and identity
    (null) classes from lb.kind directly."""
    n = p_in.shape[0]
    ks = lb.ks
    has_cond = ks.has(BSDF_CONDUCTOR) or ks.has(BSDF_ROUGH_CONDUCTOR)
    has_diel = ks.has(BSDF_DIELECTRIC)

    spec1 = lb.reflectance.ndim == 1

    def sl(x):
        return x if spec1 else x[:, None]

    oo = jnp.ones_like(lb.reflectance)
    zz = jnp.zeros_like(lb.reflectance)
    on = jnp.ones((n,), jnp.float32)
    zn = jnp.zeros((n,), jnp.float32)
    if not (has_cond or has_diel):
        return (jnp.zeros((n,), bool), oo, zz, oo, zz, on, zn, on, zn)

    ci = jnp.clip(jnp.abs(cos_theta_i), 1e-4, 1.0)
    ci2, si2, co2, so2 = _plane_rotators(p_in, p_out)

    is_spec = jnp.zeros((n,), bool)
    A, B, Cc, S = oo, zz, oo, zz
    if has_cond:
        m = ((lb.kind == BSDF_CONDUCTOR)
             | (lb.kind == BSDF_ROUGH_CONDUCTOR))
        Ac, Bc, Cx, Sx = specular_abcs(sl(ci) * oo, lb.eta_re, lb.eta_im)
        inv_a = 1.0 / jnp.maximum(Ac, 1e-12)
        mm = sl(m)
        A = jnp.where(mm, jnp.ones_like(Ac), A)
        B = jnp.where(mm, Bc * inv_a, B)
        Cc = jnp.where(mm, Cx * inv_a, Cc)
        S = jnp.where(mm, Sx * inv_a, S)
        is_spec = is_spec | m
    if has_diel:
        m = lb.kind == BSDF_DIELECTRIC
        if transmitted is not None:
            m = m & ~transmitted  # transmission ~ depolarizer (see module doc)
        eta_d = sl(lb.eta_ratio) * oo
        Ad, Bd, Cx, Sx = specular_abcs(sl(ci) * oo,
                                       eta_d, jnp.zeros_like(eta_d))
        inv_a = 1.0 / jnp.maximum(Ad, 1e-12)
        mm = sl(m)
        A = jnp.where(mm, jnp.ones_like(Ad), A)
        B = jnp.where(mm, Bd * inv_a, B)
        Cc = jnp.where(mm, Cx * inv_a, Cc)
        S = jnp.where(mm, Sx * inv_a, S)
        is_spec = is_spec | m
    return is_spec, A, B, Cc, S, ci2, si2, co2, so2


def sensor_alignment_angles(ray_d: jnp.ndarray, vertical: jnp.ndarray):
    """(cos 2t, sin 2t) of the beta_init sensor rotator (reference
    utils.py:9-21) — for the pending-rotator carry, where beta starts as
    the identity and this rotator rides in the pending slot."""
    w = -ray_d
    current = stokes_basis(w)
    target = normalize(cross(ray_d, jnp.broadcast_to(vertical, ray_d.shape)))
    return rotator_angles(w, current, target)


def sensor_alignment_soa(ray_d: jnp.ndarray, vertical: jnp.ndarray,
                         C: int) -> tuple:
    """SoA beta_init: the sensor Stokes-frame alignment rotator as a tuple
    of 16 (N, C) arrays (reference utils.py:9-21)."""
    from ..core.mueller import rotator_angles as _ra, rotator_soa

    w = -ray_d
    current = stokes_basis(w)
    target = normalize(cross(ray_d, jnp.broadcast_to(vertical, ray_d.shape)))
    c2, s2 = _ra(w, current, target)
    n = ray_d.shape[0]
    return tuple(
        jnp.broadcast_to(e[:, None], (n, C)).astype(jnp.float32)
        for e in rotator_soa(c2, s2))


def sensor_alignment_mueller(ray_d: jnp.ndarray,
                             vertical: jnp.ndarray) -> jnp.ndarray:
    """beta_init (reference utils.py:9-21): rotate the Stokes basis of the
    light arriving at the sensor (propagation -ray.d) from the canonical
    basis to the camera's horizontal axis (cross(d, vertical))."""
    w = -ray_d
    current = stokes_basis(w)
    target = normalize(cross(ray_d, jnp.broadcast_to(vertical, ray_d.shape)))
    return rotate_stokes_basis(w, current, target)  # (N, 4, 4)
