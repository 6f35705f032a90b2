"""Mueller / Stokes polarization algebra (SoA jnp).

JAX equivalent of the ``mi.mueller`` routines consumed by the
reference: ``stokes_basis`` / ``rotate_stokes_basis`` for the sensor-aligned
throughput init (/root/reference/mitransient/utils.py:9-21) and the implicit
``si.to_world_mueller`` frame rotations around every BSDF evaluation
(/root/reference/mitransient/integrators/transientpath.py:210,227).

Conventions follow Mitsuba 3: Stokes vectors are expressed w.r.t. a basis
vector perpendicular to the propagation direction ``w``; Mueller matrices act
on Stokes vectors from the left.  A polarized Spectrum here has shape
``(..., 4, 4, C)`` (see core/spectrum.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .math import cross, dot, normalize
from .frame import coordinate_system


def stokes_basis(w: jnp.ndarray) -> jnp.ndarray:
    """Canonical basis vector perpendicular to propagation direction ``w``."""
    s, _t = coordinate_system(normalize(w))
    return s


def _rotator(theta: jnp.ndarray) -> jnp.ndarray:
    """Mueller rotator matrix R(theta) of shape (..., 4, 4)."""
    c = jnp.cos(2.0 * theta)
    s = jnp.sin(2.0 * theta)
    z = jnp.zeros_like(c)
    o = jnp.ones_like(c)
    rows = [
        jnp.stack([o, z, z, z], axis=-1),
        jnp.stack([z, c, s, z], axis=-1),
        jnp.stack([z, -s, c, z], axis=-1),
        jnp.stack([z, z, z, o], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def unit_angle(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Numerically stable angle between unit vectors."""
    dot_ab = jnp.clip(dot(a, b), -1.0, 1.0)
    return jnp.arccos(dot_ab)


def rotate_stokes_basis(
    w: jnp.ndarray, basis_current: jnp.ndarray, basis_target: jnp.ndarray
) -> jnp.ndarray:
    """Mueller rotator re-expressing Stokes vectors from ``basis_current`` to
    ``basis_target`` (both perpendicular to propagation ``w``).
    Returns shape ``(..., 4, 4)``.

    Trig-free: with c = cos(theta) = a.b and signed s = sin(theta) =
    w.(a x b) (a, b both perpendicular to w), the rotator entries are
    cos(2 theta) = 2c^2 - 1 and sin(2 theta) = 2cs — no
    arccos/cos/sin on the hot path."""
    a = normalize(basis_current)
    b = normalize(basis_target)
    c = jnp.clip(dot(a, b), -1.0, 1.0)
    s = dot(w, cross(a, b))  # signed sin(theta)
    c2 = 2.0 * c * c - 1.0
    s2 = 2.0 * c * s
    z = jnp.zeros_like(c2)
    o = jnp.ones_like(c2)
    rows = [
        jnp.stack([o, z, z, z], axis=-1),
        jnp.stack([z, c2, s2, z], axis=-1),
        jnp.stack([z, -s2, c2, z], axis=-1),
        jnp.stack([z, z, z, o], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def rotate_mueller_basis(
    M: jnp.ndarray,
    in_w: jnp.ndarray,
    in_basis_current: jnp.ndarray,
    in_basis_target: jnp.ndarray,
    out_w: jnp.ndarray,
    out_basis_current: jnp.ndarray,
    out_basis_target: jnp.ndarray,
) -> jnp.ndarray:
    """Express Mueller matrix ``M`` (shape (..., 4, 4)) defined w.r.t. the
    'current' input/output bases in the 'target' bases:
    ``R_out @ M @ R_in^-1`` where R rotates current->target."""
    r_in = rotate_stokes_basis(in_w, in_basis_current, in_basis_target)
    r_out = rotate_stokes_basis(out_w, out_basis_current, out_basis_target)
    # inverse of a rotator is its transpose
    r_in_inv = jnp.swapaxes(r_in, -1, -2)
    hi = jax.lax.Precision.HIGHEST
    return jnp.matmul(jnp.matmul(r_out, M, precision=hi), r_in_inv,
                      precision=hi)


def mueller_product(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched per-channel Mueller product ``a @ b`` for spectra of shape
    ``(..., 4, 4, C)``, unrolled into 64 elementwise multiply-adds (exact
    float32, and no batched 4x4 dot_general for XLA to lower)."""
    rows = []
    for i in range(4):
        cols = []
        for j in range(4):
            s = a[..., i, 0, :] * b[..., 0, j, :]
            for k in range(1, 4):
                s = s + a[..., i, k, :] * b[..., k, j, :]
            cols.append(s)
        rows.append(jnp.stack(cols, axis=-2))
    return jnp.stack(rows, axis=-3)


def rotate_mueller_product(r_out: jnp.ndarray, M: jnp.ndarray,
                           r_in: jnp.ndarray) -> jnp.ndarray:
    """``r_out (..., 4, 4) @ M (..., 4, 4, C) @ r_in (..., 4, 4)`` with the
    same unrolled elementwise lowering as :func:`mueller_product`."""
    # t = M @ r_in  (contract M's j with r_in's row index)
    t_rows = []
    for i in range(4):
        cols = []
        for j in range(4):
            s = M[..., i, 0, :] * r_in[..., 0, j, None]
            for k in range(1, 4):
                s = s + M[..., i, k, :] * r_in[..., k, j, None]
            cols.append(s)
        t_rows.append(jnp.stack(cols, axis=-2))
    t = jnp.stack(t_rows, axis=-3)
    # r_out @ t
    o_rows = []
    for i in range(4):
        cols = []
        for j in range(4):
            s = r_out[..., i, 0, None] * t[..., 0, j, :]
            for k in range(1, 4):
                s = s + r_out[..., i, k, None] * t[..., k, j, :]
            cols.append(s)
        o_rows.append(jnp.stack(cols, axis=-2))
    return jnp.stack(o_rows, axis=-3)


def linear_polarizer(transmission: jnp.ndarray) -> jnp.ndarray:
    t = transmission
    z = jnp.zeros_like(t)
    h = 0.5 * t
    rows = [
        jnp.stack([h, h, z, z], axis=-1),
        jnp.stack([h, h, z, z], axis=-1),
        jnp.stack([z, z, z, z], axis=-1),
        jnp.stack([z, z, z, z], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def specular_reflection_mueller(cos_theta_i: jnp.ndarray, eta_re: jnp.ndarray,
                                eta_im: jnp.ndarray) -> jnp.ndarray:
    """Mueller matrix for specular reflection off a (possibly complex-IOR)
    surface — the polarized Fresnel used by conductor/GGX BSDFs (the gold 'Au'
    wall in /root/reference/examples/polarization scenes).

    Returns shape ``(..., 4, 4)`` in the s/p basis.  Implements the standard
    Fresnel equations for complex eta = eta_re + i*eta_im.
    """
    A, B, C, S = specular_abcs(cos_theta_i, eta_re, eta_im)
    z = jnp.zeros_like(A)
    rows = [
        jnp.stack([A, B, z, z], axis=-1),
        jnp.stack([B, A, z, z], axis=-1),
        jnp.stack([z, z, C, S], axis=-1),
        jnp.stack([z, z, -S, C], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def specular_abcs(cos_theta_i: jnp.ndarray, eta_re: jnp.ndarray,
                  eta_im: jnp.ndarray):
    """The four independent entries (A, B, C, S) of the s/p-basis specular
    Mueller matrix [[A,B,0,0],[B,A,0,0],[0,0,C,S],[0,0,-S,C]]."""
    ci = jnp.clip(jnp.abs(cos_theta_i), 1e-6, 1.0)
    si2 = 1.0 - ci * ci
    eta2_re = eta_re * eta_re - eta_im * eta_im
    eta2_im = 2.0 * eta_re * eta_im
    # t = eta^2 - sin^2(theta), complex sqrt
    t_re = eta2_re - si2
    t_im = eta2_im
    mag = jnp.sqrt(t_re * t_re + t_im * t_im)
    ct_re = jnp.sqrt(jnp.maximum((mag + t_re) * 0.5, 0.0))
    ct_im = jnp.sign(t_im + 1e-30) * jnp.sqrt(jnp.maximum((mag - t_re) * 0.5, 0.0))
    # r_s = (ci - ct)/(ci + ct); r_p = (eta^2 ci - ct)/(eta^2 ci + ct)
    def cdiv(ar, ai, br, bi):
        d = br * br + bi * bi
        return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d

    rs_re, rs_im = cdiv(ci - ct_re, -ct_im, ci + ct_re, ct_im)
    a_re, a_im = eta2_re * ci, eta2_im * ci
    rp_re, rp_im = cdiv(a_re - ct_re, a_im - ct_im, a_re + ct_re, a_im + ct_im)
    Rs = rs_re * rs_re + rs_im * rs_im
    Rp = rp_re * rp_re + rp_im * rp_im
    # relative phase
    cr = rs_re * rp_re + rs_im * rp_im
    cri = rs_im * rp_re - rs_re * rp_im
    amp = jnp.sqrt(jnp.maximum(Rs * Rp, 0.0))
    denom = jnp.sqrt(cr * cr + cri * cri) + 1e-30
    cos_d = cr / denom
    sin_d = cri / denom
    A = 0.5 * (Rs + Rp)
    B = 0.5 * (Rs - Rp)
    C = amp * cos_d
    S = amp * sin_d
    return A, B, C, S


def depolarizer(value: jnp.ndarray) -> jnp.ndarray:
    """Ideal depolarizer Mueller matrix scaled by ``value`` (...,):
    only M[0,0] nonzero.  Used to lift unpolarized BSDF values (diffuse) into
    polarized mode, as Mitsuba does."""
    z = jnp.zeros_like(value)
    rows = [
        jnp.stack([value, z, z, z], axis=-1),
        jnp.stack([z, z, z, z], axis=-1),
        jnp.stack([z, z, z, z], axis=-1),
        jnp.stack([z, z, z, z], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def rotator_angles(w, basis_current, basis_target):
    """(cos 2theta, sin 2theta) of the rotator re-expressing Stokes bases
    (the trig-free core of rotate_stokes_basis, without building the 4x4)."""
    from .math import normalize as _nrm

    a = _nrm(basis_current)
    b = _nrm(basis_target)
    c = jnp.clip(dot(a, b), -1.0, 1.0)
    s = dot(w, cross(a, b))
    return 2.0 * c * c - 1.0, 2.0 * c * s


def rotator_angles_unnorm(w, f1, f2):
    """:func:`rotator_angles` for UNNORMALIZED basis vectors.

    ``w`` must be unit; ``f1``/``f2`` are basis vectors perpendicular to
    ``w`` at ANY positive scale.  With d = f1.f2 = k cos(t) and
    x = w.(f1 x f2) = k sin(t) (same k = |f1||f2|):
    cos 2t = (d^2 - x^2)/(d^2 + x^2),  sin 2t = 2 d x/(d^2 + x^2) —
    one reciprocal instead of two vector normalizations.  Measured on the
    polarized cbox (round 5): the three per-bounce rotator-angle
    computations were 17% of the whole render wall (scripts/
    r5_pol_ablate.py: 48.0 -> 57.4 Mrays/s with angles stubbed)."""
    d = dot(f1, f2)
    x = dot(w, cross(f1, f2))
    d2 = d * d
    x2 = x * x
    inv = 1.0 / jnp.maximum(d2 + x2, 1e-30)
    return (d2 - x2) * inv, 2.0 * d * x * inv


def specular_sandwich(A, B, C, S, ci2, si2, co2, so2):
    """Closed form of ``R_out @ F @ R_in`` for the specular Mueller F
    ([[A,B,0,0],[B,A,0,0],[0,0,C,S],[0,0,-S,C]]) between rotators with
    (cos 2t, sin 2t) = (ci2, si2) / (co2, so2): 16 multiplies instead of two
    unrolled 4x4 products (the polarized hot path's dominant cost).
    All args (..., C)-broadcastable; returns (..., 4, 4[, C])."""
    z = jnp.zeros_like(A)
    r0 = jnp.stack([A, B * ci2, B * si2, z], axis=-2)
    r1 = jnp.stack([co2 * B, co2 * A * ci2 - so2 * C * si2,
                    co2 * A * si2 + so2 * C * ci2, so2 * S], axis=-2)
    r2 = jnp.stack([-so2 * B, -so2 * A * ci2 - co2 * C * si2,
                    -so2 * A * si2 + co2 * C * ci2, co2 * S], axis=-2)
    r3 = jnp.stack([z, S * si2, -S * ci2, C], axis=-2)
    return jnp.stack([r0, r1, r2, r3], axis=-3)


def specular_sandwich_col0(A, B, co2, so2):
    """Column 0 of ``R_out @ F @ R_in``: [A, co2*B, -so2*B, 0] — all an
    unpolarized source needs (emission Stokes = E * column 0)."""
    z = jnp.zeros_like(A)
    return jnp.stack([A, co2 * B, -so2 * B, z], axis=-2)


def mueller_matvec(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Batched per-channel ``m @ v`` for m (..., 4, 4, C), v (..., 4, C):
    16 multiply-adds (vs 64 for a full mueller_product whose result is then
    reduced to one column)."""
    outs = []
    for i in range(4):
        s = m[..., i, 0, :] * v[..., 0, :]
        for k in range(1, 4):
            s = s + m[..., i, k, :] * v[..., k, :]
        outs.append(s)
    return jnp.stack(outs, axis=-2)


# ---------------------------------------------------------------------------
# SoA Mueller representation: tuple of 16 (..., C) arrays, row-major
# (entry (i, j) at index 4*i + j).
#
# WHY: a compiler may give a rank-4 (N, 4, 4, C) loop carry several layouts
# and copy between them inside the polarized wavefront loop.  Sixteen
# rank-2 (N, C) arrays are the same shape class as every unpolarized carry,
# get one canonical layout, and fuse.
# ---------------------------------------------------------------------------

def msoa_product(a: tuple, b: tuple) -> tuple:
    """SoA Mueller product a @ b: 64 elementwise multiply-adds."""
    out = []
    for i in range(4):
        for j in range(4):
            s = a[4 * i] * b[j]
            for k in range(1, 4):
                s = s + a[4 * i + k] * b[4 * k + j]
            out.append(s)
    return tuple(out)


def msoa_matvec(m: tuple, v: tuple) -> tuple:
    """SoA m @ v for a 4-component Stokes tuple v: 16 multiply-adds."""
    out = []
    for i in range(4):
        s = m[4 * i] * v[0]
        for k in range(1, 4):
            s = s + m[4 * i + k] * v[k]
        out.append(s)
    return tuple(out)


def msoa_scale(m: tuple, s: jnp.ndarray) -> tuple:
    return tuple(e * s for e in m)


def msoa_where(mask: jnp.ndarray, a: tuple, b: tuple) -> tuple:
    return tuple(jnp.where(mask, x, y) for x, y in zip(a, b))


def msoa_from_dense(M: jnp.ndarray) -> tuple:
    """(..., 4, 4, C) -> tuple16 of (..., C)."""
    return tuple(M[..., i, j, :] for i in range(4) for j in range(4))


def msoa_to_dense(m: tuple) -> jnp.ndarray:
    rows = [jnp.stack(m[4 * i : 4 * i + 4], axis=-2) for i in range(4)]
    return jnp.stack(rows, axis=-3)


def specular_sandwich_soa(A, B, C, S, ci2, si2, co2, so2) -> tuple:
    """SoA form of :func:`specular_sandwich` (R_out @ F @ R_in)."""
    z = jnp.zeros_like(A)
    return (
        A, B * ci2, B * si2, z,
        co2 * B, co2 * A * ci2 - so2 * C * si2,
        co2 * A * si2 + so2 * C * ci2, so2 * S,
        -so2 * B, -so2 * A * ci2 - co2 * C * si2,
        -so2 * A * si2 + co2 * C * ci2, co2 * S,
        z, S * si2, -S * ci2, C,
    )


def rotator_soa(c2, s2) -> tuple:
    """SoA Mueller rotator from (cos 2theta, sin 2theta)."""
    z = jnp.zeros_like(c2)
    o = jnp.ones_like(c2)
    return (o, z, z, z,
            z, c2, s2, z,
            z, -s2, c2, z,
            z, z, z, o)


# ---------------------------------------------------------------------------
# Structured right-applies (pending-rotator carry).
#
# The per-bounce Mueller update beta' = beta @ (R_out F R_in) does not need
# the sandwich built or a 64-madd product: R_in of bounce k and R_out of
# bounce k+1 are rotators about the SAME path segment (consecutive vertices'
# Stokes bases agree along shared segments — bsdf/polarized.py docstring),
# so they compose by angle addition.  Carrying (stored beta, pending rotator
# angles) with true beta = stored @ R(pend) turns each specular bounce into
# one column Givens (24 ops) + one Fresnel column-mix (48 ops), and each
# depolarizing (diffuse) bounce into a 4-mult column-0 mask; column-0 reads
# (emitter hits, RR on entry 00) see the stored beta unchanged because
# rotators fix e0.  Measured round 4 on the polarized cbox: 44.9 -> see
# BASELINE.md.
# ---------------------------------------------------------------------------

def rot2_compose(ca, sa, cb, sb):
    """Compose two Mueller rotators given as (cos 2t, sin 2t) pairs:
    R(a) @ R(b) = R(a+b)."""
    return ca * cb - sa * sb, ca * sb + sa * cb


def msoa_apply_rotator_cols(m: tuple, c2, s2) -> tuple:
    """``m @ R(c2, s2)``: a Givens mix of columns 1 and 2 (24 ops vs 112
    for a general msoa_product)."""
    out = list(m)
    for i in range(4):
        b1, b2 = m[4 * i + 1], m[4 * i + 2]
        out[4 * i + 1] = b1 * c2 - b2 * s2
        out[4 * i + 2] = b1 * s2 + b2 * c2
    return tuple(out)


def msoa_apply_fresnel_cols(m: tuple, A, B, C, S) -> tuple:
    """``m @ F`` for the s/p specular Mueller
    F = [[A,B,0,0],[B,A,0,0],[0,0,C,S],[0,0,-S,C]] (48 ops)."""
    out = [None] * 16
    for i in range(4):
        b0, b1, b2, b3 = (m[4 * i], m[4 * i + 1], m[4 * i + 2], m[4 * i + 3])
        out[4 * i] = b0 * A + b1 * B
        out[4 * i + 1] = b0 * B + b1 * A
        out[4 * i + 2] = b2 * C - b3 * S
        out[4 * i + 3] = b2 * S + b3 * C
    return tuple(out)


def msoa_depolarize_cols(m: tuple, value) -> tuple:
    """``m @ (value * depolarizer)``: only column 0 survives, scaled."""
    z = jnp.zeros_like(m[0])
    out = []
    for i in range(4):
        out.extend([m[4 * i] * value, z, z, z])
    return tuple(out)


def msoa_identity(like) -> tuple:
    """SoA identity Mueller with entries shaped like ``like``."""
    z = jnp.zeros_like(like)
    o = jnp.ones_like(like)
    return (o, z, z, z, z, o, z, z, z, z, o, z, z, z, z, o)


def stokes_rotate(v: tuple, c2, s2) -> tuple:
    """``R(c2, s2) @ v`` for a 4-component Stokes tuple (6 ops)."""
    return (v[0], c2 * v[1] + s2 * v[2], -s2 * v[1] + c2 * v[2], v[3])


def msoa_apply_sandwich(m: tuple, A, B, C, S, ci2, si2, co2, so2) -> tuple:
    """``m @ (R_out F R_in)`` via three structured right-applies (96 ops)
    instead of building the sandwich and running a 64-madd product — for
    carries that do not track a pending rotator (e.g. the NLOS loop)."""
    return msoa_apply_rotator_cols(
        msoa_apply_fresnel_cols(
            msoa_apply_rotator_cols(m, co2, so2), A, B, C, S),
        ci2, si2)


def stokes_apply_sandwich(v: tuple, A, B, C, S, ci2, si2, co2, so2) -> tuple:
    """``(R_out F R_in) @ v`` via three structured left-applies (20 ops)
    instead of building the sandwich and running a 16-madd matvec."""
    v = stokes_rotate(v, ci2, si2)
    v = (A * v[0] + B * v[1], B * v[0] + A * v[1],
         C * v[2] + S * v[3], -S * v[2] + C * v[3])
    return stokes_rotate(v, co2, so2)
