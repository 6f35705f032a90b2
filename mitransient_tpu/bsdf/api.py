"""BSDF evaluation/sampling over the compiled BSDF table.

JAX replacement for Mitsuba's virtual ``bsdf.sample/eval/eval_pdf``
dispatch (/root/reference/mitransient/integrators/transientpath.py:208-227).
Instead of per-lane virtual calls, every BSDF *kind* is evaluated densely for
all lanes and the result selected by the per-lane kind code — branchless VPU
work, which beats masked divergent execution for the small kind count (5)
found in the reference's scene corpus.

Conventions (matching Mitsuba):
* directions are in the local shading frame, +z = normal, pointing away from
  the surface; ``wi`` is toward the viewer.
* ``eval``/``eval_pdf`` return f * |cos_theta_o| and exclude delta lobes.
* ``sample`` returns weight = f * |cos| / pdf (delta lobes: weight = F).
* two-sided BSDFs mirror the frame when ``wi.z < 0``
  (Mitsuba ``twosided`` wrapper).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core.math import safe_div, safe_rcp, safe_sqrt, stable_normalize
from ..core.records import BSDFSample
from ..core.warp import (
    square_to_cosine_hemisphere,
    square_to_cosine_hemisphere_pdf,
)
from ..ops.gather import columns_lookup
from ..scene.scene import (
    BSDF_CONDUCTOR,
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_NULL,
    BSDF_ROUGH_CONDUCTOR,
    BSDF_ROUGH_PLASTIC,
    BSDFParams,
    KindsStatic,
)
from .fresnel import fresnel_conductor, fresnel_dielectric


class LaneBSDF(NamedTuple):
    """Per-lane gathered BSDF parameters."""

    kind: jnp.ndarray  # (N,) int32
    two_sided: jnp.ndarray  # (N,) bool
    reflectance: jnp.ndarray  # (N, C)
    eta_re: jnp.ndarray
    eta_im: jnp.ndarray
    alpha: jnp.ndarray  # (N,) GGX alpha_u (tangent)
    eta_ratio: jnp.ndarray  # (N,)
    alpha_v: jnp.ndarray  # (N,) GGX alpha_v (bitangent); == alpha if isotropic
    # static kind-presence metadata (trace-time lobe pruning); default ()
    # means unknown -> evaluate every lobe
    ks: KindsStatic = KindsStatic()


def gather_lane_bsdf(bp: BSDFParams, bsdf_id: jnp.ndarray,
                     uv: jnp.ndarray | None = None) -> LaneBSDF:
    """Per-lane BSDF parameter gather.  Pass the hit ``uv`` to resolve
    textured reflectance (bitmap/checkerboard parameters in the reference
    stack); scenes without textures skip the lookup statically."""
    i = jnp.maximum(bsdf_id, 0)
    cols = columns_lookup(
        {
            "kind": bp.kind.astype(jnp.float32),
            "two_sided": bp.two_sided.astype(jnp.float32),
            "reflectance": bp.reflectance,
            "eta_re": bp.eta_re,
            "eta_im": bp.eta_im,
            "alpha": bp.alpha,
            "eta_ratio": bp.eta_ratio,
            "alpha_v": bp.alpha_v if bp.alpha_v is not None else bp.alpha,
        },
        i,
    )
    lb = LaneBSDF(
        kind=jnp.where(
            bsdf_id >= 0, jnp.round(cols["kind"]).astype(jnp.int32), -1
        ),
        two_sided=cols["two_sided"] > 0.5,
        reflectance=cols["reflectance"],
        eta_re=cols["eta_re"],
        eta_im=cols["eta_im"],
        alpha=cols["alpha"],
        eta_ratio=cols["eta_ratio"],
        alpha_v=cols["alpha_v"],
        ks=bp.ks,
    )
    if uv is not None and bp.textures is not None:
        lb = _apply_texture(bp, i, lb, uv)
    return lb


def _apply_texture(bp: BSDFParams, idx: jnp.ndarray, lb: LaneBSDF,
                   uv: jnp.ndarray) -> LaneBSDF:
    """Override reflectance for textured lanes: bilinear 4-tap atlas lookup
    with repeat wrapping (Mitsuba bitmap texture defaults: wrap_mode=repeat,
    filter_type=bilinear)."""
    cols = columns_lookup(
        {
            "tex_id": bp.tex_id.astype(jnp.float32),
            "tex_hw": bp.tex_hw,
            "tex_uv": bp.tex_uv,
        },
        idx,
    )
    tid = jnp.round(cols["tex_id"]).astype(jnp.int32)
    h = jnp.maximum(cols["tex_hw"][:, 0], 1.0)
    w = jnp.maximum(cols["tex_hw"][:, 1], 1.0)
    tuv = cols["tex_uv"]
    u = uv[:, 0] * tuv[:, 0] + tuv[:, 2]
    v = uv[:, 1] * tuv[:, 1] + tuv[:, 3]
    u = u - jnp.floor(u)
    v = v - jnp.floor(v)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    nt, th, tw, C = bp.textures.shape
    flat = bp.textures.reshape(nt * th * tw, C)
    tidc = jnp.maximum(tid, 0)

    def tap(xi, yi):
        xi = jnp.mod(xi, w).astype(jnp.int32)
        yi = jnp.mod(yi, h).astype(jnp.int32)
        return jnp.take(flat, (tidc * th + yi) * tw + xi, axis=0)

    c00 = tap(x0, y0)
    c10 = tap(x0 + 1.0, y0)
    c01 = tap(x0, y0 + 1.0)
    c11 = tap(x0 + 1.0, y0 + 1.0)
    val = (c00 * (1.0 - fx) + c10 * fx) * (1.0 - fy) + (
        c01 * (1.0 - fx) + c11 * fx) * fy
    refl = jnp.where((tid >= 0)[:, None], val, lb.reflectance)
    return lb._replace(reflectance=refl)


def _fdr(eta):
    """Average internal diffuse Fresnel reflectance (Egan & Hilgeman fit for
    eta > 1; same approximation Mitsuba's plastic uses)."""
    e2 = eta * eta
    return -1.4399 / e2 + 0.7099 / eta + 0.6681 + 0.0636 * eta


def is_smooth(lb: LaneBSDF) -> jnp.ndarray:
    """Lanes whose BSDF has a non-delta component (NEE applies);
    mi.BSDFFlags.Smooth check at transientpath.py:188-189."""
    return ((lb.kind == BSDF_DIFFUSE) | (lb.kind == BSDF_ROUGH_CONDUCTOR)
            | (lb.kind == BSDF_ROUGH_PLASTIC))


def is_null(lb: LaneBSDF) -> jnp.ndarray:
    return lb.kind == BSDF_NULL


def _maybe_flip(lb: LaneBSDF, wi: jnp.ndarray):
    """Two-sided handling: flip z for lanes with wi below the surface.
    Statically a no-op when the scene has no two-sided BSDFs."""
    if not lb.ks.any_two_sided:
        return jnp.ones_like(wi[..., 2])
    flip = lb.two_sided & (wi[..., 2] < 0.0)
    sgn = jnp.where(flip, -1.0, 1.0)
    return sgn


# --------------------------------------------------------------------------
# GGX microfacet helpers (anisotropic Trowbridge-Reitz, Smith separable,
# visible-normal sampling).  alpha_u/alpha_v are the tangent/bitangent
# roughnesses (Mitsuba roughconductor's alpha_u/alpha_v); the isotropic case
# is alpha_u == alpha_v.
# --------------------------------------------------------------------------

GGX_ALPHA_MIN = 1e-4  # Mitsuba-style roughness floor: keeps the GGX chain
# (and its alpha-VJP) finite when the dense all-kinds dispatch evaluates the
# lobe on lanes whose BSDF row carries alpha = 0 (non-GGX materials)


def _ggx_ndf(m: jnp.ndarray, au: jnp.ndarray, av: jnp.ndarray) -> jnp.ndarray:
    """D(m) = 1 / (pi au av ((x/au)^2 + (y/av)^2 + z^2)^2), m.z > 0."""
    au = jnp.maximum(au, GGX_ALPHA_MIN)
    av = jnp.maximum(av, GGX_ALPHA_MIN)
    cz = jnp.maximum(m[..., 2], 0.0)
    sx = safe_div(m[..., 0], au)
    sy = safe_div(m[..., 1], av)
    denom = sx * sx + sy * sy + cz * cz
    return safe_div(1.0, jnp.pi * au * av * denom * denom) * (cz > 0.0)


def _ggx_g1(v: jnp.ndarray, au: jnp.ndarray, av: jnp.ndarray) -> jnp.ndarray:
    """Smith masking with direction-dependent projected roughness:
    G1 = 2 / (1 + sqrt(1 + (au^2 x^2 + av^2 y^2) / z^2))."""
    au = jnp.maximum(au, GGX_ALPHA_MIN)
    av = jnp.maximum(av, GGX_ALPHA_MIN)
    cz = v[..., 2]
    a2t2 = safe_div(
        au * au * v[..., 0] ** 2 + av * av * v[..., 1] ** 2, cz * cz)
    return safe_div(2.0, 1.0 + jnp.sqrt(1.0 + a2t2))


def _ggx_sample_vndf(wi: jnp.ndarray, au: jnp.ndarray, av: jnp.ndarray,
                     u: jnp.ndarray):
    """Heitz 2018 visible-normal sampling; wi must have wi.z > 0."""
    au = jnp.maximum(au, GGX_ALPHA_MIN)
    av = jnp.maximum(av, GGX_ALPHA_MIN)
    vh = jnp.stack(
        [au * wi[..., 0], av * wi[..., 1], wi[..., 2]], axis=-1
    )
    vh = vh / jnp.maximum(jnp.linalg.norm(vh, axis=-1, keepdims=True), 1e-12)
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = safe_rcp(jnp.sqrt(jnp.maximum(lensq, 1e-20)))
    t1 = jnp.where(
        (lensq > 1e-12)[..., None],
        jnp.stack([-vh[..., 1] * inv_len, vh[..., 0] * inv_len,
                   jnp.zeros_like(inv_len)], axis=-1),
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0]), vh.shape),
    )
    t2 = jnp.cross(vh, t1)
    r = jnp.sqrt(jnp.maximum(u[..., 0], 0.0))
    phi = 2.0 * jnp.pi * u[..., 1]
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    # clamped-sqrt floors keep the sqrt VJP finite when the argument touches
    # 0 exactly (disk-boundary samples); the 1e-6 floor on the resulting
    # component is far below sampling noise
    p2 = (1.0 - s) * jnp.sqrt(jnp.maximum(1.0 - p1 * p1, 1e-12)) + s * p2
    p3 = jnp.sqrt(jnp.maximum(1.0 - p1 * p1 - p2 * p2, 1e-12))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    m = jnp.stack(
        [au * nh[..., 0], av * nh[..., 1],
         jnp.maximum(nh[..., 2], 1e-6)], axis=-1
    )
    return m / jnp.maximum(jnp.linalg.norm(m, axis=-1, keepdims=True), 1e-12)


def _reflect(wi: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    return 2.0 * jnp.sum(wi * m, axis=-1, keepdims=True) * m - wi


# --------------------------------------------------------------------------
# eval_pdf: smooth lobes only (diffuse + rough conductor)
# --------------------------------------------------------------------------

def eval_pdf(lb: LaneBSDF, wi: jnp.ndarray, wo: jnp.ndarray,
             active: jnp.ndarray):
    """Returns (f*cos (N, C), pdf (N,)) for the smooth component.

    Lobes whose kind is statically absent from the scene (``lb.ks``) are
    pruned at trace time — the compiled kernel is scene-specialized, like
    Dr.Jit's JIT specializing the megakernel on the loaded plugin set."""
    ks = lb.ks
    has_diff = ks.has(BSDF_DIFFUSE)
    has_rough = ks.has(BSDF_ROUGH_CONDUCTOR)
    has_plast = ks.has(BSDF_ROUGH_PLASTIC)

    # spectral lift: squeezed mono tables ((N,) — integrators/path_regen
    # "Mono squeeze") broadcast per-lane scalars with no trailing axis
    spec1 = lb.reflectance.ndim == 1

    def sl(x):
        return x if spec1 else x[..., None]

    sgn = _maybe_flip(lb, wi)
    wi_l = wi * jnp.stack([jnp.ones_like(sgn)] * 2 + [sgn], axis=-1)
    wo_l = wo * jnp.stack([jnp.ones_like(sgn)] * 2 + [sgn], axis=-1)
    ci = wi_l[..., 2]
    co = wo_l[..., 2]
    both_up = (ci > 0.0) & (co > 0.0)
    ok = active & both_up

    lobes = []  # (mask, f, pdf) per present smooth kind

    if has_diff or has_plast:
        pdf_diff = square_to_cosine_hemisphere_pdf(wo_l)
    if has_diff:
        f_diff = lb.reflectance * sl(co / jnp.pi)
        lobes.append((lb.kind == BSDF_DIFFUSE, f_diff, pdf_diff))

    if has_rough or has_plast:
        m = stable_normalize(wi_l + wo_l)
        d_ndf = _ggx_ndf(m, lb.alpha, lb.alpha_v)
        g1_i = _ggx_g1(wi_l, lb.alpha, lb.alpha_v)
        g = g1_i * _ggx_g1(wo_l, lb.alpha, lb.alpha_v)
        # VNDF pdf in wo measure: G1 * D * (wi.m) / wi.z / (4 wi.m)
        pdf_rough = safe_div(g1_i * d_ndf, 4.0 * ci)

    if has_rough:
        F = fresnel_conductor(jnp.sum(wi_l * m, axis=-1), lb.eta_re,
                              lb.eta_im)
        f_rough = (lb.reflectance * F
                   * sl(safe_div(d_ndf * g, 4.0 * ci)))
        lobes.append((lb.kind == BSDF_ROUGH_CONDUCTOR, f_rough, pdf_rough))

    if has_plast:
        # rough plastic (GGX dielectric coating over a diffuse substrate;
        # Mitsuba roughplastic with nonlinear=false)
        Fi, _, _, _ = fresnel_dielectric(ci, lb.eta_ratio)
        Fo, _, _, _ = fresnel_dielectric(co, lb.eta_ratio)
        F_sp = fresnel_dielectric(jnp.sum(wi_l * m, axis=-1), lb.eta_ratio)[0]
        f_pl_spec = F_sp * safe_div(d_ndf * g, 4.0 * ci)
        inv_eta2 = 1.0 / (lb.eta_ratio * lb.eta_ratio)
        fdr = _fdr(lb.eta_ratio)
        f_pl_diff = (
            lb.reflectance
            * sl((1.0 - Fi) * (1.0 - Fo) * inv_eta2
                 / (jnp.pi * (1.0 - fdr)) * co)
        )
        f_plastic = f_pl_diff + sl(f_pl_spec)
        pdf_plastic = Fi * pdf_rough + (1.0 - Fi) * pdf_diff
        lobes.append((lb.kind == BSDF_ROUGH_PLASTIC, f_plastic, pdf_plastic))

    n = lb.reflectance.shape[0]
    f = jnp.zeros_like(lb.reflectance)
    pdf = jnp.zeros((n,), jnp.float32)
    for mask, f_k, pdf_k in lobes:
        f = jnp.where(sl(ok & mask), f_k, f)
        pdf = jnp.where(ok & mask, pdf_k, pdf)
    return f, pdf


# --------------------------------------------------------------------------
# sample
# --------------------------------------------------------------------------

def sample(lb: LaneBSDF, wi: jnp.ndarray, u1: jnp.ndarray, u2: jnp.ndarray,
           active: jnp.ndarray) -> BSDFSample:
    """Sample an outgoing direction per lane.  Statically absent kinds
    (``lb.ks``) are pruned at trace time."""
    ks = lb.ks
    has_diff = ks.has(BSDF_DIFFUSE)
    has_mirr = ks.has(BSDF_CONDUCTOR)
    has_rough = ks.has(BSDF_ROUGH_CONDUCTOR)
    has_diel = ks.has(BSDF_DIELECTRIC)
    has_null = ks.has(BSDF_NULL)
    has_plast = ks.has(BSDF_ROUGH_PLASTIC)

    n = wi.shape[0]
    # spectral lift: squeezed mono tables ((N,) — integrators/path_regen
    # "Mono squeeze") broadcast per-lane scalars with no trailing axis
    spec1 = lb.reflectance.ndim == 1

    def sl(x):
        return x if spec1 else x[..., None]

    spec_ones = jnp.ones_like(lb.reflectance)
    sgn = _maybe_flip(lb, wi)
    wi_l = wi * jnp.stack([jnp.ones_like(sgn)] * 2 + [sgn], axis=-1)
    ci = wi_l[..., 2]
    up = ci > 0.0

    # (mask, wo, weight, pdf) per present kind; eta/delta handled separately
    lobes = []

    if has_diff or has_plast:
        # ---- diffuse: cosine hemisphere ----------------------------------
        wo_diff = square_to_cosine_hemisphere(u2)
        pdf_diff = square_to_cosine_hemisphere_pdf(wo_diff)
    if has_diff:
        lobes.append((lb.kind == BSDF_DIFFUSE, wo_diff, lb.reflectance,
                      pdf_diff))

    if has_mirr:
        # ---- smooth conductor: mirror -------------------------------------
        wo_mirr = jnp.stack(
            [-wi_l[..., 0], -wi_l[..., 1], wi_l[..., 2]], axis=-1)
        F_cond = jnp.where(
            (lb.eta_im > 0.0) | (lb.eta_re > 0.0),
            fresnel_conductor(ci, lb.eta_re, lb.eta_im),
            1.0,
        )
        w_mirr = lb.reflectance * F_cond
        lobes.append((lb.kind == BSDF_CONDUCTOR, wo_mirr, w_mirr,
                      jnp.ones(n)))

    if has_rough or has_plast:
        # ---- GGX VNDF microfacet sample (shared rough/plastic) ------------
        # Sanitize dead/backfacing lanes (wi.z <= 0, e.g. miss lanes whose
        # garbage wi is masked downstream): the VNDF warp's AD otherwise
        # produces NaN there (normalize-at-zero / sqrt-at-zero VJPs) which
        # poisons full-loop gradients through the where-mask.
        wi_v = jnp.where((wi_l[..., 2] > 1e-6)[..., None], wi_l,
                         jnp.array([0.0, 0.0, 1.0], wi_l.dtype))
        m = _ggx_sample_vndf(wi_v, lb.alpha, lb.alpha_v, u2)
        wo_rough = _reflect(wi_l, m)
        co_r = wo_rough[..., 2]
        d_ndf = _ggx_ndf(m, lb.alpha, lb.alpha_v)
        g1_i = _ggx_g1(wi_l, lb.alpha, lb.alpha_v)
        pdf_rough = safe_div(g1_i * d_ndf, 4.0 * ci)

    if has_rough:
        F_r = fresnel_conductor(jnp.sum(wi_l * m, axis=-1), lb.eta_re,
                                lb.eta_im)
        # weight = f*cos/pdf = F * G2/G1(wi)
        g2 = g1_i * _ggx_g1(wo_rough, lb.alpha, lb.alpha_v)
        w_rough = lb.reflectance * F_r * sl(safe_div(g2, g1_i))
        rough_ok = (co_r > 0.0) & (pdf_rough > 0.0)
        w_rough = jnp.where(sl(rough_ok), w_rough, 0.0)
        lobes.append((lb.kind == BSDF_ROUGH_CONDUCTOR, wo_rough, w_rough,
                      pdf_rough))

    is_diel = lb.kind == BSDF_DIELECTRIC
    if has_diel:
        # ---- dielectric: Fresnel-weighted reflect/refract ------------------
        ci_signed = wi[..., 2]  # intrinsically two-sided, use true z
        Fd, cos_t, eta_it, eta_ti = fresnel_dielectric(ci_signed,
                                                       lb.eta_ratio)
        refl = u1 < Fd
        wo_refl = jnp.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], axis=-1)
        wo_refr = jnp.stack(
            [-wi[..., 0] * eta_ti, -wi[..., 1] * eta_ti, cos_t], axis=-1
        )
        wo_diel = jnp.where(refl[..., None], wo_refl, wo_refr)
        # transmission carries radiance scale 1/eta_it^2 (solid-angle
        # compression)
        w_diel = jnp.where(sl(refl), spec_ones,
                           sl(eta_ti * eta_ti) * spec_ones)
        eta_diel = jnp.where(refl, 1.0, eta_it)
        pdf_diel = jnp.where(refl, Fd, 1.0 - Fd)
        lobes.append((is_diel, wo_diel, w_diel, pdf_diel))

    if has_null:
        # ---- null: pass-through --------------------------------------------
        lobes.append((lb.kind == BSDF_NULL, -wi, spec_ones,
                      jnp.ones(n)))

    if has_plast:
        # ---- rough plastic: Fresnel-weighted lobe pick, weight = f*cos/pdf
        Fi_pl, _, _, _ = fresnel_dielectric(ci, lb.eta_ratio)
        pick_spec = u1 < Fi_pl
        wo_plast = jnp.where(pick_spec[..., None], wo_rough, wo_diff)
        co_pl = wo_plast[..., 2]
        m_pl = stable_normalize(wi_l + wo_plast)
        d_pl = _ggx_ndf(m_pl, lb.alpha, lb.alpha_v)
        g_pl = (_ggx_g1(wi_l, lb.alpha, lb.alpha_v)
                * _ggx_g1(wo_plast, lb.alpha, lb.alpha_v))
        F_sp_pl = fresnel_dielectric(
            jnp.sum(wi_l * m_pl, axis=-1), lb.eta_ratio)[0]
        Fo_pl, _, _, _ = fresnel_dielectric(co_pl, lb.eta_ratio)
        inv_eta2 = 1.0 / (lb.eta_ratio * lb.eta_ratio)
        fdr = _fdr(lb.eta_ratio)
        f_plast = (
            lb.reflectance
            * sl((1.0 - Fi_pl) * (1.0 - Fo_pl) * inv_eta2
                 / (jnp.pi * (1.0 - fdr)) * co_pl)
            + sl(F_sp_pl * safe_div(d_pl * g_pl, 4.0 * ci))
        )
        pdf_vndf_pl = safe_div(
            _ggx_g1(wi_l, lb.alpha, lb.alpha_v) * d_pl, 4.0 * ci)
        pdf_plast = (
            Fi_pl * pdf_vndf_pl
            + (1.0 - Fi_pl) * square_to_cosine_hemisphere_pdf(wo_plast))
        plast_ok = (co_pl > 0.0) & (pdf_plast > 1e-9)
        w_plast = jnp.where(
            sl(plast_ok),
            f_plast / sl(jnp.maximum(pdf_plast, 1e-9)), 0.0)
        lobes.append((lb.kind == BSDF_ROUGH_PLASTIC, wo_plast, w_plast,
                      pdf_plast))

    # kinds that sample in the (possibly flipped) local upper hemisphere
    up_mask = jnp.zeros((n,), bool)
    for code, present in ((BSDF_DIFFUSE, has_diff), (BSDF_CONDUCTOR, has_mirr),
                          (BSDF_ROUGH_CONDUCTOR, has_rough),
                          (BSDF_ROUGH_PLASTIC, has_plast)):
        if present:
            up_mask = up_mask | (lb.kind == code)
    lane_ok = active & (~up_mask | up)

    wo_l = jnp.zeros((n, 3))
    weight = jnp.zeros_like(lb.reflectance)
    pdf = jnp.zeros(n)
    for mask, wo_k, w_k, pdf_k in lobes:
        wo_l = jnp.where(mask[:, None], wo_k, wo_l)
        weight = jnp.where(sl(mask), w_k, weight)
        pdf = jnp.where(mask, pdf_k, pdf)

    eta = (jnp.where(is_diel, eta_diel, 1.0) if has_diel
           else jnp.ones(n))
    delta = jnp.zeros((n,), bool)
    for code, present in ((BSDF_CONDUCTOR, has_mirr),
                          (BSDF_DIELECTRIC, has_diel),
                          (BSDF_NULL, has_null)):
        if present:
            delta = delta | (lb.kind == code)

    nz = (weight != 0.0) if spec1 else jnp.any(weight != 0.0, axis=-1)
    ok = lane_ok & (pdf > 0.0) & nz
    weight = jnp.where(sl(ok), weight, 0.0)

    # un-flip wo for two-sided lanes (dielectric/null already in true frame)
    if ks.any_two_sided:
        z_sgn = jnp.where(up_mask, sgn, 1.0)
        wo = wo_l * jnp.stack(
            [jnp.ones_like(z_sgn), jnp.ones_like(z_sgn), z_sgn], axis=-1
        )
    else:
        wo = wo_l
    return BSDFSample(wo=wo, pdf=jnp.where(ok, pdf, 0.0), eta=eta,
                      delta=delta, weight=weight)
