"""Compiled scene representation + device-side scene queries.

This module is the JAX stand-in for the Mitsuba ``mi.Scene`` API
surface the reference consumes (SURVEY.md section 2.2): ``ray_intersect``,
``ray_test``, ``sample_emitter_direction``, ``pdf_emitter_direction``,
``eval_emitter_direction`` plus emitter evaluation at surface hits.

Everything the device touches lives in :class:`SceneData` — a pytree of flat
SoA arrays (triangle soup, BSDF parameter table, emitter table).  It threads
through ``jit`` / ``grad`` / ``shard_map`` unchanged, and differentiating the
render w.r.t. its leaves (albedos, emitter radiance) is what gives parameter
gradients.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.frame import Frame
from ..core.math import dot, normalize, safe_div
from ..core.records import DirectionSample, Ray, SurfaceInteraction
from ..ops.gather import columns_lookup
from ..ops.intersect import closest_hit as _closest_hit_q, ray_test as _ray_test_q

# BSDF kind codes (see bsdf/ modules)
BSDF_DIFFUSE = 0
BSDF_CONDUCTOR = 1
BSDF_ROUGH_CONDUCTOR = 2
BSDF_DIELECTRIC = 3
BSDF_NULL = 4
BSDF_ROUGH_PLASTIC = 5

# Emitter kind codes
EM_AREA = 0
EM_PROJECTOR = 1
EM_ANGULAR_AREA = 2
EM_POINT = 3


@jax.tree_util.register_static
class KindsStatic(NamedTuple):
    """Static (trace-time) scene metadata: which BSDF/emitter kind codes are
    actually present.  Registered as a *static* pytree node so it rides
    along inside SceneData/BSDFParams/EmitterParams through jit without
    becoming a tracer — the dense evaluate-all-kinds dispatch then prunes
    absent lobes at trace time (a scene-specialized kernel, the XLA
    equivalent of Dr.Jit's JIT specializing on the scene's plugin set)."""

    kinds: tuple = ()
    any_two_sided: bool = True

    def has(self, code: int) -> bool:
        return (not self.kinds) or code in self.kinds


class Triangles(NamedTuple):
    v0: jnp.ndarray  # (M, 3)
    e1: jnp.ndarray  # (M, 3) v1 - v0
    e2: jnp.ndarray  # (M, 3) v2 - v0
    ng: jnp.ndarray  # (M, 3) unit geometric normal
    uv0: jnp.ndarray  # (M, 2)
    uv_e1: jnp.ndarray  # (M, 2)
    uv_e2: jnp.ndarray  # (M, 2)
    area: jnp.ndarray  # (M,)
    shape_id: jnp.ndarray  # (M,) int32
    bsdf_id: jnp.ndarray  # (M,) int32
    emitter_id: jnp.ndarray  # (M,) int32, -1 = none
    medium_id: jnp.ndarray  # (M,) int32 interior medium, -1 = vacuum


class BSDFParams(NamedTuple):
    kind: jnp.ndarray  # (B,) int32
    two_sided: jnp.ndarray  # (B,) bool
    reflectance: jnp.ndarray  # (B, C) diffuse albedo / specular tint
    eta_re: jnp.ndarray  # (B, C) conductor IOR (real)
    eta_im: jnp.ndarray  # (B, C) conductor IOR (imag); 0 => ideal mirror
    alpha: jnp.ndarray  # (B,) GGX roughness along the tangent (alpha_u)
    eta_ratio: jnp.ndarray  # (B,) dielectric int_ior/ext_ior
    # GGX roughness along the bitangent (Mitsuba roughconductor's
    # ``alpha_v``); None => isotropic (alpha_v == alpha)
    alpha_v: jnp.ndarray | None = None
    # Textured reflectance (bitmap/checkerboard textures in the reference
    # stack, e.g. examples/diff-transient/staircase/scene.xml).  All scene
    # textures are packed into ONE padded atlas so a lane's reflectance is a
    # bilinear 4-tap gather keyed by (tex_id, uv); untextured scenes leave
    # these as None and skip the lookup statically.
    tex_id: jnp.ndarray | None = None  # (B,) int32, -1 = untextured
    tex_hw: jnp.ndarray | None = None  # (B, 2) f32 actual (height, width)
    tex_uv: jnp.ndarray | None = None  # (B, 4) f32 (su, sv, ou, ov) uv xform
    textures: jnp.ndarray | None = None  # (NT, TH, TW, C) f32 atlas
    # Shading-frame perturbation (Mitsuba bumpmap/normalmap wrappers in the
    # reference corpus, staircase scene.xml).  The 3-channel atlas packs
    # (height, dh/dx, dh/dy) texel-unit gradients for bumpmaps or tangent-
    # space normals for normalmaps; ray_intersect applies the perturbation.
    bump_id: jnp.ndarray | None = None  # (B,) int32, -1 = unperturbed
    bump_hw: jnp.ndarray | None = None  # (B, 2) f32 (height, width)
    bump_uv: jnp.ndarray | None = None  # (B, 4) f32 uv transform
    bump_scale: jnp.ndarray | None = None  # (B,) f32 bumpmap scale
    bump_kind: jnp.ndarray | None = None  # (B,) int32 1=bump 2=normal
    bump_textures: jnp.ndarray | None = None  # (NB, TH, TW, 3) f32
    # static set of BSDF kind codes present (trace-time lobe pruning);
    # default () = unknown = evaluate everything
    ks: KindsStatic = KindsStatic()


class EmitterParams(NamedTuple):
    kind: jnp.ndarray  # (E,) int32
    radiance: jnp.ndarray  # (E, C) area/angulararea radiance; projector irradiance
    position: jnp.ndarray  # (E, 3) delta emitters
    direction: jnp.ndarray  # (E, 3) projector +z axis
    frame_s: jnp.ndarray  # (E, 3) projector x axis
    frame_t: jnp.ndarray  # (E, 3) projector y axis
    tan_half_fov: jnp.ndarray  # (E,)
    cos_beam: jnp.ndarray  # (E,) angulararea full-intensity cone
    cos_cutoff: jnp.ndarray  # (E,) angulararea cutoff cone
    area: jnp.ndarray  # (E,) total shape surface area (area emitters)
    tri_start: jnp.ndarray  # (E,) int32 range into em_tri_* below
    tri_count: jnp.ndarray  # (E,) int32
    em_tri_idx: jnp.ndarray  # (K,) int32 triangle-soup index
    em_tri_cdf: jnp.ndarray  # (K,) float32 CDF within each emitter's range
    # static set of emitter kind codes present (trace-time branch pruning)
    ks: KindsStatic = KindsStatic()
    # compact per-emitter triangle geometry (rows of the K emitter-triangle
    # slots) so NEE position sampling gathers from a K-row table instead of
    # the full triangle soup; None falls back to the soup lookup
    em_tri_v0: jnp.ndarray | None = None  # (K, 3)
    em_tri_e1: jnp.ndarray | None = None  # (K, 3)
    em_tri_e2: jnp.ndarray | None = None  # (K, 3)
    em_tri_ng: jnp.ndarray | None = None  # (K, 3)
    # shape owning each emitter-triangle row (geometry-gradient routing of
    # NEE sample points through the per-shape delta transforms)
    em_tri_shape: jnp.ndarray | None = None  # (K,) int32


class MediumParams(NamedTuple):
    """Participating media (mi.Medium equivalents consumed by
    transient_prbvolpath; cf. cbox_volumetric.xml:99-120): extinction
    sigma_t (scale for heterogeneous), single-scattering albedo, HG phase
    anisotropy g, plus an optional density grid (constant (1,1,1) for
    homogeneous media) with a world->[0,1]^3 affine and the delta/ratio
    tracking majorant (sigma_t * max density)."""

    sigma_t: jnp.ndarray  # (M,)
    albedo: jnp.ndarray  # (M, C)
    g: jnp.ndarray  # (M,)
    grid: jnp.ndarray  # (M, GZ, GY, GX) f32 density
    grid_w2l: jnp.ndarray  # (M, 3, 4) affine: local = A @ [p; 1]
    majorant: jnp.ndarray  # (M,)


class GeomParams(NamedTuple):
    """Per-shape rigid-motion deltas — the differentiable geometry surface.

    The reference exposes shape geometry to AD by running ``ray_intersect``
    attached (transientpath.py:148-151); here the equivalent is a per-shape
    delta transform (translate + axis-angle rotate about ``pivot``) applied
    to the gathered hit-triangle data inside :func:`ray_intersect`, with the
    hit distance re-derived from the (moved) triangle's plane equation.  The
    deltas are ZERO in SceneData; they exist so ``jax.grad`` w.r.t. them
    yields d(render)/d(shape pose) evaluated at the current pose.  To
    actually move a shape, use ``traverse(scene)['<key>.to_world.translate']
    = v; params.update()`` which re-bakes the soup host-side."""

    translate: jnp.ndarray  # (S, 3) — zeros
    rotate: jnp.ndarray  # (S, 3) axis-angle radians — zeros
    pivot: jnp.ndarray  # (S, 3) rotation pivot = shape to_world origin


class SceneData(NamedTuple):
    tri: Triangles
    bsdf: BSDFParams
    emitter: EmitterParams
    medium: MediumParams
    # Differentiable per-shape rigid deltas (None disables the attach path)
    geom: GeomParams | None = None


# --------------------------------------------------------------------------
# Device-side queries
# --------------------------------------------------------------------------

def _perturbed_normal(bp: BSDFParams, bsdf_id, ng, uv, e1, e2, uv_e1, uv_e2):
    """Bump/normal-mapped shading normal (Mitsuba bumpmap.cpp /
    normalmap.cpp semantics; staircase scene.xml BrushedAluminium).

    Tangents dp_du/dp_dv come from inverting the 2x2 uv-edge system of the
    hit triangle; the atlas lookup is one bilinear 4-tap gather because the
    height gradients were precomputed host-side in texel units."""
    idx = jnp.maximum(bsdf_id, 0)
    cols = columns_lookup(
        {
            "bump_id": bp.bump_id.astype(jnp.float32),
            "bump_hw": bp.bump_hw,
            "bump_uv": bp.bump_uv,
            "bump_scale": bp.bump_scale,
            "bump_kind": bp.bump_kind.astype(jnp.float32),
        },
        idx,
    )
    bid = jnp.round(cols["bump_id"]).astype(jnp.int32)
    perturbed = bid >= 0
    h = jnp.maximum(cols["bump_hw"][:, 0], 1.0)
    w = jnp.maximum(cols["bump_hw"][:, 1], 1.0)
    tuv = cols["bump_uv"]
    up = uv[:, 0] * tuv[:, 0] + tuv[:, 2]
    vp = uv[:, 1] * tuv[:, 1] + tuv[:, 3]
    up = up - jnp.floor(up)
    vp = vp - jnp.floor(vp)
    x = up * w - 0.5
    y = vp * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    nb, th, tw, _ = bp.bump_textures.shape
    flat = bp.bump_textures.reshape(nb * th * tw, 3)
    bidc = jnp.maximum(bid, 0)

    def tap(xi, yi):
        xi = jnp.mod(xi, w).astype(jnp.int32)
        yi = jnp.mod(yi, h).astype(jnp.int32)
        return jnp.take(flat, (bidc * th + yi) * tw + xi, axis=0)

    c00 = tap(x0, y0)
    c10 = tap(x0 + 1.0, y0)
    c01 = tap(x0, y0 + 1.0)
    c11 = tap(x0 + 1.0, y0 + 1.0)
    val = (c00 * (1.0 - fx) + c10 * fx) * (1.0 - fy) + (
        c01 * (1.0 - fx) + c11 * fx) * fy

    # uv-edge system -> world-space tangents
    u1, v1 = uv_e1[:, 0], uv_e1[:, 1]
    u2, v2 = uv_e2[:, 0], uv_e2[:, 1]
    det = u1 * v2 - v1 * u2
    ok_uv = jnp.abs(det) > 1e-12
    inv = safe_div(1.0, det)[:, None]
    dp_du = (v2[:, None] * e1 - v1[:, None] * e2) * inv
    dp_dv = (u1[:, None] * e2 - u2[:, None] * e1) * inv
    # project tangents into the surface plane (flat shading: sh n == ng)
    t_u = dp_du - ng * dot(ng, dp_du)[:, None]
    t_v = dp_dv - ng * dot(ng, dp_dv)[:, None]
    ok_uv = ok_uv & (dot(t_u, t_u) > 1e-16) & (dot(t_v, t_v) > 1e-16)

    is_normalmap = jnp.round(cols["bump_kind"]).astype(jnp.int32) == 2
    # bumpmap: chain texel-unit gradients through the uv transform and the
    # texture resolution to get dh/du, dh/dv, then tilt the tangents
    scale = cols["bump_scale"]
    dh_du = val[:, 1] * w * tuv[:, 0] * scale
    dh_dv = val[:, 2] * h * tuv[:, 1] * scale
    n_bump = jnp.cross(t_u + ng * dh_du[:, None], t_v + ng * dh_dv[:, None])
    # normalmap: tangent-space normal in an orthonormalized (t_u, b, ng)
    tang = normalize(t_u)
    bitang = jnp.cross(ng, tang)
    n_nm = (tang * val[:, 0:1] + bitang * val[:, 1:2] + ng * val[:, 2:3])
    n_new = jnp.where(is_normalmap[:, None], n_nm, n_bump)
    nn = dot(n_new, n_new)
    # orient with the geometric normal; fall back to ng on degeneracy
    n_new = normalize(
        jnp.where((nn > 1e-16)[:, None], n_new, ng))
    n_new = n_new * jnp.where(dot(n_new, ng) < 0.0, -1.0, 1.0)[:, None]
    return jnp.where((perturbed & ok_uv)[:, None], n_new, ng)


class GeomDelta(NamedTuple):
    """Per-lane rigid delta in Rodrigues *vector* form: a point moves as
    ``p + a w x (p - piv) + b w x (w x (p - piv)) + tr`` and a direction as
    the same without pivot/translation.  At zero deltas every term is
    EXACTLY zero (no pivot round-trip, no 3x3 matrices), so the attach
    changes no primal bit and costs two cross products per vector —
    elementwise math instead of batched tiny matmuls."""

    w: jnp.ndarray  # (N, 3) axis-angle
    a: jnp.ndarray  # (N,) sin(t)/t
    b: jnp.ndarray  # (N,) (1-cos t)/t^2
    tr: jnp.ndarray  # (N, 3)
    piv: jnp.ndarray  # (N, 3)

    def point(self, p: jnp.ndarray) -> jnp.ndarray:
        from ..core.math import cross

        q = p - self.piv
        c1 = cross(self.w, q)
        c2 = cross(self.w, c1)
        return p + self.a[:, None] * c1 + self.b[:, None] * c2 + self.tr

    def vector(self, v: jnp.ndarray) -> jnp.ndarray:
        from ..core.math import cross

        c1 = cross(self.w, v)
        c2 = cross(self.w, c1)
        return v + self.a[:, None] * c1 + self.b[:, None] * c2


def primal_sd(sd: "SceneData") -> "SceneData":
    """Strip the differentiable geometry deltas for PRIMAL rendering: the
    attach path in ray_intersect exists only so ``jax.grad`` can flow
    through hit points (full-AD backward); in a plain render it costs
    ~20% (per-bounce delta gather + plane-eq re-derivation) and changes no
    bit of output.  Differential drivers that differentiate through
    ray_intersect (integrators/fullad.py) keep ``sd.geom``."""
    return sd._replace(geom=None) if sd.geom is not None else sd


def geom_delta_of(geom: GeomParams, shape_ids: jnp.ndarray) -> GeomDelta:
    """Per-lane rigid delta for ``shape_ids`` (clamped)."""
    gcols = columns_lookup(
        {"tr": geom.translate, "rot": geom.rotate, "piv": geom.pivot},
        jnp.maximum(shape_ids, 0),
    )
    w = gcols["rot"]
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-12))
    small = theta2 < 1e-12
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0,
                  (1.0 - jnp.cos(theta)) / jnp.maximum(theta2, 1e-12))
    return GeomDelta(w=w, a=a, b=b, tr=gcols["tr"], piv=gcols["piv"])


def ray_intersect(sd: SceneData, ray: Ray, active: jnp.ndarray) -> SurfaceInteraction:
    """Closest hit + shading record.  Equivalent of ``mi.Scene.ray_intersect``
    — run *attached* like the reference's differential phase
    (``dr.resume_grad`` around ray_intersect, transientpath.py:148-151): the
    winning primitive is a detached discrete choice, but ``t`` is re-derived
    from the hit triangle's plane equation and every shading attribute from
    the (delta-transformed) triangle tables, so d(hit)/d(shape pose) and
    d(hit)/d(ray) flow under ``jax.grad``.

    The barycentrics are reconstructed from the hit point."""
    # The traversal produces a detached discrete choice (prim) and a raw
    # primal t; derivatives re-enter via the plane-equation attach below.
    # The query's INPUTS are detached: the GPU intersection kernel defines
    # no AD rule, and under jax.grad/jvp the ray origin/direction are
    # attached through sampled BSDF lobes (alpha).
    sg = jax.lax.stop_gradient
    t, prim = _closest_hit_q(
        sd.tri.v0, sd.tri.e1, sd.tri.e2, sg(ray.o), sg(ray.d), sg(ray.maxt),
        active,
    )
    return _si_from_t_prim(sd, ray, t, prim)


def _si_from_t_prim(sd: SceneData, ray: Ray, t, prim) -> SurfaceInteraction:
    """Shading-record construction from a traversal result (t, prim)."""
    valid = prim >= 0
    prim_c = jnp.maximum(prim, 0)
    cols = columns_lookup(
        {
            "v0": sd.tri.v0,
            "e1": sd.tri.e1,
            "e2": sd.tri.e2,
            "ng": sd.tri.ng,
            "uv0": sd.tri.uv0,
            "uv_e1": sd.tri.uv_e1,
            "uv_e2": sd.tri.uv_e2,
            "shape_id": sd.tri.shape_id.astype(jnp.float32),
            "bsdf_id": sd.tri.bsdf_id.astype(jnp.float32),
            "emitter_id": sd.tri.emitter_id.astype(jnp.float32),
        },
        prim_c,
    )
    ng = cols["ng"]
    if sd.geom is not None:
        sid = jnp.round(cols["shape_id"]).astype(jnp.int32)
        gd = geom_delta_of(sd.geom, sid)
        cols = dict(cols)
        cols["v0"] = gd.point(cols["v0"])
        cols["e1"] = gd.vector(cols["e1"])
        cols["e2"] = gd.vector(cols["e2"])
        ng = gd.vector(ng)
        # attached hit distance from the (moved) triangle's plane equation;
        # primal stays the traversal kernel's t bit-for-bit (replace_grad)
        denom = dot(ray.d, ng)
        ok_den = jnp.abs(denom) > 1e-12
        t_plane = dot(cols["v0"] - ray.o, ng) / jnp.where(ok_den, denom, 1.0)
        # miss lanes carry t = inf; keep them out of the replace-grad
        # arithmetic (inf - inf = NaN would poison debug_nans and any
        # reduction that touches raw t)
        t_fin = jnp.where(valid, t, 0.0)
        t_att = jnp.where(ok_den & valid, t_plane,
                          jax.lax.stop_gradient(t_fin))
        t = jnp.where(valid, t_att + jax.lax.stop_gradient(t_fin - t_att),
                      t)
    p = ray.o + ray.d * jnp.where(valid, t, 0.0)[:, None]
    # Barycentrics of p in the winning triangle (projection method).
    w = p - cols["v0"]
    e1, e2 = cols["e1"], cols["e2"]
    d00 = dot(e1, e1)
    d01 = dot(e1, e2)
    d11 = dot(e2, e2)
    d20 = dot(w, e1)
    d21 = dot(w, e2)
    denom = d00 * d11 - d01 * d01
    inv = safe_div(1.0, denom)
    u = (d11 * d20 - d01 * d21) * inv
    v = (d00 * d21 - d01 * d20) * inv
    uv = cols["uv0"] + cols["uv_e1"] * u[:, None] + cols["uv_e2"] * v[:, None]
    # Shading normal == geometric normal (flat shading); orient the *shading
    # frame* toward the incident side like Mitsuba does for two-sided BSDFs at
    # the BSDF level, but keep ng fixed for consistent emitter sidedness.
    bsdf_id_f = cols["bsdf_id"]
    n_sh = ng
    if sd.bsdf.bump_textures is not None:
        n_sh = _perturbed_normal(
            sd.bsdf, jnp.round(bsdf_id_f).astype(jnp.int32), ng, uv,
            cols["e1"], cols["e2"], cols["uv_e1"], cols["uv_e2"])
    frame = Frame.from_normal(n_sh)
    wi = frame.to_local(-ray.d)

    def _id(name):
        i = jnp.round(cols[name]).astype(jnp.int32)
        return jnp.where(valid, i, -1)

    return SurfaceInteraction(
        valid=valid,
        t=jnp.where(valid, t, jnp.inf),
        p=p,
        n=ng,
        frame=frame,
        uv=uv,
        wi=wi,
        prim=jnp.where(valid, prim, -1),
        shape_id=_id("shape_id"),
        bsdf_id=_id("bsdf_id"),
        emitter_id=_id("emitter_id"),
    )


def ray_test(sd: SceneData, o: jnp.ndarray, d_unit: jnp.ndarray, dist: jnp.ndarray,
             active: jnp.ndarray) -> jnp.ndarray:
    """Occlusion query between ``o`` and ``o + d_unit * dist`` (shadow ray),
    with epsilon shortening at both ends; cf. ``mi.Scene.ray_test``.

    Visibility is a detached binary decision (the reference likewise never
    differentiates ray_test); detaching the inputs also lets the GPU
    any-hit kernel (no AD rule) sit under jax.grad/jvp."""
    sg = jax.lax.stop_gradient
    maxt = dist * (1.0 - 1e-3)
    return _ray_test_q(sd.tri.v0, sd.tri.e1, sd.tri.e2, sg(o), sg(d_unit),
                       sg(maxt), active)


# ---- emitters -------------------------------------------------------------

def _sample_emitter_triangle(sd: SceneData, em_idx: jnp.ndarray, u: jnp.ndarray):
    """Pick a triangle of emitter ``em_idx`` area-proportionally via the
    per-emitter CDF segment; returns (soup tri index, rescaled u).

    Design: the inverse-CDF search is a vectorized compare-and-count over
    the (small) flattened emitter-triangle table — branchless, gather-free —
    rather than a binary search (cf. mi.DiscreteDistribution used at
    transientnlospath.py:277-292)."""
    start = sd.emitter.tri_start[em_idx]
    count = sd.emitter.tri_count[em_idx]
    K = sd.emitter.em_tri_cdf.shape[0]
    k = jnp.arange(K, dtype=jnp.int32)[None, :]
    in_seg = (k >= start[:, None]) & (k < (start + count)[:, None])
    below = in_seg & (u[:, None] > sd.emitter.em_tri_cdf[None, :])
    slot = start + jnp.sum(below.astype(jnp.int32), axis=1)
    slot = jnp.clip(slot, start, start + count - 1)
    cols = columns_lookup(
        {
            "tri": sd.emitter.em_tri_idx.astype(jnp.float32),
            "cdf": sd.emitter.em_tri_cdf,
            "cdf_prev": jnp.concatenate(
                [jnp.zeros((1,), jnp.float32), sd.emitter.em_tri_cdf[:-1]]
            ),
        },
        slot,
    )
    tri = jnp.round(cols["tri"]).astype(jnp.int32)
    cdf_lo = jnp.where(slot > start, cols["cdf_prev"], 0.0)
    pmf = jnp.maximum(cols["cdf"] - cdf_lo, 1e-30)
    u2 = jnp.clip((u - cdf_lo) / pmf, 0.0, 1.0 - 1e-7)
    return tri, u2, slot


def _uniform_triangle_point(sd: SceneData, tri: jnp.ndarray,
                            slot: jnp.ndarray, u1: jnp.ndarray,
                            u2: jnp.ndarray):
    """Uniform barycentric sample of emitter-triangle ``slot`` (soup index
    ``tri``).  Gathers from the compact (K-row) per-emitter table when the
    scene compiled one, else from the full soup."""
    su = jnp.sqrt(jnp.maximum(u1, 0.0))
    b1 = 1.0 - su
    b2 = u2 * su
    em = sd.emitter
    if em.em_tri_v0 is not None:
        cols = columns_lookup(
            {"v0": em.em_tri_v0, "e1": em.em_tri_e1, "e2": em.em_tri_e2,
             "ng": em.em_tri_ng},
            slot,
        )
    else:
        cols = columns_lookup(
            {"v0": sd.tri.v0, "e1": sd.tri.e1, "e2": sd.tri.e2,
             "ng": sd.tri.ng},
            tri,
        )
    p = cols["v0"] + cols["e1"] * b1[:, None] + cols["e2"] * b2[:, None]
    ng = cols["ng"]
    if sd.geom is not None and em.em_tri_shape is not None:
        # route the sampled emitter point through its shape's rigid delta so
        # d(NEE)/d(emitter pose) flows (the reference gets the analogue via
        # attached si when paths HIT the emitter; NEE-side attachment makes
        # the light-transport gradient of a moving light exact)
        scols = columns_lookup(
            {"sid": em.em_tri_shape.astype(jnp.float32)}, slot)
        sid = jnp.round(scols["sid"]).astype(jnp.int32)
        gd = geom_delta_of(sd.geom, sid)
        p = gd.point(p)
        ng = gd.vector(ng)
    return p, ng


def sample_emitter_direction(
    sd: SceneData,
    ref_p: jnp.ndarray,
    sample2: jnp.ndarray,
    test_visibility: bool,
    active: jnp.ndarray,
):
    """Next-event estimation sample; mirror of
    ``mi.Scene.sample_emitter_direction`` (transientpath.py:192).

    Returns (DirectionSample, em_weight (N, C)).  ``em_weight`` =
    emitter_radiance / pdf with visibility applied; pdf includes the uniform
    1/E emitter-selection probability.
    """
    E = sd.emitter.kind.shape[0]
    n = ref_p.shape[0]
    if E == 0:
        zero = jnp.zeros((n,), jnp.float32)
        ds = DirectionSample(
            p=jnp.zeros((n, 3)), n=jnp.zeros((n, 3)), d=jnp.zeros((n, 3)),
            dist=zero, pdf=zero, delta=jnp.zeros((n,), bool),
            emitter_id=jnp.full((n,), -1, jnp.int32),
        )
        return ds, jnp.zeros((n, sd.emitter.radiance.shape[-1]))

    ks = sd.emitter.ks
    has_delta = ks.has(EM_PROJECTOR) or ks.has(EM_POINT)
    has_shape = ks.has(EM_AREA) or ks.has(EM_ANGULAR_AREA)

    u_sel = sample2[:, 0]
    em_idx = jnp.minimum((u_sel * E).astype(jnp.int32), E - 1)
    u0 = jnp.clip(u_sel * E - em_idx.astype(jnp.float32), 0.0, 1.0 - 1e-7)
    sel_pdf = 1.0 / E

    ecols = columns_lookup(
        {
            "kind": sd.emitter.kind.astype(jnp.float32),
            "position": sd.emitter.position,
            "direction": sd.emitter.direction,
            "area": sd.emitter.area,
        },
        em_idx,
    )
    kind = jnp.round(ecols["kind"]).astype(jnp.int32)
    is_delta = ((kind == EM_PROJECTOR) | (kind == EM_POINT) if has_delta
                else jnp.zeros((n,), bool))

    if has_shape:
        # --- area-like emitters: sample a point on the shape ---------------
        tri, u0b, slot = _sample_emitter_triangle(sd, em_idx, u0)
        p_area, n_area = _uniform_triangle_point(sd, tri, slot, u0b,
                                                 sample2[:, 1])
    area = jnp.maximum(ecols["area"], 1e-30)

    # --- delta emitters: fixed position ------------------------------------
    if has_delta and has_shape:
        p = jnp.where(is_delta[:, None], ecols["position"], p_area)
        n_em = jnp.where(is_delta[:, None], -ecols["direction"], n_area)
    elif has_delta:
        p, n_em = ecols["position"], -ecols["direction"]
    else:
        p, n_em = p_area, n_area

    d_vec = p - ref_p
    dist = jnp.sqrt(jnp.maximum(jnp.sum(d_vec * d_vec, axis=-1), 1e-20))
    d = d_vec / dist[:, None]

    cos_em = dot(n_em, -d)

    # pdf (solid angle at ref): area emitters dist^2/(cos*A); delta: 1
    if has_shape:
        pdf_area_sa = safe_div(dist * dist, jnp.maximum(cos_em, 0.0) * area)
        pdf = (jnp.where(is_delta, 1.0, pdf_area_sa) if has_delta
               else pdf_area_sa) * sel_pdf
    else:
        pdf = jnp.full((n,), sel_pdf, jnp.float32)

    # emitted radiance toward ref
    spec = emitter_eval_direction(sd, em_idx, p, n_em, d, dist, cos_em)

    valid = active & (pdf > 0.0) & (jnp.sum(jnp.abs(spec), axis=-1) > 0.0)
    if test_visibility:
        o = ref_p + d * 1e-4  # offset along connection dir
        occluded = ray_test(sd, o, d, dist - 2e-4, valid)
        valid = valid & ~occluded

    weight = jnp.where(valid[:, None], safe_div(spec, pdf[:, None]), 0.0)
    ds = DirectionSample(
        p=p, n=n_em, d=d, dist=dist,
        pdf=jnp.where(valid, pdf, 0.0),
        delta=is_delta,
        emitter_id=jnp.where(valid, em_idx, -1),
    )
    return ds, weight


def emitter_eval_direction(sd: SceneData, em_idx, p, n_em, d, dist, cos_em):
    """Radiance leaving emitter point ``p`` toward ``-d``... i.e. toward the
    reference point (direction of travel is ``-d`` from the emitter's view).
    For projector/point emitters this returns intensity/dist^2.  Branches
    for statically-absent emitter kinds are pruned at trace time."""
    ks = sd.emitter.ks
    has_area = ks.has(EM_AREA)
    has_ang = ks.has(EM_ANGULAR_AREA)
    has_proj = ks.has(EM_PROJECTOR)
    has_point = ks.has(EM_POINT)

    cols = {
        "kind": sd.emitter.kind.astype(jnp.float32),
        "radiance": sd.emitter.radiance,
    }
    if has_ang:
        cols["cos_beam"] = sd.emitter.cos_beam
        cols["cos_cutoff"] = sd.emitter.cos_cutoff
    if has_proj:
        cols["direction"] = sd.emitter.direction
        cols["frame_s"] = sd.emitter.frame_s
        cols["frame_t"] = sd.emitter.frame_t
        cols["tan_half_fov"] = sd.emitter.tan_half_fov
    ecols = columns_lookup(cols, em_idx)
    kind = jnp.round(ecols["kind"]).astype(jnp.int32)
    rad = ecols["radiance"]
    front = cos_em > 0.0

    branches = []  # (mask, value)
    if has_area:
        # area: constant radiance from the front side
        branches.append((kind == EM_AREA, jnp.where(front[:, None], rad, 0.0)))

    if has_ang:
        # angulararea: radiance * falloff(angle between -d and emitter normal)
        # (reference mitransient/emitters/angulararea.py:74-102: full radiance
        # within beam_width, linear falloff to cutoff_angle, zero outside).
        cos_ang = cos_em  # angle between emission dir (-d) and normal
        cb = ecols["cos_beam"]
        cc = ecols["cos_cutoff"]
        t_lin = safe_div(cos_ang - cc, jnp.maximum(cb - cc, 1e-9))
        falloff = jnp.clip(t_lin, 0.0, 1.0)
        branches.append(
            (kind == EM_ANGULAR_AREA,
             jnp.where(front[:, None], rad * falloff[:, None], 0.0)))

    inv_d2 = None
    if has_proj or has_point:
        inv_d2 = 1.0 / jnp.maximum(dist * dist, 1e-20)
    if has_proj:
        # projector: inside frustum -> irradiance / dist^2
        dirn = ecols["direction"]
        fs = ecols["frame_s"]
        ft = ecols["frame_t"]
        # direction from projector position to ref point:
        v = -d
        z = dot(v, dirn)
        x = dot(v, fs)
        y = dot(v, ft)
        thf = ecols["tan_half_fov"]
        inside = (z > 0) & (jnp.abs(x) <= z * thf) & (jnp.abs(y) <= z * thf)
        branches.append(
            (kind == EM_PROJECTOR,
             jnp.where(inside[:, None], rad, 0.0) * inv_d2[:, None]))
    if has_point:
        # point: isotropic intensity / dist^2
        branches.append((kind == EM_POINT, rad * inv_d2[:, None]))

    if len(branches) == 1:
        return branches[0][1]
    val = jnp.zeros_like(rad)
    for mask, v_k in branches:
        val = jnp.where(mask[:, None], v_k, val)
    return val


def pdf_emitter_direction(sd: SceneData, ref_p: jnp.ndarray,
                          si: SurfaceInteraction) -> jnp.ndarray:
    """Solid-angle pdf of NEE having sampled the direction that hit ``si``
    (for MIS at emitter hits, transientpath.py:168-171).  Zero for
    non-emitter hits, back faces and delta emitters."""
    E = sd.emitter.kind.shape[0]
    ks = sd.emitter.ks
    has_shape = ks.has(EM_AREA) or ks.has(EM_ANGULAR_AREA)
    only_shape = not (ks.has(EM_PROJECTOR) or ks.has(EM_POINT))
    if E == 0 or not has_shape:
        return jnp.zeros(ref_p.shape[:-1], jnp.float32)
    em = si.emitter_id
    has_em = em >= 0
    em_c = jnp.maximum(em, 0)
    cols = {"area": sd.emitter.area}
    if not only_shape:
        cols["kind"] = sd.emitter.kind.astype(jnp.float32)
    ecols = columns_lookup(cols, em_c)
    if only_shape:
        area_like = jnp.ones_like(has_em)
    else:
        kind = jnp.round(ecols["kind"]).astype(jnp.int32)
        area_like = (kind == EM_AREA) | (kind == EM_ANGULAR_AREA)
    d_vec = si.p - ref_p
    dist2 = jnp.sum(d_vec * d_vec, axis=-1)
    dist = jnp.sqrt(jnp.maximum(dist2, 1e-20))
    d = d_vec / dist[:, None]
    cos_em = dot(si.n, -d)
    area = jnp.maximum(ecols["area"], 1e-30)
    pdf = safe_div(dist2, jnp.maximum(cos_em, 0.0) * area) / E
    return jnp.where(has_em & area_like & (cos_em > 0.0), pdf, 0.0)


def emitter_eval_hit(sd: SceneData, si: SurfaceInteraction,
                     ray_d: jnp.ndarray) -> jnp.ndarray:
    """Radiance emitted at a surface hit toward the viewer
    (``ds.emitter.eval(si)`` in transientpath.py:176).  (N, C)."""
    E = sd.emitter.kind.shape[0]
    C = sd.emitter.radiance.shape[-1] if E else sd.bsdf.reflectance.shape[-1]
    n = si.t.shape[0]
    if E == 0:
        return jnp.zeros((n, C), jnp.float32)
    em = si.emitter_id
    has_em = em >= 0
    em_c = jnp.maximum(em, 0)
    cos_em = dot(si.n, -ray_d)
    val = emitter_eval_direction(
        sd, em_c, si.p, si.n, -(-ray_d), jnp.ones_like(cos_em), cos_em
    )
    # emitter_eval_direction's projector/point branches are meaningless here
    # (delta emitters are never hit); area/angular branches only use cos_em.
    ks = sd.emitter.ks
    if ks.has(EM_PROJECTOR) or ks.has(EM_POINT):
        kind = jnp.round(
            columns_lookup(
                {"kind": sd.emitter.kind.astype(jnp.float32)}, em_c
            )["kind"]
        ).astype(jnp.int32)
        val = jnp.where(
            ((kind == EM_PROJECTOR) | (kind == EM_POINT))[:, None], 0.0, val)
    return jnp.where(has_em[:, None], val, 0.0)
