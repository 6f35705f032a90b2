"""Transient NLOS path tracer (``transient_nlos_path`` parity).

JAX re-design of the reference's NLOS-specialized integrator
(/root/reference/mitransient/integrators/transientnlospath.py, [Royo2022]):
same estimator — relay-wall capture with laser sampling (two-segment NEE
through the illuminated wall point) and area-proportional hidden-geometry
direction sampling — expressed as a dense masked wavefront under ``jit``.

Key correspondences (reference line -> here):
* ``prepare``: single-emitter check, hidden-geometry area distribution,
  pixel-center sensor targets on the relay wall, laser target from the
  projector axis                                     (:251-383)
* laser sampling = sample the illuminated wall point, convert its area
  measure to solid angle (d^2/cos), then NEE to the laser (:511-635)
* hidden-geometry sampling: area-weighted point on hidden shapes ->
  direction sample with pdf = p_A * d^2 / cos_g      (:385-430, :637-670)
* optional 50/50 RR mix of HG and BSDF sampling      (:797-827)
* ``account_first_and_last_bounces`` excludes the sensor->wall and
  wall->laser segments from the OPL                  (:751-752, :496-498)
* ``filter_depth`` / ``discard_direct_paths`` gate NEE contributions
  (:489-492); laser-sampled NEE sees depth+2 (two extra path vertices)
* distance starts at ``ray.time``                    (:718)

Sampler-dimension budget per bounce (replay-stable): NEE 2, HG-RR 1,
HG 3, BSDF 3, RR 1 -> 10 dims at ``base + it * 10``.
"""
from __future__ import annotations

from functools import partial as _partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..bsdf import api as bsdf_api
from ..core import spectra as _sp
from ..core.mueller import mueller_product
from ..core.math import dot, mis_weight, normalize
from ..core.records import Ray
from ..core.rng import Sampler
from ..film.transient_film import (
    TransientFilmState,
    develop,
    film_init,
    splat_steady,
    splat_transient_pair,
)
from ..ops.gather import columns_lookup
from ..scene.scene import (
    EM_PROJECTOR,
    SceneData,
    emitter_eval_direction,
    emitter_eval_hit,
    pdf_emitter_direction,
    ray_intersect,
    ray_test,
)
from ..scene.schema import FilmConfig, IntegratorConfig, Scene, SensorConfig
from ..scene.shapes import Rectangle

NLOS_DIMS_PER_BOUNCE = 10


def _spec_tools(lb):
    """Mono-squeeze adapters keyed on the gathered table rank (see
    integrators/path_regen.py "Mono squeeze": C == 1 spectral state runs
    as (N,) so elementwise chains keep full VPU lane occupancy).

    Returns (spec1, sl, pk): whether tables are squeezed, the per-lane
    scalar lift, and the film-layout pack."""
    spec1 = lb.reflectance.ndim == 1

    def sl(x):
        return x if spec1 else x[:, None]

    def pk(parts):
        if len(parts) == 1:
            return parts[0][:, None] if spec1 else parts[0]
        return (jnp.stack(parts, -1) if spec1
                else jnp.concatenate(parts, axis=-1))

    return spec1, sl, pk


def _squeeze_lb(lb):
    """Squeeze a gathered BSDF table's spectral columns to (N,)."""
    return lb._replace(reflectance=lb.reflectance[:, 0],
                       eta_re=lb.eta_re[:, 0], eta_im=lb.eta_im[:, 0])


def _sctx_film(sctx, v, polarized: bool):
    """Spectral splat conversion: per-Stokes-row sRGB when polarized."""
    return sctx.to_film_stokes(v) if polarized else sctx.to_film(v)


def can_skip_le(sd: SceneData) -> bool:
    """True when every emitter is delta (projector/point) so the Le term is
    identically zero and its film event can be elided.  Uses the STATIC
    kind set when available (no device->host sync); falls back to a host
    read."""
    from ..scene.scene import EM_POINT

    ks = sd.emitter.ks
    if ks.kinds:
        return all(k in (EM_PROJECTOR, EM_POINT) for k in ks.kinds)
    import numpy as _np

    kinds = _np.asarray(sd.emitter.kind)
    return kinds.size > 0 and bool(
        _np.all((kinds == EM_PROJECTOR) | (kinds == EM_POINT)))


class NLOSContext(NamedTuple):
    """Device-side precomputed NLOS capture state (the output of the
    reference's ``prepare``, transientnlospath.py:251-383)."""

    sensor_origin: jnp.ndarray  # (3,)
    sensor_targets: jnp.ndarray  # (HW, 3) pixel-center points on the wall
    laser_target: jnp.ndarray  # (3,) illuminated wall point (single/confocal)
    emitter_idx: jnp.ndarray  # () int32 — the single (projector) emitter
    # hidden-geometry sampling tables (triangle-level; equivalent to the
    # reference's shape-level DiscreteDistribution + in-shape sampling)
    hg_tri_idx: jnp.ndarray  # (K,) int32 soup triangle ids
    hg_tri_cdf: jnp.ndarray  # (K,) float32
    hg_total_area: jnp.ndarray  # ()
    # Hoisted wall-vertex constants for laser NEE.  The reference re-traces
    # a full ray to land on the illuminated wall point for EVERY path vertex
    # (transientnlospath.py:537-539) and then NEEs wall->laser; but with a
    # single laser target both the wall interaction and the wall->laser
    # segment are per-scene constants — precomputing them removes one
    # closest-hit, one any-hit and one BSDF-table gather per bounce.
    wall_ng: jnp.ndarray  # (3,) geometric normal at laser_target
    wall_n_sh: jnp.ndarray  # (3,) shading normal (incl. bump perturbation)
    wall_uv: jnp.ndarray  # (2,)
    wall_bsdf_id: jnp.ndarray  # () int32
    wall_em: jnp.ndarray  # (C,) emitter radiance term of the wall->laser NEE
    wall_dist2: jnp.ndarray  # () wall->laser distance
    wall_d2: jnp.ndarray  # (3,) unit direction wall->laser
    wall_clear: jnp.ndarray  # () bool: wall->laser segment unoccluded


def prepare_nlos(scene: Scene, sensor_cfg: SensorConfig) -> NLOSContext:
    """Host+device precompute mirroring transientnlospath.py:251-383."""
    sd = scene.data
    icfg = scene.integrator
    E = int(sd.emitter.kind.shape[0])
    if E != 1:
        raise ValueError(
            f"NLOS scenes must have exactly 1 emitter, got {E} "
            "(transientnlospath.py:256-260)")

    sx, sy = (sensor_cfg.film.width, sensor_cfg.film.height)
    if sensor_cfg.kind == "perspective":
        # NLOS through a perspective sensor (the XML scenes' setup,
        # nlos-z-simple.xml:4-28): scan targets = pixel-center camera rays
        # intersected with the scene (transientnlospath.py:294-312)
        from ..sensors.perspective import build_camera
        from ..core.rng import Sampler as _S

        cam = build_camera(sensor_cfg)
        px, py = np.meshgrid(np.arange(sx), np.arange(sy))
        u = (px.ravel() + 0.5) / sx
        v = (py.ravel() + 0.5) / sy
        d_cam = np.stack([
            (1.0 - 2.0 * u) * float(cam.tan_half[0]),
            (1.0 - 2.0 * v) * float(cam.tan_half[1]),
            np.ones_like(u),
        ], axis=-1)
        R = np.asarray(cam.R)
        d_world = d_cam @ R.T
        d_world /= np.linalg.norm(d_world, axis=-1, keepdims=True)
        origin = np.asarray(cam.origin)
        from ..ops.intersect import intersect_soup

        n_scan = d_world.shape[0]
        o_arr = jnp.asarray(np.broadcast_to(origin, (n_scan, 3)).copy(),
                            jnp.float32)
        t, prim, _u2, _v2 = intersect_soup(
            sd.tri.v0, sd.tri.e1, sd.tri.e2, o_arr,
            jnp.asarray(d_world, jnp.float32),
            jnp.full((n_scan,), jnp.inf), jnp.ones((n_scan,), bool))
        t_np = np.asarray(t)
        prim_np = np.asarray(prim)
        if not np.any(prim_np >= 0):
            raise ValueError("The sensor did not intersect any geometry "
                             "(transientnlospath.py:314-317)")
        t_np = np.where(np.isfinite(t_np), t_np, 0.0)
        targets = (origin + d_world * t_np[:, None]).astype(np.float32)
        sensor_origin = origin.astype(np.float32)
        # relay wall = shape hit by the central scan ray (for HG exclusion)
        center_prim = int(prim_np[(sy // 2) * sx + sx // 2])
        wall_shape_index = (
            int(np.asarray(sd.tri.shape_id)[center_prim])
            if center_prim >= 0 else -1)
    else:
        wall_shape = scene.shapes[sensor_cfg.shape_index]
        if not isinstance(wall_shape, Rectangle):
            raise TypeError(
                "nlos_capture_meter must be attached to a rectangle")
        # film-sized scan grid at pixel centers (nloscapturemeter.py:149-151)
        px, py = np.meshgrid(np.arange(sx), np.arange(sy))
        uv = np.stack([(px.ravel() + 0.5) / sx, (py.ravel() + 0.5) / sy], -1)
        targets = wall_shape.position_from_uv(uv).astype(np.float32)
        sensor_origin = np.asarray(sensor_cfg.sensor_origin, np.float32)
        wall_shape_index = sensor_cfg.shape_index
    if sensor_cfg.is_confocal:
        # confocal: the (1x1) film's sensor ray aims at the focused laser
        # point itself (nloscapturemeter.py:110-123,143-145)
        if not scene.laser_focused:
            raise ValueError(
                "confocal capture requires focusing the laser first "
                "(mitransient_tpu.nlos.focus_emitter_at_relay_wall_*)")
        targets = np.asarray(scene.laser_target, np.float32).reshape(1, 3)

    # laser target: focus helpers set scene.laser_target; otherwise intersect
    # the projector axis with the scene (transientnlospath.py:328-336)
    if scene.laser_focused:
        laser_target = np.asarray(scene.laser_target, np.float32)
    else:
        o = np.asarray(sd.emitter.position[0]).reshape(1, 3)
        d = np.asarray(sd.emitter.direction[0]).reshape(1, 3)
        from ..ops.intersect import intersect_soup

        t, prim, _u, _v = intersect_soup(
            sd.tri.v0, sd.tri.e1, sd.tri.e2,
            jnp.asarray(o), jnp.asarray(d),
            jnp.full((1,), jnp.inf), jnp.ones((1,), bool),
        )
        if int(prim[0]) < 0:
            raise ValueError("The emitter is not pointing at the scene! "
                             "(transientnlospath.py:334)")
        laser_target = np.asarray(o[0] + d[0] * float(t[0]), np.float32)

    # hidden-geometry triangle tables
    areas = np.asarray(sd.tri.area)
    shape_ids = np.asarray(sd.tri.shape_id)
    include_wall = icfg.nlos_hidden_geometry_sampling_includes_relay_wall
    mask = np.ones_like(areas, bool)
    if not include_wall:
        mask &= shape_ids != wall_shape_index
    hg_idx = np.nonzero(mask)[0].astype(np.int32)
    hg_areas = areas[hg_idx]
    total = float(hg_areas.sum())
    if icfg.nlos_hidden_geometry_sampling and (len(hg_idx) == 0 or total <= 0):
        raise ValueError("Hidden geometry sampling is activated, but there "
                         "is no hidden geometry (transientnlospath.py:284-289)")
    if len(hg_idx) == 0:
        hg_idx = np.zeros(1, np.int32)
        hg_areas = np.ones(1, np.float32)
        total = 1.0
    cdf = np.cumsum(hg_areas / total).astype(np.float32)

    # ---- hoisted wall-vertex constants (see NLOSContext docstring) -------
    epos = np.asarray(sd.emitter.position[0], np.float32)
    to_wall = np.asarray(laser_target, np.float32) - epos
    dist_ew = float(np.linalg.norm(to_wall))
    d_ew = to_wall / max(dist_ew, 1e-12)
    si_w = ray_intersect(
        sd, Ray.make(jnp.asarray(epos).reshape(1, 3),
                     jnp.asarray(d_ew).reshape(1, 3)),
        jnp.ones((1,), bool))
    if not bool(si_w.valid[0]):
        raise ValueError("The emitter is not pointing at the scene! "
                         "(transientnlospath.py:334)")
    # wall -> laser return segment (constant): direction, distance,
    # occlusion, and the emitter radiance term of the NEE
    d2 = -d_ew
    dist2 = dist_ew
    occ2 = ray_test(
        sd,
        jnp.asarray(laser_target).reshape(1, 3) + jnp.asarray(d2).reshape(
            1, 3) * 1e-4,
        jnp.asarray(d2).reshape(1, 3),
        jnp.full((1,), dist2 - 2e-4), jnp.ones((1,), bool))
    cos_em = float(np.dot(-d2, np.asarray(sd.emitter.direction[0])))
    em_val = emitter_eval_direction(
        sd, jnp.zeros((1,), jnp.int32), jnp.asarray(epos).reshape(1, 3),
        -jnp.asarray(sd.emitter.direction[0]).reshape(1, 3),
        jnp.asarray(d2).reshape(1, 3), jnp.full((1,), dist2),
        jnp.full((1,), cos_em))

    return NLOSContext(
        wall_ng=si_w.n[0],
        wall_n_sh=si_w.frame.n[0],
        wall_uv=si_w.uv[0],
        wall_bsdf_id=si_w.bsdf_id[0],
        wall_em=em_val[0],
        wall_dist2=jnp.float32(dist2),
        wall_d2=jnp.asarray(d2, jnp.float32),
        wall_clear=~occ2[0],
        sensor_origin=jnp.asarray(sensor_origin),
        sensor_targets=jnp.asarray(targets),
        laser_target=jnp.asarray(laser_target),
        emitter_idx=jnp.int32(0),
        hg_tri_idx=jnp.asarray(hg_idx),
        hg_tri_cdf=jnp.asarray(cdf),
        hg_total_area=jnp.float32(total),
    )


def prepare_nlos_cached(scene: Scene, sensor_cfg: SensorConfig,
                        sensor: int = 0) -> NLOSContext:
    """Per-scene memoized :func:`prepare_nlos`.

    prepare_nlos runs ~6 host<->device round trips (tiny intersects +
    np.asarray syncs), a FIXED per-render cost.  The context only depends on the laser focus, the sensor config and the integrator
    config — all hashable — so repeat renders reuse it; params.update()
    re-bakes (_compile) invalidate the cache."""
    import numpy as _np

    key = (
        sensor,
        bool(scene.laser_focused),
        tuple(_np.asarray(scene.laser_target).ravel().tolist()),
        sensor_cfg,
        scene.integrator,
    )
    cache = getattr(scene, "_nlos_ctx_cache", None)
    if cache is not None and cache[0] == key:
        return cache[1]
    ctx = prepare_nlos(scene, sensor_cfg)
    scene._nlos_ctx_cache = (key, ctx)
    return ctx


def sample_nlos_rays(ctx: NLOSContext, spp: int, hw: int):
    """NLOS sensor ray generation (nloscapturemeter.py:136-180): rays from
    ``sensor_origin`` toward the pixel-center wall points; spp-major lanes;
    deterministic (all spp of a pixel share the target)."""
    targets = jnp.tile(ctx.sensor_targets, (spp, 1))  # (N, 3)
    o = jnp.broadcast_to(ctx.sensor_origin, targets.shape)
    d = normalize(targets - o)
    n = spp * hw
    return Ray.make(o, d), jnp.ones((n,), jnp.float32)


def _sample_hidden_point(sd: SceneData, ctx: NLOSContext, u0, u1):
    """Area-proportional point on the hidden geometry
    (transientnlospath.py:385-430): pdf = 1/total_area."""
    K = ctx.hg_tri_cdf.shape[0]
    below = u0[:, None] > ctx.hg_tri_cdf[None, :]
    slot = jnp.minimum(jnp.sum(below.astype(jnp.int32), axis=1), K - 1)
    cols = columns_lookup(
        {"tri": ctx.hg_tri_idx.astype(jnp.float32),
         "cdf": ctx.hg_tri_cdf,
         "cdf_prev": jnp.concatenate(
             [jnp.zeros((1,), jnp.float32), ctx.hg_tri_cdf[:-1]])},
        slot,
    )
    tri = jnp.round(cols["tri"]).astype(jnp.int32)
    pmf = jnp.maximum(cols["cdf"] - jnp.where(slot > 0, cols["cdf_prev"], 0.0),
                      1e-30)
    u0b = jnp.clip((u0 - jnp.where(slot > 0, cols["cdf_prev"], 0.0)) / pmf,
                   0.0, 1.0 - 1e-7)
    tcols = columns_lookup(
        {"v0": sd.tri.v0, "e1": sd.tri.e1, "e2": sd.tri.e2, "ng": sd.tri.ng},
        tri,
    )
    su = jnp.sqrt(jnp.maximum(u0b, 0.0))
    b1 = 1.0 - su
    b2 = u1 * su
    p = tcols["v0"] + tcols["e1"] * b1[:, None] + tcols["e2"] * b2[:, None]
    pdf_area = 1.0 / jnp.maximum(ctx.hg_total_area, 1e-30)
    return p, tcols["ng"], jnp.broadcast_to(pdf_area, u0.shape)


def _laser_nee(sd, ctx, icfg, si, lb, beta, distance, eta, it_depth, active_e,
               account_last: bool, wi_world=None, polarized: bool = False,
               sctx=None, lanes=None):
    """Two-segment laser NEE (emitter_laser_sample path,
    transientnlospath.py:511-635, single/confocal): returns
    (Lr_dir (N, C) — or (N, 4C) Stokes when polarized, splat_distance (N,)).

    Redesign: the reference re-traces a ray to land on the wall point
    and re-runs a full NEE from there for every lane (:537-551); here the
    wall interaction and the wall->laser segment are per-scene constants
    hoisted into ``ctx`` by ``prepare_nlos`` — per bounce this only traces
    the vertex->wall occlusion ray.

    ``lanes``: optional PER-LANE laser constants (:class:`ExhaustiveLaser`
    rows, one per wavefront lane) for the batched confocal scan — every
    lane then connects to its own focused wall point; when ``None`` the
    whole wavefront shares ``ctx``'s single laser.  All variants
    (polarized/spectral) ride the same code path either way.

    ``wi_world``: world direction the path arrived along (for the Mueller
    rotation chain); ``beta`` is the SoA Mueller tuple in polarized mode."""
    from ..core.frame import Frame

    n = si.t.shape[0]
    per_lane = lanes is not None
    # segment 1: path vertex -> illuminated wall point
    lt = (lanes.laser_target if per_lane
          else jnp.broadcast_to(ctx.laser_target, si.p.shape))
    wall_clear = lanes.wall_clear if per_lane else ctx.wall_clear
    wall_ng = (lanes.wall_ng if per_lane
               else jnp.broadcast_to(ctx.wall_ng, si.p.shape))
    wall_d2 = (lanes.wall_d2 if per_lane
               else jnp.broadcast_to(ctx.wall_d2, (n, 3)))
    wall_dist2 = lanes.wall_dist2 if per_lane else ctx.wall_dist2
    d1v = lt - si.p
    dist1 = jnp.sqrt(jnp.maximum(jnp.sum(d1v * d1v, axis=-1), 1e-20))
    d1 = d1v / dist1[:, None]
    occ1 = ray_test(sd, si.p + d1 * 1e-4, d1, dist1 - 2e-4, active_e)
    active_e = active_e & ~occ1 & wall_clear
    wo1 = si.frame.to_local(d1)
    spec1, sl, pk = _spec_tools(lb)
    f1, _ = bsdf_api.eval_pdf(lb, si.wi, wo1, active_e)
    if polarized:
        from ..bsdf.polarized import specular_params_soa

        m_h = si.wi + wo1
        m_h = m_h / jnp.maximum(
            jnp.linalg.norm(m_h, axis=-1, keepdims=True), 1e-12)
        cos_i1 = jnp.abs(jnp.sum(si.wi * m_h, axis=-1))
        # structured per-lane factor parameters for the vertex->wall bounce
        # (applied to the NEE column below — no matrix build)
        prm1 = specular_params_soa(lb, -d1, -wi_world, cos_i1)

    f1max = f1 if spec1 else jnp.max(f1, axis=-1)
    active_e = active_e & (f1max > 1e-7)
    cos_wl = dot(wall_ng, -d1)
    active_e = active_e & (cos_wl > 0.0)
    # area -> solid angle pdf conversion (:546-551); keep all values finite
    # (an inf in a masked branch poisons reverse-mode AD through the mask)
    pdf_ls = dist1 * dist1 / jnp.maximum(cos_wl, 1e-9)
    f1 = jnp.where(sl(active_e),
                   f1 / sl(jnp.maximum(pdf_ls, 1e-9)), 0.0)

    # wall BSDF rows: per-lane gather, or the constant row broadcast
    if per_lane:
        lb2 = bsdf_api.gather_lane_bsdf(sd.bsdf, lanes.wall_bsdf_id,
                                        lanes.wall_uv)
    else:
        lb2 = bsdf_api.gather_lane_bsdf(
            sd.bsdf, ctx.wall_bsdf_id.reshape(1), ctx.wall_uv.reshape(1, 2))
        lb2 = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (n,) + a.shape[1:]), lb2)
    if sctx is not None:
        lb2 = sctx.uplift_lb(lb2)
    if spec1:
        lb2 = _squeeze_lb(lb2)
    if not polarized:
        beta2 = beta * f1
    dist_after1 = distance + jnp.where(active_e, dist1, 0.0) * eta

    # segment 2: NEE wall point -> (delta) laser, all geometry constant
    wall_n_sh = (lanes.wall_n_sh if per_lane
                 else jnp.broadcast_to(ctx.wall_n_sh, (n, 3)))
    wframe = Frame.from_normal(wall_n_sh)  # fields (N, 3)
    wi2 = jnp.stack([dot(-d1, wframe.s), dot(-d1, wframe.t),
                     dot(-d1, wframe.n)], axis=-1)
    wo2 = jnp.stack([dot(wall_d2, wframe.s), dot(wall_d2, wframe.t),
                     dot(wall_d2, wframe.n)], axis=-1)

    it2 = it_depth + 2  # two extra path vertices (:489-492 gates)
    if icfg.filter_depth != -1:
        active_e = active_e & (it2 == icfg.filter_depth)
    if icfg.discard_direct_paths:
        active_e = active_e & (it2 > 2)

    f2, _ = bsdf_api.eval_pdf(lb2, wi2, wo2, active_e)
    em_val = (lanes.wall_em if per_lane
              else jnp.broadcast_to(ctx.wall_em, (n,) + ctx.wall_em.shape))
    if sctx is not None:
        em_val = sctx.emission(em_val)
    if spec1:
        em_val = em_val[:, 0]

    if polarized:
        from ..bsdf.polarized import polarization_factor_col0_soa
        from ..core.mueller import msoa_matvec

        m_h2 = wi2 + wo2
        m_h2 = m_h2 / jnp.maximum(
            jnp.linalg.norm(m_h2, axis=-1, keepdims=True), 1e-12)
        cos_i2 = jnp.abs(jnp.sum(wi2 * m_h2, axis=-1))
        # emission is unpolarized: only column 0 of the full chain is
        # needed.  The wall factor is col0 (P2c); the vertex factor M1 is
        # applied to that column STRUCTURALLY (rotate/Fresnel-mix/rotate +
        # depolarizer/null class select, core/mueller.py
        # stokes_apply_sandwich) — no 4x4 build, then one matvec by beta.
        from ..core.mueller import stokes_apply_sandwich
        from ..scene.scene import BSDF_NULL as _BN

        P2c = polarization_factor_col0_soa(lb2, -wall_d2, -d1, cos_i2)
        v = tuple(e * f2 for e in P2c)
        is_spec1, A1, B1, C1, S1, ci21, si21, co21, so21 = prm1
        v_spec = stokes_apply_sandwich(
            v, A1, B1, C1, S1, sl(ci21), sl(si21), sl(co21), sl(so21))
        sp1 = sl(is_spec1)
        nullf1 = sl((lb.kind == _BN).astype(jnp.float32))
        t_col = tuple(
            jnp.where(sp1, v_spec[j], v[j] * (1.0 if j == 0 else nullf1))
            * f1
            for j in range(4))
        col = msoa_matvec(beta, t_col)
        Lr = jnp.where(
            active_e[:, None],
            pk([c * em_val for c in col]),
            0.0,
        )
    else:
        Lr = jnp.where(active_e[:, None], pk([beta2 * f2 * em_val]), 0.0)
    splat_dist = dist_after1 + (wall_dist2 * eta if account_last else 0.0)
    return Lr, splat_dist


class ExhaustiveLaser(NamedTuple):
    """Stacked per-laser-point constants for the fused exhaustive capture
    (one row per illumination point; the batched analogue of the hoisted
    wall-vertex constants in :class:`NLOSContext`).  Semantics: each laser
    point is treated as a REFOCUSED delta laser (the physical scanning
    process, and bit-compatible with the previous per-point driver), so
    ``wall_em`` is the on-axis emitter radiance at each point."""

    laser_target: jnp.ndarray  # (L, 3)
    wall_ng: jnp.ndarray  # (L, 3)
    wall_n_sh: jnp.ndarray  # (L, 3)
    wall_uv: jnp.ndarray  # (L, 2)
    wall_bsdf_id: jnp.ndarray  # (L,) int32
    wall_em: jnp.ndarray  # (L, C)
    wall_dist2: jnp.ndarray  # (L,)
    wall_d2: jnp.ndarray  # (L, 3)
    wall_clear: jnp.ndarray  # (L,) bool


def exhaustive_laser_targets(scene: Scene, cfg: SensorConfig,
                             icfg: IntegratorConfig):
    """Illumination grid for an exhaustive capture:
    ((L, 3) world points, (L,) validity).

    ``force_equal_illumination_scanning`` (default, transientnlospath.py
    :126-131): the grid is the pixel-center scan grid on the relay wall at
    (laser_scan_width x laser_scan_height) — identical to the sensor scan
    grid when the resolutions match (the reference asserts equality; we
    generalize to any wall grid).  Otherwise (:352-381): a discrete ray
    scan from the emitter through a widened ``illumination_scan_fov``
    frustum, intersected with the scene; points that miss keep
    ``wall_clear = False`` downstream (reference warns and says to ignore
    those slabs, :374-379)."""
    fcfg = cfg.film
    lw, lh = fcfg.laser_scan_width, fcfg.laser_scan_height
    if icfg.force_equal_illumination_scanning:
        wall_shape = scene.shapes[cfg.shape_index]
        px, py = np.meshgrid(np.arange(lw), np.arange(lh))
        uv = np.stack([(px.ravel() + 0.5) / lw, (py.ravel() + 0.5) / lh], -1)
        t = wall_shape.position_from_uv(uv).astype(np.float32)
        return t, np.ones(t.shape[0], bool)
    # FOV scan from the emitter (reference's dummy wider-FOV projector)
    sd = scene.data
    epos = np.asarray(sd.emitter.position[0], np.float64)
    zc = np.asarray(sd.emitter.direction[0], np.float64)
    xc = np.asarray(sd.emitter.frame_s[0], np.float64)
    yc = np.asarray(sd.emitter.frame_t[0], np.float64)
    thf = np.tan(np.deg2rad(icfg.illumination_scan_fov) / 2.0)
    # linspace(0, 1, res, endpoint=False) like the reference's ray grid
    u, v = np.meshgrid(np.arange(lw) / lw, np.arange(lh) / lh)
    x = (2.0 * u.ravel() - 1.0) * thf
    y = (2.0 * v.ravel() - 1.0) * thf
    d = x[:, None] * xc + y[:, None] * yc + zc
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    from ..ops.intersect import intersect_soup

    n = d.shape[0]
    t, prim, _u, _v = intersect_soup(
        sd.tri.v0, sd.tri.e1, sd.tri.e2,
        jnp.asarray(np.broadcast_to(epos, (n, 3)).copy(), jnp.float32),
        jnp.asarray(d, jnp.float32),
        jnp.full((n,), jnp.inf), jnp.ones((n,), bool))
    prim_np = np.asarray(prim)
    if not np.any(prim_np >= 0):
        raise ValueError(
            "The emitter did not intersect any geometry in the scene. "
            "Please, make sure it is properly aimed towards the desired "
            "relay surface. (transientnlospath.py:374-377)")
    if not np.all(prim_np >= 0):
        from ..log import warn as _warn

        _warn("Part of the laser scan did not intersect the scene. "
              "Results for those illumination points should be ignored. "
              "(transientnlospath.py:378-379)")
    t_np = np.where(prim_np >= 0, np.asarray(t), 0.0)
    return (epos + d * t_np[:, None]).astype(np.float32), prim_np >= 0


def prepare_exhaustive_lasers(scene: Scene,
                              targets: np.ndarray) -> ExhaustiveLaser:
    """Batched per-laser wall constants (vectorized prepare_nlos tail):
    one closest hit + one occlusion test + the on-axis emitter radiance per
    illumination point, all in two device calls."""
    sd = scene.data
    L = targets.shape[0]
    epos = np.asarray(sd.emitter.position[0], np.float32)
    to_wall = targets - epos
    dist_ew = np.linalg.norm(to_wall, axis=-1)
    d_ew = to_wall / np.maximum(dist_ew, 1e-12)[:, None]
    o_b = jnp.asarray(np.broadcast_to(epos, (L, 3)).copy())
    d_b = jnp.asarray(d_ew, jnp.float32)
    si_w = ray_intersect(sd, Ray.make(o_b, d_b), jnp.ones((L,), bool))
    tgt = jnp.asarray(targets)
    d2 = -d_b
    dist2 = jnp.asarray(dist_ew, jnp.float32)
    occ2 = ray_test(sd, tgt + d2 * 1e-4, d2,
                    jnp.maximum(dist2 - 2e-4, 0.0), jnp.ones((L,), bool))
    # refocused delta laser: on-axis projector/point radiance / dist^2
    from ..scene.scene import EM_POINT

    kind0 = (sd.emitter.ks.kinds[0] if sd.emitter.ks.kinds
             else int(np.asarray(sd.emitter.kind[0])))
    if kind0 not in (EM_PROJECTOR, EM_POINT):
        raise NotImplementedError(
            "fused exhaustive capture requires a delta (projector/point) "
            "laser emitter")
    em = sd.emitter.radiance[0][None, :] / jnp.maximum(
        dist2 * dist2, 1e-20)[:, None]
    return ExhaustiveLaser(
        laser_target=tgt,
        wall_ng=si_w.n,
        wall_n_sh=si_w.frame.n,
        wall_uv=si_w.uv,
        wall_bsdf_id=si_w.bsdf_id,
        wall_em=em,
        wall_dist2=dist2,
        wall_d2=d2,
        wall_clear=(~occ2) & si_w.valid,
    )


def _laser_nee_all(sd, lasers: ExhaustiveLaser, icfg, si, lb, beta, distance,
                   eta, it_depth, active_e, account_last: bool, sctx=None):
    """All-laser-points two-segment NEE from one path vertex — the fused
    form of the reference's exhaustive inner laser loop
    (transientnlospath.py:597-628): the SAME path sample feeds every laser
    slab.  Returns (Lr (Lc, N, C), splat_dist (Lc, N), act (Lc, N)).

    Unpolarized only (the per-point fallback driver covers polarized)."""
    from ..core.frame import Frame

    n = si.t.shape[0]
    Lc = lasers.laser_target.shape[0]
    C = beta.shape[-1]

    # segment 1: path vertex -> each illuminated wall point
    lt = lasers.laser_target  # (Lc, 3)
    d1v = lt[:, None, :] - si.p[None, :, :]  # (Lc, N, 3)
    dist1 = jnp.sqrt(jnp.maximum(jnp.sum(d1v * d1v, axis=-1), 1e-20))
    d1 = d1v / dist1[..., None]
    o_flat = jnp.broadcast_to(si.p[None], (Lc, n, 3)).reshape(Lc * n, 3)
    act_b = jnp.broadcast_to(active_e[None], (Lc, n))
    occ1 = ray_test(sd, o_flat + d1.reshape(Lc * n, 3) * 1e-4,
                    d1.reshape(Lc * n, 3),
                    (dist1 - 2e-4).reshape(Lc * n),
                    act_b.reshape(Lc * n)).reshape(Lc, n)
    act = act_b & ~occ1 & lasers.wall_clear[:, None]

    # vertex BSDF toward each wall point
    wo1 = jnp.stack([
        jnp.sum(d1 * si.frame.s[None], axis=-1),
        jnp.sum(d1 * si.frame.t[None], axis=-1),
        jnp.sum(d1 * si.frame.n[None], axis=-1),
    ], axis=-1)  # (Lc, N, 3)
    lb_b = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (Lc,) + a.shape).reshape(
            (Lc * n,) + a.shape[1:]), lb)
    wi_b = jnp.broadcast_to(si.wi[None], (Lc, n, 3)).reshape(Lc * n, 3)
    f1, _ = bsdf_api.eval_pdf(lb_b, wi_b, wo1.reshape(Lc * n, 3),
                              act.reshape(Lc * n))
    f1 = f1.reshape(Lc, n, -1)
    act = act & (jnp.max(f1, axis=-1) > 1e-7)
    cos_wl = jnp.sum(lasers.wall_ng[:, None, :] * (-d1), axis=-1)
    act = act & (cos_wl > 0.0)
    pdf_ls = dist1 * dist1 / jnp.maximum(cos_wl, 1e-9)
    f1 = jnp.where(act[..., None], f1 / jnp.maximum(pdf_ls, 1e-9)[..., None],
                   0.0)
    dist_after1 = distance[None] + jnp.where(act, dist1, 0.0) * eta[None]

    # segment 2: wall point -> (refocused delta) laser, per-point constants
    wframe = Frame.from_normal(lasers.wall_n_sh)  # fields (Lc, 3)
    wi2 = jnp.stack([
        jnp.sum(-d1 * wframe.s[:, None, :], axis=-1),
        jnp.sum(-d1 * wframe.t[:, None, :], axis=-1),
        jnp.sum(-d1 * wframe.n[:, None, :], axis=-1),
    ], axis=-1)  # (Lc, N, 3)
    wo2 = jnp.stack([
        jnp.sum(lasers.wall_d2 * wframe.s, axis=-1),
        jnp.sum(lasers.wall_d2 * wframe.t, axis=-1),
        jnp.sum(lasers.wall_d2 * wframe.n, axis=-1),
    ], axis=-1)  # (Lc, 3)
    wo2_b = jnp.broadcast_to(wo2[:, None, :], (Lc, n, 3))

    it2 = it_depth + 2  # two extra path vertices (:489-492 gates)
    if icfg.filter_depth != -1:
        act = act & (it2 == icfg.filter_depth)
    if icfg.discard_direct_paths:
        act = act & (it2 > 2)

    lb2 = bsdf_api.gather_lane_bsdf(sd.bsdf, lasers.wall_bsdf_id,
                                    lasers.wall_uv)  # leaves (Lc, ...)
    if sctx is not None:
        lb2 = sctx.uplift_lb(lb2)
    lb2_b = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[:, None], (Lc, n) + a.shape[1:]).reshape(
            (Lc * n,) + a.shape[1:]), lb2)
    f2, _ = bsdf_api.eval_pdf(lb2_b, wi2.reshape(Lc * n, 3),
                              wo2_b.reshape(Lc * n, 3), act.reshape(Lc * n))
    f2 = f2.reshape(Lc, n, -1)
    em_val = lasers.wall_em[:, None, :]  # (Lc, 1, C)
    if sctx is not None:
        em_val = sctx.emission(
            jnp.broadcast_to(em_val, (Lc, n, em_val.shape[-1])).reshape(
                Lc * n, -1)).reshape(Lc, n, -1)

    Lr = jnp.where(act[..., None], beta[None] * f1 * f2 * em_val, 0.0)
    splat_dist = dist_after1 + (
        lasers.wall_dist2[:, None] * eta[None] if account_last else 0.0)
    return Lr, splat_dist, act


def _plain_nee(sd, ctx, icfg, si, lb, beta, distance, eta, it_depth, active_e,
               account_last: bool, wi_world=None, polarized: bool = False,
               sctx=None):
    """Single-emitter NEE toward the projector/area emitter
    (emitter_nee_sample, transientnlospath.py:432-509)."""
    em_idx = jnp.broadcast_to(ctx.emitter_idx, si.t.shape)
    epos = sd.emitter.position[0]
    d2v = jnp.broadcast_to(epos, si.p.shape) - si.p
    dist2 = jnp.sqrt(jnp.maximum(jnp.sum(d2v * d2v, axis=-1), 1e-20))
    d2 = d2v / dist2[:, None]
    occ = ray_test(sd, si.p + d2 * 1e-4, d2, dist2 - 2e-4, active_e)
    active_e = active_e & ~occ

    cos_em = dot(-d2, sd.emitter.direction[0])  # unused for projector eval
    em_val = emitter_eval_direction(
        sd, em_idx, jnp.broadcast_to(epos, si.p.shape),
        -jnp.broadcast_to(sd.emitter.direction[0], si.p.shape),
        d2, dist2, cos_em,
    )
    if sctx is not None:
        em_val = sctx.emission(em_val)
    wo2 = si.frame.to_local(d2)
    spec1, sl, pk = _spec_tools(lb)
    if spec1:
        em_val = em_val[:, 0]
    f2, _ = bsdf_api.eval_pdf(lb, si.wi, wo2, active_e)

    # depth gates (:489-492)
    if icfg.filter_depth != -1:
        active_e = active_e & (it_depth == icfg.filter_depth)
    if icfg.discard_direct_paths:
        active_e = active_e & (it_depth > 2)

    if polarized:
        from ..bsdf.polarized import polarization_factor_col0_soa
        from ..core.mueller import msoa_matvec

        m_h = si.wi + wo2
        m_h = m_h / jnp.maximum(
            jnp.linalg.norm(m_h, axis=-1, keepdims=True), 1e-12)
        cos_i2 = jnp.abs(jnp.sum(si.wi * m_h, axis=-1))
        # emission is unpolarized: column 0 only -> one matvec (SoA)
        P2c = polarization_factor_col0_soa(lb, -d2, -wi_world, cos_i2)
        col = msoa_matvec(beta, tuple(e * f2 for e in P2c))
        Lr = jnp.where(
            active_e[:, None],
            pk([c * em_val for c in col]),
            0.0,
        )
    else:
        Lr = jnp.where(active_e[:, None], pk([beta * f2 * em_val]), 0.0)
    splat_dist = distance + (dist2 * eta if account_last else 0.0)
    return Lr, splat_dist


def sample_nlos_primal(
    sd: SceneData,
    ctx: NLOSContext,
    sampler: Sampler,
    ray: Ray,
    ray_weight: jnp.ndarray,
    film: TransientFilmState,
    film_cfg: FilmConfig,
    icfg: IntegratorConfig,
    sample_scale,
    base_dim: int,
    spp: int,
    polarized: bool = False,
    sensor_up=None,
    spectral: bool = False,
    skip_le: bool = False,
    lanes=None,
):
    """The NLOS wavefront loop (transientnlospath.py:672-927, primal).

    ``lanes``: optional per-lane laser constants (ExhaustiveLaser rows per
    wavefront lane) — the batched confocal scan, where every lane performs
    laser NEE against its own focused wall point (see ``_laser_nee``).

    ``skip_le=True`` (static) elides the emitter-hit (Le) term and its film
    event entirely — valid when every emitter is delta (projector/point,
    i.e. any laser-focused NLOS scene), where ``emitter_eval_hit`` is
    identically zero; it halves the transient-splat traffic, the dominant
    NLOS cost.  Mirrors the reference's exhaustive-mode Le skip
    (transientnlospath.py:775), applied to all delta-emitter captures.

    ``polarized=True`` switches the throughput to a Mueller-matrix chain
    (N, 4, 4, C) initialized by the sensor Stokes-frame alignment rotation
    (reference utils.py:9-21) and L to packed Stokes (N, 4C).

    ``spectral=True`` gives each lane N_WL hero wavelengths (the same
    machinery as sample_primal's spectral path; splats convert to sRGB so
    the film stays 3-channel)."""
    n = ray.o.shape[0]
    C = sd.bsdf.reflectance.shape[-1]
    key = sampler.key

    sctx = None
    if spectral:
        sctx = _sp.SpectralCtx.make(key, n)
        C = _sp.N_WL
    account = icfg.account_first_and_last_bounces
    splat_w = ray_weight * sample_scale
    hg_on = icfg.nlos_hidden_geometry_sampling
    hg_rr = icfg.nlos_hidden_geometry_sampling_do_rroulette
    laser_on = icfg.nlos_laser_sampling

    # Mono squeeze (see path_regen.py): C == 1 spectral state rides as
    # (N,); the NEE helpers and BSDF kernels are shape-polymorphic
    mono = C == 1
    if polarized:
        from ..bsdf.polarized import sensor_alignment_soa

        vert = sensor_up if sensor_up is not None else jnp.array(
            [0.0, 1.0, 0.0])
        # SoA Mueller throughput (tuple of 16 spectral arrays)
        beta0 = sensor_alignment_soa(ray.d, vert, C)
        if mono:
            beta0 = tuple(e[:, 0] for e in beta0)
        L0 = jnp.zeros((n, 4 * C), jnp.float32)
    else:
        beta0 = jnp.ones((n,) if mono else (n, C), jnp.float32)
        L0 = jnp.zeros((n, C), jnp.float32)

    state = dict(
        o=ray.o, d=ray.d,
        beta=beta0,
        L=L0,
        eta=jnp.ones((n,), jnp.float32),
        distance=jnp.zeros((n,), jnp.float32),  # = ray.time (:718)
        active=jnp.ones((n,), bool),
        depth=jnp.zeros((n,), jnp.int32),
        prev_p=ray.o,
        prev_pdf=jnp.ones((n,), jnp.float32),
        prev_delta=jnp.ones((n,), bool),
        film=film,
        n_rays=jnp.zeros((), jnp.float32),
    )

    def bounce(it, st):
        from ..core.rng import draw_bounce_block

        ub = draw_bounce_block(key, it, n, NLOS_DIMS_PER_BOUNCE)

        def rnd1(k):
            return ub[:, k]

        def rnd2(k):
            return ub[:, k : k + 2]

        active = st["active"]
        si = ray_intersect(sd, Ray.make(st["o"], st["d"]), active)
        hit = active & si.valid

        # first-segment exclusion (:751-752); `it` is traced, so the gate is
        # a mask, not Python control flow
        seg_ok = hit & (jnp.bool_(account) | (it > 0))
        distance = st["distance"] + jnp.where(seg_ok, si.t, 0.0) * st["eta"]

        lb = bsdf_api.gather_lane_bsdf(sd.bsdf, si.bsdf_id, si.uv)
        if sctx is not None:
            lb = sctx.uplift_lb(lb)
        if mono:
            lb = _squeeze_lb(lb)
        _, sl, pk = _spec_tools(lb)

        # ---------------- direct emission -------------------------------
        if skip_le:
            Le = None
        else:
            pdf_em_hit = pdf_emitter_direction(sd, st["prev_p"], si)
            pdf_em_hit = jnp.where(st["prev_delta"], 0.0, pdf_em_hit)
            mis = mis_weight(st["prev_pdf"], pdf_em_hit)
            Le_raw = emitter_eval_hit(sd, si, st["d"])
            if sctx is not None:
                Le_raw = sctx.emission(Le_raw)
            if mono:
                Le_raw = Le_raw[:, 0]
            if polarized:
                w_le = sl(mis) * Le_raw
                Le = jnp.where(
                    hit[:, None],
                    pk([st["beta"][4 * i] * w_le for i in range(4)]),
                    0.0,
                )
            else:
                Le = jnp.where(hit[:, None],
                               pk([st["beta"] * sl(mis) * Le_raw]), 0.0)

        active_next = active & (it + 1 < icfg.max_depth) & si.valid
        active_em = active_next & bsdf_api.is_smooth(lb)

        # ---------------- emitter sampling ------------------------------
        # NEE dims 0-1 are consumed conceptually by sample_direction; the
        # delta-laser connection itself needs no randomness but the budget
        # stays fixed for replay.
        if laser_on:
            Lr_dir, nee_dist = _laser_nee(
                sd, ctx, icfg, si, lb, st["beta"], distance, st["eta"],
                it, active_em, account_last=account,
                wi_world=st["d"], polarized=polarized, sctx=sctx,
                lanes=lanes,
            )
        else:
            Lr_dir, nee_dist = _plain_nee(
                sd, ctx, icfg, si, lb, st["beta"], distance, st["eta"],
                it, active_em, account_last=account,
                wi_world=st["d"], polarized=polarized, sctx=sctx,
            )

        Lr_f = _sctx_film(sctx, Lr_dir, polarized) if sctx is not None else Lr_dir
        if skip_le:
            film_st = splat_transient_pair(
                st["film"], film_cfg, spp,
                nee_dist, Lr_f * splat_w[:, None], None, None,
                active,
                icfg.temporal_filter, icfg.gaussian_stddev,
            )
        else:
            Le_f = _sctx_film(sctx, Le, polarized) if sctx is not None else Le
            film_st = splat_transient_pair(
                st["film"], film_cfg, spp,
                distance, Le_f * splat_w[:, None],
                nee_dist, Lr_f * splat_w[:, None],
                active,
                icfg.temporal_filter, icfg.gaussian_stddev,
            )

        # ---------------- HG / BSDF direction sampling -------------------
        if hg_on and hg_rr:
            do_hg = rnd1(2) < 0.5
            pdf_method = jnp.where(do_hg, 0.5, 0.5)
        elif hg_on:
            do_hg = jnp.ones((n,), bool)
            pdf_method = jnp.ones((n,))
        else:
            do_hg = jnp.zeros((n,), bool)
            pdf_method = jnp.ones((n,))

        # hidden-geometry direction sample (dims 3-5; dim 3 unused like the
        # reference's discarded next_1d at :814)
        p_hg, n_hg, pdf_a = _sample_hidden_point(sd, ctx, rnd1(4), rnd1(5))
        dvh = p_hg - si.p
        dist_h = jnp.sqrt(jnp.maximum(jnp.sum(dvh * dvh, axis=-1), 1e-20))
        dh = dvh / dist_h[:, None]
        cos_i = dot(si.n, dh)
        cos_g = dot(n_hg, -dh)
        hg_ok = active_next & do_hg & (cos_i > 1e-7) & (cos_g > 1e-7)
        wo_hg = si.frame.to_local(dh)
        f_hg, _ = bsdf_api.eval_pdf(lb, si.wi, wo_hg, hg_ok)
        pdf_hg = pdf_a * dist_h * dist_h / jnp.maximum(jnp.abs(cos_g), 1e-9)
        hg_ok = hg_ok & (pdf_hg > 1e-9)
        # masked guarded reciprocal: no huge intermediates on dead lanes
        # (they poison reverse-mode AD through the selects)
        rcp_hg = jnp.where(hg_ok, 1.0 / jnp.maximum(pdf_hg, 1e-9), 0.0)
        w_hg = f_hg * sl(rcp_hg)

        # plain BSDF sample (dims 6-8)
        bs = bsdf_api.sample(lb, si.wi, rnd1(6), rnd2(7),
                             active_next & ~do_hg)

        wo = jnp.where(do_hg[:, None], wo_hg, bs.wo)
        weight = jnp.where(sl(do_hg), w_hg, bs.weight)
        pdf_dir = jnp.where(do_hg, pdf_hg, bs.pdf)
        delta = jnp.where(do_hg, False, bs.delta)
        eta_s = jnp.where(do_hg, 1.0, bs.eta)

        d_world = si.frame.to_world(wo)
        new_ray = si.spawn_ray(d_world)

        L = st["L"] + Lr_dir if skip_le else st["L"] + Le + Lr_dir
        if polarized:
            from ..bsdf.polarized import specular_params_soa
            from ..core.mueller import msoa_apply_sandwich, msoa_where
            from ..scene.scene import BSDF_NULL as _BN

            m_h = si.wi + wo
            m_h = m_h / jnp.maximum(
                jnp.linalg.norm(m_h, axis=-1, keepdims=True), 1e-12)
            cos_i_s = jnp.where(
                delta, jnp.abs(si.wi[:, 2]),
                jnp.abs(jnp.sum(si.wi * m_h, axis=-1)))
            # structured sandwich apply per lobe class instead of building
            # the Mueller factor and running a 64-madd product
            is_spec, A, B, Cc, S, ci2, si2, co2, so2 = specular_params_soa(
                lb, -d_world, -st["d"], cos_i_s)
            f = weight / sl(pdf_method)
            spec_beta = msoa_apply_sandwich(
                st["beta"], A * f, B * f, Cc * f, S * f,
                sl(ci2), sl(si2), sl(co2), sl(so2))
            sp = sl(is_spec)
            nullf = sl((lb.kind == _BN).astype(jnp.float32))
            beta = tuple(
                jnp.where(sp, spec_beta[4 * i + j],
                          st["beta"][4 * i + j] * f
                          * (1.0 if j == 0 else nullf))
                for i in range(4) for j in range(4))
            beta = msoa_where(sl(active_next), beta, st["beta"])
        else:
            beta = jnp.where(
                sl(active_next),
                st["beta"] * weight / sl(pdf_method),
                st["beta"],
            )
        eta = jnp.where(active_next, st["eta"] * eta_s, st["eta"])

        # RR is a detached sampling decision (reference detached PRB):
        # stop_gradient keeps full-loop AD from differentiating the
        # acceptance probability
        if polarized:
            b0 = beta[0]
        else:
            b0 = beta
        beta_max = jax.lax.stop_gradient(
            b0 if mono else jnp.max(b0, axis=-1))
        active_next = active_next & (beta_max != 0.0)
        rr_prob = jnp.minimum(beta_max * eta * eta, 0.95)
        active_next = active_next & (rr_prob > 0.0)
        rr_active = it >= icfg.rr_depth
        rr_scale = jnp.where((rr_active & active_next) & (rr_prob > 0.0),
                             1.0 / jnp.maximum(rr_prob, 1e-6), 1.0)
        rr_scale = jax.lax.stop_gradient(rr_scale)
        if polarized:
            beta = tuple(e * sl(rr_scale) for e in beta)
        else:
            beta = beta * sl(rr_scale)
        rr_continue = rnd1(9) < rr_prob
        active_next = active_next & (~rr_active | rr_continue)

        return dict(
            o=new_ray.o, d=d_world, beta=beta, L=L, eta=eta,
            distance=distance, active=active_next,
            depth=st["depth"] + jnp.where(hit, 1, 0),
            prev_p=jnp.where(hit[:, None], si.p, st["prev_p"]),
            prev_pdf=jnp.where(active_next, pdf_dir, st["prev_pdf"]),
            prev_delta=jnp.where(active_next, delta, st["prev_delta"]),
            film=film_st,
            # rays actually traced per bounce: 1 closest-hit + 1 shadow ray
            # (the wall landing + wall->laser segments are hoisted constants
            # now — see _laser_nee — so they no longer count)
            n_rays=st["n_rays"]
            + jnp.sum(active.astype(jnp.float32)) * 2.0,
        )

    final = jax.lax.fori_loop(0, icfg.max_depth, bounce, state)
    L_out = _sctx_film(sctx, final["L"], polarized) if sctx is not None else final["L"]
    return final["film"], L_out, final["depth"] > 0, final["n_rays"]


@_partial(jax.jit,
          static_argnames=("film_cfg_", "icfg_", "spp_", "hw_",
                           "polarized_", "spectral_"),
          donate_argnames=("film",))
def _nlos_confocal_pass(sd, ctx_, lanes_, film, seed_, pass_idx, inv_total,
                        *, film_cfg_, icfg_, spp_, hw_, polarized_=False,
                        spectral_=False):
    """One spp-pass of the batched confocal scan: every scan point's
    focused capture in one wavefront.  ``lanes_`` holds PER-SCAN-POINT
    laser constants (ExhaustiveLaser rows, one per scan pixel); each lane
    uses the row of its pixel.  The wavefront itself is
    ``sample_nlos_primal`` with per-lane lasers (skip_le: the focused
    laser is delta, so Le is identically zero) — one code path for ALL
    variants (rgb/mono x polarized x spectral).  Path layout / RNG /
    splat semantics match the per-point loop exactly except the sample
    stream (one stream for the whole scan instead of one per point)."""
    n = spp_ * hw_
    sampler = Sampler(seed_, n, stream=pass_idx)
    # per-lane laser rows: lanes are spp-major (lane = s*hw + p), so the
    # "gather by pixel" is a TILE of the (hw, ...) tables — no gather op
    lanes = jax.tree_util.tree_map(
        lambda a: jnp.tile(a, (spp_,) + (1,) * (a.ndim - 1)), lanes_)
    # confocal sensor rays: aim at each lane's own focused point
    o = jnp.broadcast_to(ctx_.sensor_origin, (n, 3))
    d = normalize(lanes.laser_target - o)
    ray = Ray.make(o, d)
    ray_weight = jnp.ones((n,), jnp.float32)
    film, L, _valid, n_rays = sample_nlos_primal(
        sd, ctx_, sampler, ray, ray_weight, film, film_cfg_, icfg_,
        inv_total, base_dim=2, spp=spp_, polarized=polarized_,
        spectral=spectral_, skip_le=True, lanes=lanes,
    )
    film = splat_steady(film, spp_, L, ray_weight)
    return film, n_rays


def render_nlos_confocal_scan(scene: Scene, spp=None, seed=0, sensor=0,
                              max_lanes=1 << 21, progress_callback=None,
                              return_stats: bool = False):
    """Whole-grid confocal capture in batched wavefronts.

    The reference's confocal workflow loops
    ``focus_emitter_at_relay_wall_pixel`` + render over every scan point
    (1-simple-nlos-scenes.ipynb confocal cell); per point that pays the
    NLOS prepare's host<->device round trips.  Here ALL scan points render simultaneously: one
    batched prepare (two device calls for every point's laser constants)
    and one wavefront whose lanes each carry their own focused-laser
    constants.  Estimator per point identical to the per-point loop
    (laser-sampled 2-segment NEE from a delta laser; Le is identically
    zero).

    Returns (steady (ph, pw, C), transient (ph, pw, T, C)) over the
    virtual scan grid (``original_film_width/height``)."""
    cfg = scene.sensors[sensor]
    icfg = scene.integrator
    film_cfg = cfg.film
    if not cfg.is_confocal:
        raise ValueError("render_nlos_confocal_scan needs an "
                         "nlos_capture_meter with original_film_width/"
                         "height (confocal mode)")
    if not icfg.nlos_laser_sampling:
        raise ValueError("the batched confocal scan requires "
                         "nlos_laser_sampling=True")
    polarized = scene.variant.polarized
    spectral = scene.variant.spectral
    pw, ph = cfg.scan_size
    hw = pw * ph
    spp = spp if spp is not None else cfg.spp

    # per-point focused-laser constants (batched prepare)
    wall_shape = scene.shapes[cfg.shape_index]
    px, py = np.meshgrid(np.arange(pw), np.arange(ph))
    uv = np.stack([(px.ravel() + 0.5) / pw, (py.ravel() + 0.5) / ph], -1)
    targets = wall_shape.position_from_uv(uv).astype(np.float32)
    lanes = prepare_exhaustive_lasers(scene, targets)

    # base context for hidden-geometry tables + sensor origin
    from ..nlos import focus_emitter_at_relay_wall_3dpoint

    if not scene.laser_focused:
        focus_emitter_at_relay_wall_3dpoint(targets[hw // 2], scene)
    ctx = prepare_nlos_cached(scene, cfg, sensor)

    spp_chunk = max(1, min(spp, max_lanes // max(hw, 1)))
    n_passes = (spp + spp_chunk - 1) // spp_chunk
    spp_chunk = (spp + n_passes - 1) // n_passes
    total_spp = spp_chunk * n_passes

    C = scene.variant.color_channels * (4 if polarized else 1)
    film = film_init(film_cfg, C, scan_pixels=hw)
    from ..scene.scene import primal_sd

    total_rays = 0.0
    for p in range(n_passes):
        film, n_rays = _nlos_confocal_pass(
            primal_sd(scene.data), ctx, lanes, film, jnp.uint32(seed),
            jnp.uint32(p), jnp.float32(1.0 / total_spp),
            film_cfg_=film_cfg, icfg_=icfg, spp_=spp_chunk, hw_=hw,
            polarized_=polarized, spectral_=spectral)
        total_rays = total_rays + n_rays
        if progress_callback is not None:
            progress_callback((p + 1) / n_passes)
    steady, transient = develop(film, film_cfg, shape_hw=(ph, pw))
    if return_stats:
        return steady, transient, {"rays": float(total_rays),
                                   "spp": total_spp}
    return steady, transient


def sample_nlos_exhaustive_primal(
    sd: SceneData,
    ctx: NLOSContext,
    lasers: ExhaustiveLaser,  # (Lc, ...) this chunk's illumination points
    sampler: Sampler,
    ray: Ray,
    ray_weight: jnp.ndarray,
    film: TransientFilmState,  # transient pixel axis = Lc * hw (+pad)
    film_cfg: FilmConfig,
    icfg: IntegratorConfig,
    sample_scale,  # 1 / total_spp (per-slab normalization)
    spp: int,
    hw: int,
):
    """Fused exhaustive NLOS wavefront: ONE camera-path wavefront feeds
    every laser slab (the reference's per-bounce inner laser loop,
    transientnlospath.py:597-628, vectorized over the laser axis).  Path
    sampling (camera rays, HG/BSDF directions, RR) is laser-independent,
    so each slab equals the corresponding single-capture render
    bit-for-bit while the closest-hit/BSDF-sampling work is paid once.

    Le is skipped unconditionally: exhaustive requires a delta laser
    (reference skips it too, :775).  Unpolarized, non-spectral (the
    per-point fallback driver covers those variants).

    Returns (film, L_sum (N, C) summed over this chunk's lasers, valid,
    n_rays)."""
    from ..film.transient_film import splat_transient_flat

    n = ray.o.shape[0]
    C = sd.bsdf.reflectance.shape[-1]
    key = sampler.key
    Lc = lasers.laser_target.shape[0]
    account = icfg.account_first_and_last_bounces
    splat_w = ray_weight * sample_scale
    hg_on = icfg.nlos_hidden_geometry_sampling
    hg_rr = icfg.nlos_hidden_geometry_sampling_do_rroulette

    state = dict(
        o=ray.o, d=ray.d,
        beta=jnp.ones((n, C), jnp.float32),
        L=jnp.zeros((n, C), jnp.float32),
        eta=jnp.ones((n,), jnp.float32),
        distance=jnp.zeros((n,), jnp.float32),
        active=jnp.ones((n,), bool),
        depth=jnp.zeros((n,), jnp.int32),
        film=film,
        n_rays=jnp.zeros((), jnp.float32),
    )

    def bounce(it, st):
        from ..core.rng import draw_bounce_block

        ub = draw_bounce_block(key, it, n, NLOS_DIMS_PER_BOUNCE)

        def rnd1(k):
            return ub[:, k]

        def rnd2(k):
            return ub[:, k : k + 2]

        active = st["active"]
        si = ray_intersect(sd, Ray.make(st["o"], st["d"]), active)
        hit = active & si.valid

        seg_ok = hit & (jnp.bool_(account) | (it > 0))
        distance = st["distance"] + jnp.where(seg_ok, si.t, 0.0) * st["eta"]

        lb = bsdf_api.gather_lane_bsdf(sd.bsdf, si.bsdf_id, si.uv)

        active_next = active & (it + 1 < icfg.max_depth) & si.valid
        active_em = active_next & bsdf_api.is_smooth(lb)

        # ---------------- all-laser-slab NEE -----------------------------
        Lr_all, nee_dist, act_all = _laser_nee_all(
            sd, lasers, icfg, si, lb, st["beta"], distance, st["eta"],
            it, active_em, account_last=account,
        )
        # arrange (Lc, N=spp*hw, .) -> flat spp-major over Lc*hw slots:
        # flat = s * (Lc*hw) + l * hw + p
        def arrange(a, c=None):
            shp = (Lc, spp, hw) + (() if c is None else (c,))
            a = a.reshape(shp)
            a = jnp.moveaxis(a, 0, 1)
            return a.reshape((spp * Lc * hw,) + (() if c is None else (c,)))

        film_st = splat_transient_flat(
            st["film"], film_cfg, spp, Lc * hw,
            arrange(nee_dist),
            arrange(Lr_all * splat_w[None, :, None], C),
            arrange(act_all),
        )
        L = st["L"] + jnp.sum(Lr_all, axis=0)

        # ---------------- HG / BSDF direction sampling -------------------
        # (identical decisions and RNG dims as sample_nlos_primal: the
        # per-slab outputs stay bit-compatible with single captures)
        if hg_on and hg_rr:
            do_hg = rnd1(2) < 0.5
            pdf_method = jnp.where(do_hg, 0.5, 0.5)
        elif hg_on:
            do_hg = jnp.ones((n,), bool)
            pdf_method = jnp.ones((n,))
        else:
            do_hg = jnp.zeros((n,), bool)
            pdf_method = jnp.ones((n,))

        p_hg, n_hg, pdf_a = _sample_hidden_point(sd, ctx, rnd1(4), rnd1(5))
        dvh = p_hg - si.p
        dist_h = jnp.sqrt(jnp.maximum(jnp.sum(dvh * dvh, axis=-1), 1e-20))
        dh = dvh / dist_h[:, None]
        cos_i = dot(si.n, dh)
        cos_g = dot(n_hg, -dh)
        hg_ok = active_next & do_hg & (cos_i > 1e-7) & (cos_g > 1e-7)
        wo_hg = si.frame.to_local(dh)
        f_hg, _ = bsdf_api.eval_pdf(lb, si.wi, wo_hg, hg_ok)
        pdf_hg = pdf_a * dist_h * dist_h / jnp.maximum(jnp.abs(cos_g), 1e-9)
        hg_ok = hg_ok & (pdf_hg > 1e-9)
        rcp_hg = jnp.where(hg_ok, 1.0 / jnp.maximum(pdf_hg, 1e-9), 0.0)
        w_hg = f_hg * rcp_hg[:, None]

        bs = bsdf_api.sample(lb, si.wi, rnd1(6), rnd2(7),
                             active_next & ~do_hg)

        wo = jnp.where(do_hg[:, None], wo_hg, bs.wo)
        weight = jnp.where(do_hg[:, None], w_hg, bs.weight)
        eta_s = jnp.where(do_hg, 1.0, bs.eta)

        d_world = si.frame.to_world(wo)
        new_ray = si.spawn_ray(d_world)

        beta = jnp.where(
            active_next[:, None],
            st["beta"] * weight / pdf_method[:, None],
            st["beta"],
        )
        eta = jnp.where(active_next, st["eta"] * eta_s, st["eta"])

        beta_max = jax.lax.stop_gradient(jnp.max(beta, axis=-1))
        active_next = active_next & (beta_max != 0.0)
        rr_prob = jnp.minimum(beta_max * eta * eta, 0.95)
        active_next = active_next & (rr_prob > 0.0)
        rr_active = it >= icfg.rr_depth
        rr_scale = jnp.where((rr_active & active_next) & (rr_prob > 0.0),
                             1.0 / jnp.maximum(rr_prob, 1e-6), 1.0)
        rr_scale = jax.lax.stop_gradient(rr_scale)
        beta = beta * rr_scale[:, None]
        rr_continue = rnd1(9) < rr_prob
        active_next = active_next & (~rr_active | rr_continue)

        return dict(
            o=new_ray.o, d=d_world, beta=beta, L=L, eta=eta,
            distance=distance, active=active_next,
            depth=st["depth"] + jnp.where(hit, 1, 0),
            film=film_st,
            # 1 closest hit + Lc shadow rays per active lane per bounce
            n_rays=st["n_rays"]
            + jnp.sum(active.astype(jnp.float32)) * (1.0 + Lc),
        )

    final = jax.lax.fori_loop(0, icfg.max_depth, bounce, state)
    return final["film"], final["L"], final["depth"] > 0, final["n_rays"]


# --------------------------------------------------------------------------
# Driver
# --------------------------------------------------------------------------

from functools import partial as _partial


@_partial(jax.jit,
          static_argnames=("film_cfg_", "icfg_", "spp_", "hw_",
                           "polarized_", "spectral_", "skip_le_",
                           "channels_"),
          )
def _nlos_render_fused(sd, ctx_, seed_, inv_total, *,
                       film_cfg_, icfg_, spp_, hw_, polarized_, spectral_,
                       skip_le_, channels_):
    """Single-pass NLOS render as ONE XLA program: film init + wavefront +
    steady splat + develop fused, instead of ~15 eager dispatches per
    render (5 zeros for film_init, ~8 develop ops)."""
    film = film_init(film_cfg_, channels_, scan_pixels=hw_)
    n = spp_ * hw_
    sampler = Sampler(seed_, n, stream=jnp.uint32(0))
    ray, ray_weight = sample_nlos_rays(ctx_, spp_, hw_)
    film, L, valid, n_rays = sample_nlos_primal(
        sd, ctx_, sampler, ray, ray_weight, film, film_cfg_, icfg_,
        inv_total, base_dim=2, spp=spp_, polarized=polarized_,
        spectral=spectral_, skip_le=skip_le_,
    )
    film = splat_steady(film, spp_, L, ray_weight)
    steady, transient = develop(
        film, film_cfg_, shape_hw=(film_cfg_.height, film_cfg_.width))
    return steady, transient, n_rays


@_partial(jax.jit,
          static_argnames=("film_cfg_", "icfg_", "spp_", "hw_",
                           "polarized_", "spectral_", "skip_le_"),
          donate_argnames=("film",))
def _nlos_one_pass(sd, ctx_, film, seed_, pass_idx, inv_total, *,
                   film_cfg_, icfg_, spp_, hw_, polarized_, spectral_,
                   skip_le_):
    """Module-level jitted NLOS pass: defining this inside render_nlos made
    every render call a fresh closure -> a full re-TRACE per call."""
    n = spp_ * hw_
    sampler = Sampler(seed_, n, stream=pass_idx)
    ray, ray_weight = sample_nlos_rays(ctx_, spp_, hw_)
    film, L, valid, n_rays = sample_nlos_primal(
        sd, ctx_, sampler, ray, ray_weight, film, film_cfg_, icfg_,
        inv_total, base_dim=2, spp=spp_, polarized=polarized_,
        spectral=spectral_, skip_le=skip_le_,
    )
    film = splat_steady(film, spp_, L, ray_weight)
    return film, n_rays


def render_nlos(scene: Scene, spp=None, seed=0, sensor=0,
                max_lanes=1 << 21, progress_callback=None,
                return_stats: bool = False):
    """NLOS render driver (mirrors render() pass splitting for the huge
    NLOS spp budgets, e.g. 25k spp at 32x32 scan — BASELINE.md)."""
    from functools import partial

    cfg = scene.sensors[sensor]
    icfg = scene.integrator
    film_cfg = cfg.film
    if film_cfg.is_cropped:
        raise NotImplementedError(
            "NLOS capture films do not support crop windows")
    if icfg.camera_unwarp:
        raise ValueError("Do not use camera_unwarp with transient_nlos_path; "
                         "use account_first_and_last_bounces "
                         "(transientnlospath.py:725-727)")
    spp = spp if spp is not None else cfg.spp
    hw = film_cfg.width * film_cfg.height
    polarized = scene.variant.polarized

    if icfg.capture_type == "exhaustive":
        return render_nlos_exhaustive(
            scene, spp=spp, seed=seed, sensor=sensor, max_lanes=max_lanes,
            progress_callback=progress_callback, return_stats=return_stats)

    ctx = prepare_nlos_cached(scene, cfg, sensor)

    spp_chunk = max(1, min(spp, max_lanes // max(hw, 1)))
    n_passes = (spp + spp_chunk - 1) // spp_chunk
    spp_chunk = (spp + n_passes - 1) // n_passes
    total_spp = spp_chunk * n_passes

    skip_le = can_skip_le(scene.data)

    film_channels = scene.variant.color_channels * (4 if polarized else 1)
    from ..scene.scene import primal_sd

    if (n_passes == 1
            and not (film_cfg.warn_negative or film_cfg.warn_invalid)):
        # fast path: the whole render is one fused XLA program (same
        # sampler stream 0 as the unfused single pass -> identical output)
        steady, transient, n_rays = _nlos_render_fused(
            primal_sd(scene.data), ctx, jnp.uint32(seed),
            jnp.float32(1.0 / total_spp),
            film_cfg_=film_cfg, icfg_=icfg, spp_=spp_chunk, hw_=hw,
            polarized_=polarized, spectral_=scene.variant.spectral,
            skip_le_=skip_le, channels_=film_channels,
        )
        if progress_callback is not None:
            progress_callback(1.0)
        if return_stats:
            return steady, transient, {"rays": n_rays, "spp": total_spp}
        return steady, transient

    film = film_init(film_cfg, film_channels, scan_pixels=hw)
    total_rays = 0.0
    for p in range(n_passes):
        film, n_rays = _nlos_one_pass(
            primal_sd(scene.data), ctx, film, jnp.uint32(seed),
            jnp.uint32(p),
            jnp.float32(1.0 / total_spp),
            film_cfg_=film_cfg, icfg_=icfg, spp_=spp_chunk, hw_=hw,
            polarized_=polarized, spectral_=scene.variant.spectral,
            skip_le_=skip_le,
        )
        total_rays = total_rays + n_rays
        if progress_callback is not None:
            progress_callback((p + 1) / n_passes)
    steady, transient = develop(film, film_cfg,
                                shape_hw=(film_cfg.height, film_cfg.width))
    from ..render import surface_sample_validation

    extra = surface_sample_validation(film, film_cfg)
    if return_stats:
        return steady, transient, {"rays": total_rays, "spp": total_spp,
                                   **extra}
    return steady, transient


@_partial(jax.jit,
          static_argnames=("film_cfg_", "icfg_", "spp_", "hw_", "Lc_",
                           "slab_stride_", "n_chunks_", "L_total_"),
          donate_argnames=("film",))
def _nlos_exhaustive_pass(sd, ctx_, lasers_c, film, seed_, pass_idx,
                          chunk_idx, inv_total, *,
                          film_cfg_, icfg_, spp_, hw_, Lc_, slab_stride_,
                          n_chunks_, L_total_):
    """One (spp-pass, laser-chunk) step of the fused exhaustive capture.
    The film's transient pixel axis is ``n_chunks * slab_stride`` with
    chunk ``c`` owning slots ``[c * slab_stride, c * slab_stride +
    Lc * hw)``; the chunk's sub-film is carved out with a dynamic slice
    (in-place under donation)."""
    from ..film.transient_film import t_pad_of

    C = sd.bsdf.reflectance.shape[-1]
    T_pad = t_pad_of(film_cfg_)
    n = spp_ * hw_
    sampler = Sampler(seed_, n, stream=pass_idx)
    ray, ray_weight = sample_nlos_rays(ctx_, spp_, hw_)
    off = (chunk_idx * slab_stride_).astype(jnp.int32)
    sub = jax.lax.dynamic_slice(
        film.transient, (0, 0, off), (C, T_pad, slab_stride_))
    substate = film._replace(transient=sub)
    substate, L_sum, _valid, n_rays = sample_nlos_exhaustive_primal(
        sd, ctx_, lasers_c, sampler, ray, ray_weight, substate, film_cfg_,
        icfg_, inv_total, spp=spp_, hw=hw_,
    )
    film = film._replace(transient=jax.lax.dynamic_update_slice(
        film.transient, substate.transient, (0, 0, off)))
    # steady: mean over ALL lasers of the per-laser steady — each chunk
    # contributes its partial sum with weight 1/n_chunks so the develop
    # normalization (by total weight = spp) reproduces the mean
    film = splat_steady(
        film, spp_, L_sum * (n_chunks_ / L_total_),
        ray_weight / n_chunks_)
    return film, n_rays


def render_nlos_exhaustive(scene: Scene, spp, seed=0, sensor=0,
                           max_lanes=1 << 21, progress_callback=None,
                           return_stats: bool = False,
                           laser_chunk: int | None = None):
    """Exhaustive NLOS capture: every scan pixel x every laser grid point
    (transientnlospath.py:597-628 + the 6-D film of
    transient_image_block.py:63-68).

    Returns (steady (h, w, C), transient (h, w, lh, lw, T, C)).

    Fused sample sharing (the reference's per-bounce inner laser loop):
    ONE camera-path wavefront feeds every laser slab per pass — path
    sampling is laser-independent, so each slab is bit-compatible with a
    per-point focused single capture while closest hits, BSDF sampling and
    RR are paid once for the whole grid.  The laser grid follows
    ``force_equal_illumination_scanning`` / ``illumination_scan_fov``
    (:126-137, :352-381).  Each laser point is treated as a refocused
    delta laser (see :class:`ExhaustiveLaser`).  Polarized / spectral
    variants and non-delta emitters use the per-point fallback driver.
    """
    import numpy as np

    cfg = scene.sensors[sensor]
    film_cfg = cfg.film
    icfg = scene.integrator
    if not film_cfg.exhaustive_scan:
        raise ValueError("exhaustive capture requires a film with "
                         "exhaustive_scan=True (transient_hdr_film.py:80-88)")
    lw = film_cfg.laser_scan_width
    lh = film_cfg.laser_scan_height
    if lw <= 0 or lh <= 0:
        raise ValueError("laser_scan_width/height must be set for "
                         "exhaustive captures")

    from ..scene.scene import EM_POINT

    kinds = scene.data.emitter.ks.kinds
    delta_laser = kinds and all(k in (EM_PROJECTOR, EM_POINT)
                                for k in kinds)
    if (scene.variant.polarized or scene.variant.spectral
            or not delta_laser or not icfg.nlos_laser_sampling):
        return _render_nlos_exhaustive_perpoint(
            scene, spp, seed=seed, sensor=sensor, max_lanes=max_lanes,
            progress_callback=progress_callback, return_stats=return_stats)

    targets, tvalid = exhaustive_laser_targets(scene, cfg, icfg)
    lasers = prepare_exhaustive_lasers(scene, targets)
    lasers = lasers._replace(
        wall_clear=lasers.wall_clear & jnp.asarray(tvalid))
    L = targets.shape[0]
    h, w = film_cfg.height, film_cfg.width
    hw = h * w
    C = scene.variant.color_channels
    T = film_cfg.temporal_bins

    # the fused loop needs a prepared context for sensor targets / hidden-
    # geometry tables; give prepare a valid laser focus (grid center) if
    # the scene has none — the scalar laser fields are unused here
    if not scene.laser_focused:
        from ..nlos import focus_emitter_at_relay_wall_3dpoint

        # any VALID grid point works (scan misses carry a degenerate
        # target at the emitter origin)
        focus_emitter_at_relay_wall_3dpoint(
            targets[int(np.argmax(tvalid))], scene)
    saved_icfg = scene.integrator
    scene.integrator = icfg._replace(capture_type="single")
    try:
        ctx = prepare_nlos_cached(scene, cfg, sensor)
    finally:
        scene.integrator = saved_icfg

    # spp pass-splitting identical to render_nlos (slabs stay
    # bit-compatible with per-point captures at the same budget)
    spp_chunk = max(1, min(spp, max_lanes // max(hw, 1)))
    n_passes = (spp + spp_chunk - 1) // spp_chunk
    spp_chunk = (spp + n_passes - 1) // n_passes
    total_spp = spp_chunk * n_passes

    # laser-chunking bounds the (Lc x N) NEE intermediates; ~2^24
    # lane-laser pairs keeps them at a few hundred MB
    n_lanes = spp_chunk * hw
    if laser_chunk is None:
        laser_chunk = max(1, min(L, (1 << 24) // max(n_lanes, 1)))
    Lc = laser_chunk
    n_chunks = (L + Lc - 1) // Lc
    L_pad = n_chunks * Lc
    if L_pad > L:
        # padded rows: zeroed via wall_clear so they contribute nothing
        pad = L_pad - L
        lasers = jax.tree_util.tree_map(
            lambda a: jnp.concatenate(
                [a, jnp.repeat(a[-1:], pad, axis=0)], axis=0), lasers)
        lasers = lasers._replace(
            wall_clear=lasers.wall_clear.at[L:].set(False))

    from ..film.transient_film import t_pad_of

    slab_stride = Lc * hw
    film = TransientFilmState(
        steady=jnp.zeros((hw, C), jnp.float32),
        steady_weight=jnp.zeros((hw,), jnp.float32),
        transient=jnp.zeros((C, t_pad_of(film_cfg), n_chunks * slab_stride),
                            jnp.float32),
        n_negative=jnp.zeros((), jnp.float32),
        n_invalid=jnp.zeros((), jnp.float32),
    )

    from ..scene.scene import primal_sd

    sdp = primal_sd(scene.data)
    total_rays = 0.0
    step = 0
    for c in range(n_chunks):
        lasers_c = jax.tree_util.tree_map(
            lambda a: jax.lax.dynamic_slice_in_dim(a, c * Lc, Lc, axis=0),
            lasers)
        for p in range(n_passes):
            film, n_rays = _nlos_exhaustive_pass(
                sdp, ctx, lasers_c, film, jnp.uint32(seed), jnp.uint32(p),
                jnp.uint32(c), jnp.float32(1.0 / total_spp),
                film_cfg_=film_cfg, icfg_=icfg, spp_=spp_chunk, hw_=hw,
                Lc_=Lc, slab_stride_=slab_stride, n_chunks_=n_chunks,
                L_total_=L,
            )
            total_rays = total_rays + float(n_rays)
            step += 1
            if progress_callback is not None:
                progress_callback(step / (n_chunks * n_passes))

    # develop: steady normalization + 6-D assembly on host
    wgt = np.asarray(film.steady_weight)
    wgt = np.where(wgt == 0.0, 1.0, wgt)
    steady = (np.asarray(film.steady) / wgt[:, None]).reshape(h, w, C)
    tr = np.asarray(film.transient)  # (C, T_pad, n_chunks*slab_stride)
    out = np.zeros((h, w, lh, lw, T, C), np.float32)
    for c in range(n_chunks):
        blk = tr[:, :T, c * slab_stride : c * slab_stride + Lc * hw]
        blk = blk.reshape(C, T, Lc, hw)
        for l_loc in range(Lc):
            i = c * Lc + l_loc
            if i >= L:
                break
            ly, lx = divmod(i, lw)
            out[:, :, ly, lx] = np.transpose(
                blk[:, :, l_loc, :], (2, 1, 0)).reshape(h, w, T, C)
    if return_stats:
        return steady, out, {"rays": total_rays, "spp": spp * L}
    return steady, out


def _render_nlos_exhaustive_perpoint(scene: Scene, spp, seed=0, sensor=0,
                                     max_lanes=1 << 21,
                                     progress_callback=None,
                                     return_stats: bool = False):
    """Per-illumination-point fallback driver (polarized / spectral /
    non-delta emitters): each grid point is rendered as a focused single
    capture with the *same* seed — the sample-sharing structure of the
    reference's inner laser loop, expressed as an outer loop over laser
    points (identical estimator; contributions for laser point (lx, ly)
    land in slab [:, :, ly, lx]).
    """
    import numpy as np

    cfg = scene.sensors[sensor]
    film_cfg = cfg.film
    if not film_cfg.exhaustive_scan:
        raise ValueError("exhaustive capture requires a film with "
                         "exhaustive_scan=True (transient_hdr_film.py:80-88)")
    lw = film_cfg.laser_scan_width
    lh = film_cfg.laser_scan_height
    if lw <= 0 or lh <= 0:
        raise ValueError("laser_scan_width/height must be set for "
                         "exhaustive captures")

    wall_shape = scene.shapes[cfg.shape_index]
    px, py = np.meshgrid(np.arange(lw), np.arange(lh))
    uv = np.stack([(px.ravel() + 0.5) / lw, (py.ravel() + 0.5) / lh], -1)
    laser_targets = wall_shape.position_from_uv(uv).astype(np.float32)

    h, w = film_cfg.height, film_cfg.width
    # channel count includes the 4 Stokes components in polarized variants
    C = scene.variant.color_channels * (4 if scene.variant.polarized else 1)
    T = film_cfg.temporal_bins
    out = np.zeros((h, w, lh, lw, T, C), np.float32)
    steady_acc = np.zeros((h, w, C), np.float32)
    total_rays = 0.0

    from ..nlos import focus_emitter_at_relay_wall_3dpoint

    n_pts = lh * lw
    # render each illumination point as a focused single capture
    saved_icfg = scene.integrator
    scene.integrator = saved_icfg._replace(capture_type="single")
    try:
        for i in range(n_pts):
            focus_emitter_at_relay_wall_3dpoint(laser_targets[i], scene)
            s, t, stats = render_nlos(
                scene, spp=spp, seed=seed, sensor=sensor, max_lanes=max_lanes,
                return_stats=True)
            ly, lx = divmod(i, lw)
            # average over illumination points (transientnlospath.py:628)
            out[:, :, ly, lx] = np.asarray(t)
            steady_acc += np.asarray(s) / n_pts
            total_rays += float(stats["rays"])
            if progress_callback is not None:
                progress_callback((i + 1) / n_pts)
    finally:
        scene.integrator = saved_icfg

    if return_stats:
        return steady_acc, out, {"rays": total_rays, "spp": spp * n_pts}
    return steady_acc, out
