"""Transient volumetric path tracer (``transient_prbvolpath`` parity).

JAX re-design of the reference's volumetric PRB integrator
(/root/reference/mitransient/integrators/transient_prbvolpath.py): transient
path tracing through homogeneous participating media bounded by null-BSDF
shapes, with analytic free-flight sampling, Henyey–Greenstein phase
scattering, NEE with medium transmittance, and OPL accumulation at both
medium and surface events.

Correspondences (reference line -> here):
* free-flight sampling + real/null event classification (:186-239) — for
  homogeneous media the delta-tracking loop collapses to the closed-form
  exponential sample, a branch-free single step
* distance += mei.t * eta at medium scatters (:229), si.t * eta at
  surfaces (:258)
* transient splats at emitter hits (:282-283) and NEE (:329-331)
* NEE transmittance estimation through null boundaries — the reference's
  ratio-tracking loop (:413-512) becomes a fixed-step null-crossing walk
  with analytic exp(-sigma_t * segment) factors (exact for homogeneous
  media, no variance)
* HG phase sampling (:333-360); medium transitions at null surfaces
  (si.target_medium semantics)
* no forward mode, detached sampling, no shape gradients (docstring :40-48)

Media are attached as shape interiors (cbox_volumetric.xml:99-120); the
per-lane medium is tracked as an index into the medium table, switching on
null-boundary crossings by the sign of dot(d, n).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..bsdf import api as bsdf_api
from ..core import spectra as _sp
from ..core.mueller import mueller_product
from ..core.math import dot, mis_weight
from ..core.records import Ray
from ..core.rng import Sampler
from ..core.warp import hg_pdf, square_to_hg
from ..film.transient_film import TransientFilmState, splat_pair_any
from ..ops.gather import columns_lookup
from ..scene.scene import (
    SceneData,
    emitter_eval_hit,
    pdf_emitter_direction,
    ray_intersect,
    sample_emitter_direction,
)
from ..scene.schema import FilmConfig, IntegratorConfig

VOL_DIMS_PER_BOUNCE = 8
TRANSMITTANCE_STEPS = 4  # max null-boundary crossings along a shadow ray
DELTA_STEPS = 32  # majorant-sampled candidates per heterogeneous free-flight
RATIO_STEPS = 16  # ratio-tracking taps per heterogeneous shadow segment
GRID_STREAM_TAG = 0x6D50  # rng sub-stream for the tracking loops


def _sctx_film(sctx, v, polarized: bool):
    """Spectral splat conversion: per-Stokes-row sRGB when polarized."""
    return sctx.to_film_stokes(v) if polarized else sctx.to_film(v)


def first_surface_distance(sd: SceneData, ray: Ray,
                           max_hops: int = 8) -> jnp.ndarray:
    """Distance along each camera ray to the first NON-null surface,
    walking through null (medium-boundary) BSDFs — the ``camera_unwarp``
    origin shift of the reference's volumetric integrator
    (transient_prbvolpath.py:514-528: first_surface; consumed at :161-162
    as ``distance = -first_surface(...)``).

    A bounded ``fori_loop`` over at most ``max_hops`` null crossings (the
    reference's while-loop is data-dependent; nested media in practice need
    only a few)."""
    from ..bsdf.api import BSDF_NULL

    n = ray.o.shape[0]

    def hop(_, st):
        o, dist, act = st
        si = ray_intersect(sd, Ray.make(o, ray.d), act)
        ok = act & si.valid
        dist = dist + jnp.where(ok, si.t, 0.0)
        kind = jnp.take(sd.bsdf.kind, jnp.maximum(si.bsdf_id, 0), axis=0)
        act = ok & (kind == BSDF_NULL)
        o = jnp.where(act[:, None], si.p + ray.d * 2e-4, o)
        return (o, dist, act)

    _, dist, _ = jax.lax.fori_loop(
        0, max_hops, hop,
        (ray.o, jnp.zeros((n,), jnp.float32), jnp.ones((n,), bool)))
    return dist


def _has_grids(sd: SceneData) -> bool:
    """Static (shape-level) test: does any medium carry a density grid?"""
    return sd.medium.grid.shape[1:] != (1, 1, 1)


def _density(sd: SceneData, med_id, p):
    """Trilinear density lookup for each lane's medium at world point p.
    Homogeneous media (constant-1 grids) return 1."""
    m = jnp.maximum(med_id, 0)
    w2l = sd.medium.grid_w2l[m]  # (N, 3, 4); M is tiny so gather is cheap
    local = jnp.einsum("nij,nj->ni", w2l[:, :, :3], p,
                       precision=jax.lax.Precision.HIGHEST) + w2l[:, :, 3]
    grid = sd.medium.grid
    gz, gy, gx = grid.shape[1:]
    # local (x, y, z) in [0,1] -> voxel coords
    fx = jnp.clip(local[:, 0], 0.0, 1.0) * (gx - 1)
    fy = jnp.clip(local[:, 1], 0.0, 1.0) * (gy - 1)
    fz = jnp.clip(local[:, 2], 0.0, 1.0) * (gz - 1)
    x0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, max(gx - 2, 0))
    y0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, max(gy - 2, 0))
    z0 = jnp.clip(jnp.floor(fz).astype(jnp.int32), 0, max(gz - 2, 0))
    tx = fx - x0
    ty = fy - y0
    tz = fz - z0
    x1 = jnp.minimum(x0 + 1, gx - 1)
    y1 = jnp.minimum(y0 + 1, gy - 1)
    z1 = jnp.minimum(z0 + 1, gz - 1)

    def tap(z, y, x):
        return grid[m, z, y, x]

    c00 = tap(z0, y0, x0) * (1 - tx) + tap(z0, y0, x1) * tx
    c01 = tap(z0, y1, x0) * (1 - tx) + tap(z0, y1, x1) * tx
    c10 = tap(z1, y0, x0) * (1 - tx) + tap(z1, y0, x1) * tx
    c11 = tap(z1, y1, x0) * (1 - tx) + tap(z1, y1, x1) * tx
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz


def _delta_track_flight(sd, key, tag, med_id, in_medium, o, d, t_surf,
                        active):
    """Heterogeneous free-flight via delta (Woodcock) tracking against the
    per-medium majorant (reference transient_prbvolpath.py:186-239 null
    scattering reformulated as a fixed-trip masked loop).  Returns
    (t_fly (N,), did_scatter mask is t_fly < t_surf)."""
    n = med_id.shape[0]
    m = jnp.maximum(med_id, 0)
    maj = jnp.where(in_medium, sd.medium.majorant[m], 0.0)
    scale = sd.medium.sigma_t[m]
    k = jax.random.fold_in(key, jnp.uint32(GRID_STREAM_TAG) + tag)
    u = jax.random.uniform(k, (n, DELTA_STEPS, 2))

    def step(i, carry):
        t, done = carry
        tt = t - jnp.log(jnp.maximum(1.0 - u[:, i, 0], 1e-30)) / jnp.maximum(
            maj, 1e-30)
        escaped = tt >= t_surf
        dens = _density(sd, med_id, o + d * tt[:, None])
        real = u[:, i, 1] * maj < scale * dens
        new_done = done | escaped | real
        t = jnp.where(done, t, tt)
        return t, new_done

    walk = active & in_medium & (maj > 0.0)
    t0 = jnp.zeros((n,), jnp.float32)
    t_fly, done = jax.lax.fori_loop(
        0, DELTA_STEPS, step, (t0, ~walk))
    # unresolved lanes after DELTA_STEPS majorant flights: treat as escaped
    # (probability ~(1-min_density)^32, and the bias is toward transparency)
    t_fly = jnp.where(walk, jnp.where(done, t_fly, jnp.inf), jnp.inf)
    return t_fly


def _segment_transmittance(sd, key, tag, med_id, o, d, seg, active):
    """Transmittance across one medium segment: analytic for homogeneous
    scenes, single-sample ratio tracking for grid media (reference
    sample_emitter's ratio-tracking loop, transient_prbvolpath.py:459-481)."""
    m = jnp.maximum(med_id, 0)
    in_medium = med_id >= 0
    if not _has_grids(sd):
        sigma_t = jnp.where(in_medium, sd.medium.sigma_t[m], 0.0)
        return jnp.exp(-sigma_t * jnp.where(active, seg, 0.0))
    assert key is not None, "grid media need an rng key for ratio tracking"
    n = med_id.shape[0]
    maj = jnp.where(in_medium, sd.medium.majorant[m], 0.0)
    scale = sd.medium.sigma_t[m]
    k = jax.random.fold_in(key, jnp.uint32(GRID_STREAM_TAG) + tag)
    u = jax.random.uniform(k, (n, RATIO_STEPS))

    def step(i, carry):
        t, T = carry
        tt = t - jnp.log(jnp.maximum(1.0 - u[:, i], 1e-30)) / jnp.maximum(
            maj, 1e-30)
        inside = tt < seg
        dens = _density(sd, med_id, o + d * tt[:, None])
        ratio = jnp.clip(1.0 - scale * dens / jnp.maximum(maj, 1e-30),
                         0.0, 1.0)
        T = T * jnp.where(inside & (maj > 0.0), ratio, 1.0)
        return jnp.where(inside, tt, t), T

    _, T = jax.lax.fori_loop(
        0, RATIO_STEPS, step,
        (jnp.zeros((n,), jnp.float32), jnp.ones((n,), jnp.float32)))
    return jnp.where(active & in_medium & (maj > 0.0), T,
                     jnp.where(active, 1.0, 1.0))


def _medium_lookup(sd: SceneData, med_id):
    i = jnp.maximum(med_id, 0)
    cols = columns_lookup(
        {"sigma_t": sd.medium.sigma_t, "albedo": sd.medium.albedo,
         "g": sd.medium.g}, i,
    )
    in_medium = med_id >= 0
    sigma_t = jnp.where(in_medium, cols["sigma_t"], 0.0)
    return sigma_t, cols["albedo"], cols["g"], in_medium


def _transition(sd: SceneData, si, d, current_med):
    """Medium transition at a null boundary: entering (dot(d, n) < 0) ->
    the shape's interior medium; exiting -> vacuum."""
    tri_med = jnp.round(
        columns_lookup(
            {"m": sd.tri.medium_id.astype(jnp.float32)},
            jnp.maximum(si.prim, 0),
        )["m"]
    ).astype(jnp.int32)
    entering = dot(d, si.n) < 0.0
    return jnp.where(entering, tri_med, -1)


def transmittance(sd: SceneData, o, d_unit, dist, start_med, active,
                  key=None, tag=0):
    """Transmittance along a shadow ray crossing up to TRANSMITTANCE_STEPS
    null boundaries; analytic exp(-sigma_t*seg) per homogeneous segment,
    ratio tracking per grid segment (needs ``key``).  Returns
    (T (N,), occluded (N,))."""
    n = dist.shape[0]
    T = jnp.ones((n,), jnp.float32)
    med = start_med
    t_done = jnp.zeros((n,), jnp.float32)
    occluded = jnp.zeros((n,), bool)
    walking = active

    for step in range(TRANSMITTANCE_STEPS):
        o_cur = o + d_unit * t_done[:, None]
        remaining = dist - t_done
        si = ray_intersect(
            sd, Ray.make(o_cur + d_unit * 1e-4, d_unit,
                         maxt=remaining - 2e-4),
            walking,
        )
        seg = jnp.where(si.valid, si.t, jnp.maximum(remaining, 0.0))
        T_seg = _segment_transmittance(
            sd, key, 1000 + tag * TRANSMITTANCE_STEPS + step,
            med, o_cur, d_unit, seg, walking)
        T = T * jnp.where(walking, T_seg, 1.0)
        lb = bsdf_api.gather_lane_bsdf(sd.bsdf, si.bsdf_id, si.uv)
        is_null = bsdf_api.is_null(lb)
        blocked = walking & si.valid & ~is_null
        occluded = occluded | blocked
        # continue through null boundaries, switching media
        med = jnp.where(walking & si.valid & is_null,
                        _transition(sd, si, d_unit, med), med)
        t_done = t_done + jnp.where(si.valid, si.t + 1e-4, remaining)
        walking = walking & si.valid & is_null
    # any remaining unresolved walkers treated as occluded (very deep nesting)
    occluded = occluded | walking
    return T, occluded


def sample_volpath_primal(
    sd: SceneData,
    sampler: Sampler,
    ray: Ray,
    pix: jnp.ndarray,
    ray_weight: jnp.ndarray,
    film: TransientFilmState,
    film_cfg: FilmConfig,
    icfg: IntegratorConfig,
    sample_scale,
    base_dim: int,
    spp: int,
    spectral: bool = False,
    polarized: bool = False,
    cam_vertical: jnp.ndarray | None = None,
    enable_film: bool = True,
):
    """The volumetric wavefront loop (primal).  Returns
    (film, L, valid, n_rays) like sample_primal.

    ``spectral=True`` carries N_WL hero wavelengths per lane (same machinery
    as sample_primal); medium albedo uplifts to the lane wavelengths while
    sigma_t stays achromatic (density grids are scalar), and splats convert
    to sRGB so the film stays 3-channel.

    ``polarized=True`` runs the Mueller-matrix throughput chain
    (beta (N, 4, 4, C), camera-first composition like sample_primal):
    surface events use the full polarized BSDF factors; medium (HG phase)
    scattering is treated as an ideal depolarizer (HG is a scalar phase
    function — the same model Mitsuba's polarized volpath uses via
    mueller.depolarizer); absorption is polarization-neutral.  This EXCEEDS
    the reference, whose transient_prbvolpath is unpolarized
    (transient_prbvolpath.py docstring :40-48)."""
    n = pix.shape[0]
    C = sd.bsdf.reflectance.shape[-1]
    key = sampler.key
    splat_w = ray_weight * sample_scale

    sctx = None
    if spectral:
        sctx = _sp.SpectralCtx.make(key, n)
        C = _sp.N_WL

    if polarized:
        from ..bsdf.polarized import sensor_alignment_soa

        vert = cam_vertical if cam_vertical is not None else jnp.array(
            [0.0, 1.0, 0.0])
        # SoA Mueller throughput (tuple of 16 (N, C) arrays)
        beta0 = sensor_alignment_soa(ray.d, vert, C)
        L0 = jnp.zeros((n, 4 * C), jnp.float32)
    else:
        beta0 = jnp.ones((n, C), jnp.float32)
        L0 = jnp.zeros((n, C), jnp.float32)

    # camera_unwarp: shift the time origin to the first real surface
    # (through null medium boundaries), transient_prbvolpath.py:161-162
    distance0 = (-first_surface_distance(sd, ray) if icfg.camera_unwarp
                 else jnp.zeros((n,), jnp.float32))

    state = dict(
        o=ray.o, d=ray.d,
        beta=beta0,
        L=L0,
        eta=jnp.ones((n,), jnp.float32),
        distance=distance0,
        active=jnp.ones((n,), bool),
        depth=jnp.zeros((n,), jnp.int32),
        medium=jnp.full((n,), -1, jnp.int32),
        prev_p=ray.o,
        prev_pdf=jnp.ones((n,), jnp.float32),
        prev_delta=jnp.ones((n,), bool),
        film=film,
        n_rays=jnp.zeros((), jnp.float32),
    )

    def bounce(it, st):
        from ..core.rng import draw_bounce_block

        ub = draw_bounce_block(key, it, n, VOL_DIMS_PER_BOUNCE)

        def rnd1(k):
            return ub[:, k]

        def rnd2(k):
            return ub[:, k : k + 2]

        active = st["active"]
        si = ray_intersect(sd, Ray.make(st["o"], st["d"]), active)
        hit = active & si.valid

        # ---- free-flight sampling in the current medium (dim 0) ----------
        sigma_t, med_albedo, med_g, in_medium = _medium_lookup(
            sd, st["medium"])
        if sctx is not None:
            med_albedo = sctx.uplift(med_albedo)
        if _has_grids(sd):
            # heterogeneous: delta tracking against the majorant
            t_fly = _delta_track_flight(
                sd, key, it, st["medium"], in_medium, st["o"], st["d"],
                jnp.where(hit, si.t, jnp.inf), active)
        else:
            u_ff = rnd1(0)
            t_fly = jnp.where(
                in_medium & (sigma_t > 0.0),
                -jnp.log(jnp.maximum(1.0 - u_ff, 1e-30))
                / jnp.maximum(sigma_t, 1e-30),
                jnp.inf,
            )
        # Detached sampling (PRB): the sampled flight distance carries no
        # derivative; sigma_t differentiates through the attached survival
        # ratio below (homogeneous) — grid-density sigma_t is not
        # differentiated (delta tracking's collision chain is detached).
        t_fly = jax.lax.stop_gradient(t_fly)
        medium_scatter = hit & in_medium & (t_fly < si.t)

        # event position + OPL
        t_event = jnp.where(medium_scatter, t_fly, jnp.where(hit, si.t, 0.0))
        p_event = st["o"] + st["d"] * t_event[:, None]
        distance = st["distance"] + jnp.where(active, t_event, 0.0) * st["eta"]

        if not _has_grids(sd):
            # Attached survival-weight ratio for differentiable sigma_t
            # (detached-sampling PRB, cf. transient_prbvolpath's attached
            # medium factors): medium scatter w = sigma_t e^{-sigma_t t} /
            # pdf_detached; escape through the medium to a surface
            # w = e^{-sigma_t t_surf} / P_detached.  Primal value is exactly
            # 1 — only d/d(sigma_t) is nonzero.
            lam = jax.lax.stop_gradient(sigma_t)
            t_det = jax.lax.stop_gradient(t_event)
            dsig = sigma_t - lam
            decay = jnp.exp(-dsig * jnp.where(jnp.isfinite(t_det), t_det,
                                              0.0))
            r_scatter = sigma_t / jnp.maximum(lam, 1e-30) * decay
            ff_ratio = jnp.where(
                medium_scatter, r_scatter,
                jnp.where(in_medium & hit, decay, 1.0))
            st = dict(st)
            if polarized:
                st["beta"] = tuple(e * ff_ratio[:, None]
                                   for e in st["beta"])
            else:
                st["beta"] = st["beta"] * ff_ratio[:, None]

        lb = bsdf_api.gather_lane_bsdf(sd.bsdf, si.bsdf_id, si.uv)
        if sctx is not None:
            lb = sctx.uplift_lb(lb)
        is_null_srf = bsdf_api.is_null(lb) & ~medium_scatter

        # throughput update for scattering events: analog MC, beta *= albedo
        # at real medium scatters (sigma_s / sigma_t).  Polarized: the HG
        # scatter also depolarizes (beta @ depolarizer keeps column 0 only).
        if polarized:
            # HG scatter depolarizes: keep only column 0 (entries 4i),
            # scaled by the albedo
            ms = medium_scatter[:, None]
            beta = tuple(
                jnp.where(
                    ms,
                    (st["beta"][(k // 4) * 4] * med_albedo
                     if k % 4 == 0 else 0.0),
                    st["beta"][k])
                for k in range(16))
        else:
            beta = jnp.where(medium_scatter[:, None], st["beta"] * med_albedo,
                             st["beta"])

        # ---- direct emission at surfaces (not at medium events) ----------
        pdf_em_hit = pdf_emitter_direction(sd, st["prev_p"], si)
        pdf_em_hit = jnp.where(st["prev_delta"], 0.0, pdf_em_hit)
        mis = mis_weight(st["prev_pdf"], pdf_em_hit)
        Le_raw = emitter_eval_hit(sd, si, st["d"])
        if sctx is not None:
            Le_raw = sctx.emission(Le_raw)
        le_mask = hit & ~medium_scatter & ~jnp.bool_(icfg.discard_direct_light)
        if polarized:
            # emission is unpolarized: Stokes = E * mis * column 0 of the
            # Mueller throughput (SoA entries 4i)
            w_le = mis[:, None] * Le_raw
            Le = jnp.where(
                le_mask[:, None],
                jnp.concatenate(
                    [st["beta"][4 * i] * w_le for i in range(4)], axis=-1),
                0.0,
            )
        else:
            Le = jnp.where(
                le_mask[:, None], st["beta"] * mis[:, None] * Le_raw, 0.0)

        active_next = active & (it + 1 < icfg.max_depth) & si.valid

        # ---- NEE (dims 1-2): from medium points (phase) or surfaces ------
        scatter_event = medium_scatter | (hit & ~is_null_srf)
        active_em = active_next & scatter_event & (
            medium_scatter | bsdf_api.is_smooth(lb))
        ds, em_weight = sample_emitter_direction(
            sd, p_event, rnd2(1), False, active_em  # visibility via
        )                                            # transmittance below
        if sctx is not None:
            em_weight = sctx.emission(em_weight)
        active_em = active_em & (ds.pdf > 0.0)
        trans, occ = transmittance(
            sd, p_event, ds.d, ds.dist, st["medium"], active_em,
            key=key, tag=it)
        active_em = active_em & ~occ

        # scatter kernel toward the light: phase (medium) or BSDF (surface)
        cos_ph = dot(st["d"], ds.d)
        f_phase = hg_pdf(cos_ph, med_g)[:, None] * jnp.ones((n, C))
        pdf_phase = hg_pdf(cos_ph, med_g)
        wo_em = si.frame.to_local(ds.d)
        f_srf, pdf_srf = bsdf_api.eval_pdf(lb, si.wi, wo_em, active_em)
        f_em = jnp.where(medium_scatter[:, None], f_phase, f_srf)
        pdf_for_mis = jnp.where(medium_scatter, pdf_phase, pdf_srf)
        mis_em = jnp.where(ds.delta, 1.0, mis_weight(ds.pdf, pdf_for_mis))
        if polarized:
            from ..bsdf.polarized import polarization_factor_col0_soa
            from ..core.mueller import msoa_matvec

            # surface lanes: column 0 of the polarized BSDF factor (NEE
            # sources are unpolarized -> one matvec); medium lanes: the
            # HG scatter depolarizes, so the NEE Stokes is column 0 of the
            # throughput times the scalar phase value
            m_h = si.wi + wo_em
            m_h = m_h / jnp.maximum(
                jnp.linalg.norm(m_h, axis=-1, keepdims=True), 1e-12)
            cos_i_em = jnp.abs(jnp.sum(si.wi * m_h, axis=-1))
            P0 = polarization_factor_col0_soa(lb, -ds.d, -st["d"], cos_i_em)
            A_srf = msoa_matvec(beta, tuple(e * f_srf for e in P0))
            ms = medium_scatter[:, None]
            A = tuple(
                jnp.where(ms, beta[4 * i] * f_phase, A_srf[i])
                for i in range(4))
            w_em = mis_em[:, None] * em_weight * trans[:, None]
            Lr_dir = jnp.where(
                active_em[:, None],
                jnp.concatenate([a * w_em for a in A], axis=-1),
                0.0,
            )
        else:
            Lr_dir = jnp.where(
                active_em[:, None],
                beta * mis_em[:, None] * f_em * em_weight * trans[:, None],
                0.0,
            )

        if enable_film:
            Le_f = _sctx_film(sctx, Le, polarized) if sctx is not None else Le
            Lr_f = _sctx_film(sctx, Lr_dir, polarized) if sctx is not None else Lr_dir
            film_st = splat_pair_any(
                st["film"], film_cfg, spp,
                distance, Le_f * splat_w[:, None],
                distance + ds.dist * st["eta"], Lr_f * splat_w[:, None],
                active,
                icfg.temporal_filter, icfg.gaussian_stddev,
            )
        else:
            film_st = st["film"]

        # ---- direction sampling (dims 3-5) --------------------------------
        # medium: HG about the current direction; surface: BSDF sample;
        # null surface: pass straight through and switch medium
        d_hg_local, pdf_hg = square_to_hg(rnd2(4), med_g)
        from ..core.frame import Frame

        frame_d = Frame.from_normal(st["d"])
        d_hg = frame_d.to_world(d_hg_local)

        bs = bsdf_api.sample(lb, si.wi, rnd1(3), rnd2(4),
                             active_next & ~medium_scatter)
        d_srf = si.frame.to_world(bs.wo)

        new_d = jnp.where(medium_scatter[:, None], d_hg, d_srf)
        new_o = jnp.where(
            medium_scatter[:, None],
            p_event,
            si.spawn_ray(d_srf).o,
        )
        w_step = jnp.where(medium_scatter[:, None], jnp.ones((n, C)),
                           bs.weight)
        pdf_step = jnp.where(medium_scatter, pdf_hg, bs.pdf)
        delta_step = jnp.where(medium_scatter, False, bs.delta)
        eta_step = jnp.where(medium_scatter, 1.0, bs.eta)
        if polarized:
            from ..bsdf.polarized import polarization_factor_soa
            from ..core.mueller import msoa_product, msoa_where

            m_hs = si.wi + bs.wo
            m_hs = m_hs / jnp.maximum(
                jnp.linalg.norm(m_hs, axis=-1, keepdims=True), 1e-12)
            cos_i_s = jnp.where(
                bs.delta, jnp.abs(si.wi[:, 2]),
                jnp.abs(jnp.sum(si.wi * m_hs, axis=-1)))
            transmitted = bs.wo[:, 2] * si.wi[:, 2] < 0.0
            P_s = polarization_factor_soa(lb, -d_srf, -st["d"], cos_i_s,
                                          transmitted=transmitted)
            M_w = tuple(e * bs.weight for e in P_s)
            beta_srf = msoa_product(beta, M_w)
            # medium lanes already depolarized+albedo'd above; HG importance
            # sampling has unit weight -> throughput unchanged
            M_step = msoa_where(medium_scatter[:, None], beta, beta_srf)

        # medium switch at null boundaries
        new_med = jnp.where(
            hit & ~medium_scatter & bsdf_api.is_null(lb),
            _transition(sd, si, st["d"], st["medium"]),
            st["medium"],
        )

        L = st["L"] + Le + Lr_dir
        if polarized:
            from ..core.mueller import msoa_where as _mw

            beta = _mw(active_next[:, None], M_step, beta)
            beta_max = jax.lax.stop_gradient(jnp.max(beta[0], axis=-1))
        else:
            beta = jnp.where(active_next[:, None], beta * w_step, beta)
            beta_max = jax.lax.stop_gradient(jnp.max(beta, axis=-1))
        eta = jnp.where(active_next, st["eta"] * eta_step, st["eta"])

        # ---- RR (detached sampling decision; keeps full-loop AD sane) -----
        active_next = active_next & (beta_max != 0.0)
        rr_prob = jnp.minimum(beta_max * eta * eta, 0.95)
        active_next = active_next & (rr_prob > 0.0)
        rr_active = it >= icfg.rr_depth
        rr_scale = jnp.where((rr_active & active_next) & (rr_prob > 0.0),
                             1.0 / jnp.maximum(rr_prob, 1e-6), 1.0)
        rr_b = jax.lax.stop_gradient(rr_scale)[:, None]
        if polarized:
            beta = tuple(e * rr_b for e in beta)
        else:
            beta = beta * rr_b
        rr_continue = rnd1(7) < rr_prob
        active_next = active_next & (~rr_active | rr_continue)

        return dict(
            o=new_o, d=new_d, beta=beta, L=L, eta=eta,
            distance=distance, active=active_next,
            depth=st["depth"] + jnp.where(scatter_event, 1, 0),
            medium=new_med,
            # null crossings must NOT update the previous-scatter records
            # (the MIS pdf refers to the last real scattering event)
            prev_p=jnp.where(scatter_event[:, None], p_event, st["prev_p"]),
            prev_pdf=jnp.where(active_next & scatter_event, pdf_step,
                               st["prev_pdf"]),
            prev_delta=jnp.where(active_next & scatter_event, delta_step,
                                 st["prev_delta"]),
            film=film_st,
            n_rays=st["n_rays"]
            + jnp.sum(active.astype(jnp.float32)) * (1 + TRANSMITTANCE_STEPS),
        )

    final = jax.lax.fori_loop(0, icfg.max_depth, bounce, state)
    L_out = _sctx_film(sctx, final["L"], polarized) if sctx is not None else final["L"]
    return final["film"], L_out, final["depth"] > 0, final["n_rays"]
