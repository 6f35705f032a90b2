"""Transient path tracer (primal sweep).

JAX re-design of the reference's ``TransientPath`` integrator
(/root/reference/mitransient/integrators/transientpath.py:88-326): the same
light-transport estimator — path tracing with next-event estimation, power
-heuristic MIS, optical-path-length tracking and per-bounce transient
splatting — expressed as a dense masked wavefront inside
``jax.lax.fori_loop`` under ``jit`` instead of a Dr.Jit symbolic loop.

Key correspondences (reference line -> here):
* distance accumulation ``distance += si.t * eta``   (:154)
* camera_unwarp subtracts the first-hit distance     (:133-138)
* emitter-hit MIS vs previous-bounce BSDF pdf        (:166-180)
* NEE splat at ``distance + ds.dist * eta``          (:216-218)
* russian roulette from ``rr_depth``                 (:250-257)
* per-lane L accumulates the steady image sample     (:230)

RNG discipline: each bounce consumes exactly 6 sampler dimensions
(NEE 2, BSDF 3, RR 1) at ``base + it * 6``, making the PRB replay sweep
(prb.py) reproduce the primal path exactly without storing it.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..bsdf import api as bsdf_api
from ..core import spectra as _sp
from ..core.mueller import mueller_product
from ..core.math import mis_weight
from ..core.records import Ray
from ..core.rng import Sampler
from ..film.transient_film import TransientFilmState, splat_pair_any
from ..scene.scene import (
    SceneData,
    emitter_eval_hit,
    pdf_emitter_direction,
    ray_intersect,
    sample_emitter_direction,
)
from ..scene.schema import FilmConfig, IntegratorConfig

DIMS_PER_BOUNCE = 6


class PathState(NamedTuple):
    o: jnp.ndarray  # (N, 3)
    d: jnp.ndarray  # (N, 3)
    beta: jnp.ndarray  # (N, C)
    L: jnp.ndarray  # (N, C)
    eta: jnp.ndarray  # (N,)
    distance: jnp.ndarray  # (N,) accumulated OPL
    active: jnp.ndarray  # (N,) bool
    depth: jnp.ndarray  # (N,) int32 — valid-bounce count (alpha flag)
    prev_p: jnp.ndarray  # (N, 3)
    prev_pdf: jnp.ndarray  # (N,)
    prev_delta: jnp.ndarray  # (N,) bool
    film: TransientFilmState
    n_rays: jnp.ndarray  # () f32 — closest-hit + shadow rays actually traced
    # polarized only: pending-rotator carry (cos 2a, sin 2a) with TRUE
    # Mueller throughput = stored beta @ R(pend) (core/mueller.py
    # "Structured right-applies"); () when unpolarized
    pend: tuple = ()


def sample_primal(
    sd: SceneData,
    sampler: Sampler,
    ray: Ray,
    pix: jnp.ndarray,
    ray_weight: jnp.ndarray,
    film: TransientFilmState,
    film_cfg: FilmConfig,
    icfg: IntegratorConfig,
    sample_scale: float,
    base_dim: int,
    spp: int,
    initial_distance: jnp.ndarray | None = None,
    enable_film: bool = True,
    polarized: bool = False,
    cam_vertical: jnp.ndarray | None = None,
    spectral: bool = False,
):
    """Trace one wavefront; returns (film', L (N, C), valid (N,)).

    ``sample_scale`` = ray_weight-independent 1/total_spp factor applied to
    every transient splat (common.py:411-422); the steady image instead gets
    the raw per-lane L splatted once by the caller.
    ``initial_distance`` seeds the OPL (NLOS: laser->wall OPL arrives via
    ray.time, transientnlospath.py:718).

    ``polarized=True`` switches the throughput to a Mueller-matrix chain
    (beta (N, 4, 4, C), composed camera-first as beta @ M like Mitsuba's
    polarized Spectrum product) aligned to the sensor's vertical axis at the
    first vertex (reference utils.py:9-21); contributions become Stokes
    vectors and the film carries 4*C channels (transient_image_block.py:90-99
    channel packing).

    ``spectral=True`` gives every lane N_WL hero wavelengths sampled from
    the visible-range proposal (core/spectra.py; mirrors
    mi.sample_rgb_spectrum + sample_shifted): the BSDF table is uplifted to
    those wavelengths once per bounce so all C-channel code below runs
    unchanged with C = N_WL, and contributions convert to sRGB at splat
    time exactly like the reference's spectrum_to_srgb block packing
    (transient_image_block.py:91).
    """
    n = pix.shape[0]
    C = sd.bsdf.reflectance.shape[-1]
    key = sampler.key

    if spectral:
        sctx = _sp.SpectralCtx.make(key, n)
        C = _sp.N_WL
        _spectral_lb = sctx.uplift_lb
        _spectral_emission = sctx.emission
        # spectral_polarized: contributions are packed Stokes vectors
        # (n, 4*N_WL); each Stokes row converts to sRGB independently (the
        # Mueller chain is per-wavelength: uplifted eta tables give
        # per-wavelength Fresnel)
        _to_film = sctx.to_film_stokes if polarized else sctx.to_film

    distance0 = (
        initial_distance
        if initial_distance is not None
        else jnp.zeros((n,), jnp.float32)
    )
    if icfg.camera_unwarp:
        si0 = ray_intersect(sd, ray, jnp.ones((n,), bool))
        distance0 = distance0 - jnp.where(si0.valid, si0.t, 0.0)

    splat_w = ray_weight * sample_scale

    if polarized:
        from ..bsdf.polarized import sensor_alignment_angles
        from ..core.mueller import msoa_identity

        vert = cam_vertical if cam_vertical is not None else jnp.array(
            [0.0, 1.0, 0.0])
        # SoA Mueller throughput: tuple of 16 (N, C) arrays — rank-2 like
        # every unpolarized carry, so XLA assigns ONE layout (see
        # core/mueller.py msoa_* notes).
        # Pending-rotator carry (ported from path_regen, round 5): the
        # sensor-alignment rotator (reference utils.py:9-21) rides in the
        # pending slot, beta starts as the identity.
        beta0 = msoa_identity(jnp.zeros((n, C), jnp.float32))
        pend0 = sensor_alignment_angles(ray.d, vert)
        L0 = jnp.zeros((n, 4 * C), jnp.float32)
    else:
        beta0 = jnp.ones((n, C), jnp.float32)
        pend0 = ()
        L0 = jnp.zeros((n, C), jnp.float32)

    state = PathState(
        o=ray.o,
        d=ray.d,
        beta=beta0,
        L=L0,
        eta=jnp.ones((n,), jnp.float32),
        distance=distance0,
        active=jnp.ones((n,), bool),
        depth=jnp.zeros((n,), jnp.int32),
        prev_p=ray.o,
        prev_pdf=jnp.ones((n,), jnp.float32),
        prev_delta=jnp.ones((n,), bool),
        film=film,
        n_rays=jnp.zeros((), jnp.float32),
        pend=pend0,
    )

    def bounce(it, st: PathState) -> PathState:
        from ..core.rng import draw_bounce_block

        ub = draw_bounce_block(key, it, n, DIMS_PER_BOUNCE)

        def rnd1(k):
            return ub[:, k]

        def rnd2(k):
            return ub[:, k : k + 2]

        active = st.active
        si = ray_intersect(sd, Ray.make(st.o, st.d), active)
        hit = active & si.valid

        distance = st.distance + jnp.where(hit, si.t, 0.0) * st.eta

        lb = bsdf_api.gather_lane_bsdf(sd.bsdf, si.bsdf_id, si.uv)
        if spectral:
            lb = _spectral_lb(lb)

        # ---------------- direct emission (BSDF-sampled MIS) --------------
        pdf_em_hit = pdf_emitter_direction(sd, st.prev_p, si)
        pdf_em_hit = jnp.where(st.prev_delta, 0.0, pdf_em_hit)
        mis = mis_weight(st.prev_pdf, pdf_em_hit)
        Le_raw = emitter_eval_hit(sd, si, st.d)
        if spectral:
            Le_raw = _spectral_emission(Le_raw)
        le_mask = hit & ~jnp.bool_(icfg.discard_direct_light)
        if polarized:
            # emission is unpolarized: contribution Stokes = E * mis *
            # (first column of the Mueller throughput; SoA entries 4i)
            w_le = mis[:, None] * Le_raw
            Le = jnp.where(
                le_mask[:, None],
                jnp.concatenate(
                    [st.beta[4 * i] * w_le for i in range(4)], axis=-1),
                0.0,
            )
        else:
            Le = jnp.where(
                le_mask[:, None], st.beta * mis[:, None] * Le_raw, 0.0
            )

        # ---------------- continuation gating ------------------------------
        active_next = active & (it + 1 < icfg.max_depth) & si.valid

        # ---------------- emitter sampling (NEE) ---------------------------
        active_em = active_next & bsdf_api.is_smooth(lb)
        ds, em_weight = sample_emitter_direction(
            sd, si.p, rnd2(0), True, active_em
        )
        if spectral:
            # uplift is positively homogeneous, so radiance/pdf converts
            # directly
            em_weight = _spectral_emission(em_weight)
        active_em = active_em & (ds.pdf > 0.0)
        wo_em = si.frame.to_local(ds.d)
        f_em, pdf_bsdf_em = bsdf_api.eval_pdf(lb, si.wi, wo_em, active_em)
        mis_em = jnp.where(ds.delta, 1.0, mis_weight(ds.pdf, pdf_bsdf_em))
        if polarized:
            from ..bsdf.polarized import polarization_factor_col0_soa
            from ..core.mueller import msoa_matvec, stokes_rotate

            # Fresnel incidence cosine at the half vector (local frame)
            m_h = si.wi + wo_em
            m_h = m_h / jnp.maximum(
                jnp.linalg.norm(m_h, axis=-1, keepdims=True), 1e-12)
            cos_i_em = jnp.abs(jnp.sum(si.wi * m_h, axis=-1))
            wo_em_world = ds.d
            # NEE sources are unpolarized, so only column 0 of the Mueller
            # factor survives; the pending rotator applies to the column
            # (true beta = stored @ R(pend)) before one 4-vector matvec
            P0 = polarization_factor_col0_soa(lb, -wo_em_world, -st.d,
                                              cos_i_em)
            P0 = stokes_rotate(P0, st.pend[0][:, None], st.pend[1][:, None])
            col = msoa_matvec(st.beta, tuple(p * f_em for p in P0))
            w_em = mis_em[:, None] * em_weight
            Lr_dir = jnp.where(
                active_em[:, None],
                jnp.concatenate([c * w_em for c in col], axis=-1),
                0.0,
            )
        else:
            Lr_dir = jnp.where(
                active_em[:, None],
                st.beta * mis_em[:, None] * f_em * em_weight, 0.0,
            )
        # one fused film update for both splat events of this bounce
        # (emitter hit at `distance`, NEE at `distance + ds.dist * eta`)
        if enable_film:
            Le_f = _to_film(Le) if spectral else Le
            Lr_f = _to_film(Lr_dir) if spectral else Lr_dir
            film_st = splat_pair_any(
                st.film, film_cfg, spp,
                distance, Le_f * splat_w[:, None],
                distance + ds.dist * st.eta, Lr_f * splat_w[:, None],
                active,
                icfg.temporal_filter, icfg.gaussian_stddev,
            )
        else:
            film_st = st.film

        # ---------------- BSDF sampling ------------------------------------
        bs = bsdf_api.sample(lb, si.wi, rnd1(2), rnd2(3), active_next)
        d_world = si.frame.to_world(bs.wo)
        new_ray = si.spawn_ray(d_world)

        L = st.L + Le + Lr_dir
        if polarized:
            from ..bsdf.polarized import specular_params_soa
            from ..core.mueller import (
                msoa_apply_fresnel_cols,
                msoa_apply_rotator_cols,
                msoa_where,
                rot2_compose,
            )
            from ..scene.scene import BSDF_NULL

            m_h = si.wi + bs.wo
            m_h = m_h / jnp.maximum(
                jnp.linalg.norm(m_h, axis=-1, keepdims=True), 1e-12)
            cos_i_s = jnp.where(
                bs.delta, jnp.abs(si.wi[:, 2]),
                jnp.abs(jnp.sum(si.wi * m_h, axis=-1)))
            transmitted = bs.wo[:, 2] * si.wi[:, 2] < 0.0
            # Structured bounce update (no sandwich construction, no
            # 64-madd product): beta' @ R(pend') = beta @ R(pend) @ R_out
            # @ F @ R_in with R(pend)@R_out composed by angle addition, F
            # applied as a column mix, and R_in deferred into the next
            # pending slot (same scheme as path_regen.py).
            is_spec, A, B, Cc, S, ci2, si2, co2, so2 = specular_params_soa(
                lb, -d_world, -st.d, cos_i_s, transmitted=transmitted)
            pc2, ps2 = st.pend
            cc, cs = rot2_compose(pc2, ps2, co2, so2)
            f = bs.weight
            spec_beta = msoa_apply_fresnel_cols(
                msoa_apply_rotator_cols(st.beta, cc[:, None], cs[:, None]),
                A * f, B * f, Cc * f, S * f)
            # non-specular: column 0 survives for every lobe (x f);
            # columns 1-3 survive only for null (identity P)
            is_null = lb.kind == BSDF_NULL
            nullf = is_null[:, None].astype(jnp.float32)
            sp = is_spec[:, None]
            beta = tuple(
                jnp.where(sp, spec_beta[4 * i + j],
                          st.beta[4 * i + j] * f
                          * (1.0 if j == 0 else nullf))
                for i in range(4) for j in range(4))
            beta = msoa_where(active_next[:, None], beta, st.beta)
            # pending: specular lanes defer R_in; null keeps the current
            # rotator; depolarizing lanes reset (depolarizer @ R = depol)
            keep = is_null & active_next
            specp = is_spec & active_next
            pend = (
                jnp.where(specp, ci2, jnp.where(keep, pc2,
                          jnp.where(active_next, 1.0, pc2))),
                jnp.where(specp, si2, jnp.where(keep, ps2,
                          jnp.where(active_next, 0.0, ps2))),
            )
        else:
            beta = jnp.where(active_next[:, None], st.beta * bs.weight,
                             st.beta)
            pend = st.pend
        eta = jnp.where(active_next, st.eta * bs.eta, st.eta)

        # ---------------- stopping criteria --------------------------------
        # RR is a detached sampling decision (reference detached PRB):
        # without the stop_gradients, the VJP of 1/rr_prob underflows
        # (x^2 -> 0 -> inf) on lanes with tiny throughput and the masked
        # inf * 0 poisons full-loop AD (tests/test_grad_safety.py pattern)
        if polarized:
            beta_max = jax.lax.stop_gradient(jnp.max(beta[0], axis=-1))
        else:
            beta_max = jax.lax.stop_gradient(jnp.max(beta, axis=-1))
        active_next = active_next & (beta_max != 0.0)
        rr_prob = jnp.minimum(beta_max * eta * eta, 0.95)
        active_next = active_next & (rr_prob > 0.0)
        rr_active = it >= icfg.rr_depth
        rr_scale = jnp.where(rr_prob > 0.0,
                             1.0 / jnp.maximum(rr_prob, 1e-30), 0.0)
        rr_scale = jax.lax.stop_gradient(rr_scale)
        rr_mask = rr_active & active_next
        if polarized:
            from ..core.mueller import msoa_where as _mw

            beta = _mw(rr_mask[:, None],
                       tuple(e * rr_scale[:, None] for e in beta), beta)
        else:
            beta = jnp.where(rr_mask[:, None], beta * rr_scale[:, None], beta)
        rr_continue = rnd1(5) < rr_prob
        active_next = active_next & (~rr_active | rr_continue)

        return PathState(
            o=new_ray.o,
            d=d_world,
            beta=beta,
            L=L,
            eta=eta,
            distance=distance,
            active=active_next,
            depth=st.depth + jnp.where(hit, 1, 0),
            prev_p=jnp.where(hit[:, None], si.p, st.prev_p),
            prev_pdf=jnp.where(active_next, bs.pdf, st.prev_pdf),
            prev_delta=jnp.where(active_next, bs.delta, st.prev_delta),
            film=film_st,
            n_rays=st.n_rays
            + jnp.sum(active.astype(jnp.float32))
            + jnp.sum(active_em.astype(jnp.float32)),
            pend=pend,
        )

    state = jax.lax.fori_loop(0, icfg.max_depth, bounce, state)
    L_out = _to_film(state.L) if spectral else state.L
    return state.film, L_out, state.depth > 0, state.n_rays
