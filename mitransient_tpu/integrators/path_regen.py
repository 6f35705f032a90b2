"""Transient path tracer with in-loop path regeneration.

The fixed-depth wavefront (integrators/path.py) pays for every lane on every
bounce even though Russian roulette and escapes kill most paths early: by
bounce 4 of a max_depth-8 Cornell-box render, occupancy is well under 50%.
This variant keeps the wavefront saturated the classic GPU way — **when a
lane's path terminates, the lane immediately starts its pixel's next spp
sample** — expressed as a single `lax.while_loop` that runs
until every lane's sample budget is exhausted.  The Python pass loop
disappears: one launch consumes the whole spp budget.

Lane layout: lane l = (row r = l // HW, pixel p = l % HW); the lane owns
sample indices r, r + L, r + 2L, ... of pixel p (L = lanes per pixel), so
the pixel of a lane never changes and the film splat (film/transient_film.py)
applies unchanged.

RNG: per-(sample, dimension) *stateless hashing* — `hash_uniform(key,
sample_id, dim)` with a PCG-style mixer — because regenerating lanes need
per-lane keys, which `jax.random`'s single-key draws cannot express.  The
estimator is identical to the fixed-depth integrator; only the sample stream
differs (validated statistically in tests/test_regen.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..bsdf import api as bsdf_api
from ..core.math import mis_weight, normalize
from ..core.records import Ray
from ..film.transient_film import TransientFilmState, splat_pair_any
from ..scene.scene import (
    SceneData,
    emitter_eval_hit,
    pdf_emitter_direction,
    ray_intersect,
    sample_emitter_direction,
)
from ..scene.schema import FilmConfig, IntegratorConfig

DIMS_PER_BOUNCE = 8  # 2 NEE + 3 BSDF + 1 RR (+2 spare); dims 0-1 = jitter


def _pcg(x: jnp.ndarray) -> jnp.ndarray:
    """32-bit PCG-ish mixer (uint32 -> uint32)."""
    x = x * jnp.uint32(747796405) + jnp.uint32(2891336453)
    w = ((x >> (x >> jnp.uint32(28)) + jnp.uint32(4)) ^ x) * jnp.uint32(277803737)
    return (w >> jnp.uint32(22)) ^ w


def hash_uniform(seed: jnp.ndarray, sample_id: jnp.ndarray,
                 dim: jnp.ndarray) -> jnp.ndarray:
    """Stateless uniform in [0,1): pure function of (seed, sample, dim)."""
    h = _pcg(sample_id.astype(jnp.uint32) ^ _pcg(dim.astype(jnp.uint32)
                                                 ^ _pcg(seed)))
    return h.astype(jnp.float32) * (1.0 / 4294967296.0)


def sample_primal_regen(
    sd: SceneData,
    seed,
    cam,
    film: TransientFilmState,
    film_cfg: FilmConfig,
    icfg: IntegratorConfig,
    spp_total: int,
    lanes_per_pixel: int,
    polarized: bool = False,
):
    """Render the full spp budget in one while_loop with path regeneration.

    Returns (film, steady_sum (N, C or 4C) per-lane accumulators to be
    row-reduced, n_rays, n_iters).

    ``polarized=True`` carries the Mueller-matrix throughput chain of
    sample_primal (beta (N, 4, 4, C), Stokes contributions, 4*C film
    channels); regeneration re-seeds beta with the sensor-alignment
    rotator of the lane's fresh camera ray (reference utils.py:9-21).
    """
    hw = film_cfg.width * film_cfg.height
    L = lanes_per_pixel
    n = hw * L
    C = sd.bsdf.reflectance.shape[-1]
    CS = 4 * C if polarized else C  # splat/steady channel count
    width, height = film_cfg.width, film_cfg.height
    seed_u = jnp.uint32(seed)
    splat_scale = jnp.float32(1.0 / spp_total)

    # Mono squeeze: C == 1 spectral state is carried and computed as (N,)
    # instead of (N, 1) (whether this still pays on the GPU is not
    # measured).  ``sqz`` converts (N, C) outputs of the shared BSDF /
    # emitter kernels to the internal spectral shape, ``ch`` lifts per-lane
    # scalars/masks for spectral broadcasting, and ``pack`` restores the
    # (N, CS) film/steady channel layout at the splat boundary.
    mono = C == 1

    def sqz(x):
        return x[:, 0] if (mono and x.ndim == 2) else x

    def ch(x):
        return x if mono else x[:, None]

    def pack(parts):
        if len(parts) == 1:
            return parts[0][:, None] if mono else parts[0]
        return (jnp.stack(parts, -1) if mono
                else jnp.concatenate(parts, axis=-1))

    spec_shape = (n,) if mono else (n, C)
    if polarized:
        from ..bsdf.polarized import sensor_alignment_angles
        from ..core.mueller import msoa_identity

        cam_vert = cam.R[:, 1]

        # Pending-rotator Mueller carry (core/mueller.py "Structured
        # right-applies"): stored beta (tuple of 16 spectral arrays) with
        # TRUE beta = stored @ R(pend).  The sensor-alignment rotator
        # (reference utils.py:9-21) IS a rotator about the camera segment,
        # so fresh paths start from the constant identity with the
        # alignment angles riding in the pending slot.
        def beta_init(d):
            return msoa_identity(jnp.zeros(spec_shape, jnp.float32))

        def pend_init(d):
            return sensor_alignment_angles(d, cam_vert)

    lane = jnp.arange(n, dtype=jnp.uint32)
    pix = (lane % hw).astype(jnp.int32)
    row = (lane // hw).astype(jnp.uint32)

    def gen_ray(sample_idx):
        """Camera ray for each lane's sample ``sample_idx`` (dims 0-1)."""
        sid = sample_idx * jnp.uint32(hw) + pix.astype(jnp.uint32)
        jx = hash_uniform(seed_u, sid, jnp.uint32(0))
        jy = hash_uniform(seed_u, sid, jnp.uint32(1))
        px = (pix % width).astype(jnp.float32)
        py = (pix // width).astype(jnp.float32)
        u = (px + jx) / width
        v = (py + jy) / height
        cx = (1.0 - 2.0 * u) * cam.tan_half[0]
        cy = (1.0 - 2.0 * v) * cam.tan_half[1]
        # camera -> world (d_cam = (cx, cy, 1)) as elementwise sums: exact
        # float32, and no K=3 matrix product for XLA to hand to cuBLAS
        d = normalize(cx[:, None] * cam.R[:, 0] + cy[:, None] * cam.R[:, 1]
                      + cam.R[:, 2])
        o = jnp.broadcast_to(cam.origin, (n, 3))
        return o, d

    o0, d0 = gen_ray(row)

    state = dict(
        o=o0, d=d0,
        beta=beta_init(d0) if polarized else jnp.ones(spec_shape,
                                                      jnp.float32),
        **(dict(pend=pend_init(d0)) if polarized else {}),
        L=jnp.zeros((n, CS), jnp.float32),
        eta=jnp.ones((n,), jnp.float32),
        distance=jnp.zeros((n,), jnp.float32),
        depth=jnp.zeros((n,), jnp.uint32),
        sample_idx=row,  # current sample index per lane
        lane_live=row < jnp.uint32(spp_total),  # lanes beyond budget are dead
        path_active=row < jnp.uint32(spp_total),
        prev_p=o0,
        prev_pdf=jnp.ones((n,), jnp.float32),
        prev_delta=jnp.ones((n,), bool),
        steady=jnp.zeros((n, CS), jnp.float32),
        film=film,
        n_rays=jnp.zeros((), jnp.float32),
        it=jnp.uint32(0),
    )

    max_iters = (((spp_total + L - 1) // L) * icfg.max_depth
                 + icfg.max_depth + 1)

    def cond(st):
        return jnp.any(st["lane_live"]) & (st["it"] < max_iters)

    def body(st):
        active = st["path_active"] & st["lane_live"]
        depth = st["depth"]
        sid = st["sample_idx"] * jnp.uint32(hw) + pix.astype(jnp.uint32)

        def rnd1(k):
            return hash_uniform(
                seed_u, sid,
                jnp.uint32(2) + depth * jnp.uint32(DIMS_PER_BOUNCE)
                + jnp.uint32(k))

        def rnd2(k):
            return jnp.stack([rnd1(k), rnd1(k + 1)], axis=-1)

        si = ray_intersect(sd, Ray.make(st["o"], st["d"]), active)
        hit = active & si.valid
        distance = st["distance"] + jnp.where(hit, si.t, 0.0) * st["eta"]

        lb = bsdf_api.gather_lane_bsdf(sd.bsdf, si.bsdf_id, si.uv)
        if mono:
            # squeeze the spectral table columns too: the BSDF eval/sample
            # and polarized-factor kernels are shape-polymorphic over
            # (N, C) vs (N,) tables (bsdf/api.py "spectral lift")
            lb = lb._replace(reflectance=sqz(lb.reflectance),
                             eta_re=sqz(lb.eta_re), eta_im=sqz(lb.eta_im))

        pdf_em_hit = pdf_emitter_direction(sd, st["prev_p"], si)
        pdf_em_hit = jnp.where(st["prev_delta"], 0.0, pdf_em_hit)
        mis = mis_weight(st["prev_pdf"], pdf_em_hit)
        le_mask = hit & ~jnp.bool_(icfg.discard_direct_light)
        Le_raw = sqz(emitter_eval_hit(sd, si, st["d"]))
        if polarized:
            # emission is unpolarized: Stokes = E * mis * column 0 of the
            # Mueller throughput (SoA entries 4i)
            w_le = ch(mis) * Le_raw
            Le = jnp.where(
                le_mask[:, None],
                pack([st["beta"][4 * i] * w_le for i in range(4)]),
                0.0,
            )
        else:
            Le = jnp.where(
                le_mask[:, None], pack([st["beta"] * ch(mis) * Le_raw]),
                0.0)

        cont = active & (depth + 1 < icfg.max_depth) & si.valid
        active_em = cont & bsdf_api.is_smooth(lb)
        ds, em_weight = sample_emitter_direction(sd, si.p, rnd2(0),
                                                 True, active_em)
        active_em = active_em & (ds.pdf > 0.0)
        wo_em = si.frame.to_local(ds.d)
        f_em, pdf_bsdf_em = bsdf_api.eval_pdf(lb, si.wi, wo_em, active_em)
        f_em = sqz(f_em)
        em_weight = sqz(em_weight)
        mis_em = jnp.where(ds.delta, 1.0, mis_weight(ds.pdf, pdf_bsdf_em))
        if polarized:
            from ..bsdf.polarized import polarization_factor_col0_soa
            from ..core.mueller import msoa_matvec, stokes_rotate

            m_h = si.wi + wo_em
            m_h = m_h / jnp.maximum(
                jnp.linalg.norm(m_h, axis=-1, keepdims=True), 1e-12)
            cos_i_em = jnp.abs(jnp.sum(si.wi * m_h, axis=-1))
            # NEE sources are unpolarized: only column 0 of the Mueller
            # factor survives; the pending rotator applies to the column
            # (true beta = stored @ R(pend)) before one 4-vector matvec
            P0 = polarization_factor_col0_soa(lb, -ds.d, -st["d"], cos_i_em)
            P0 = tuple(sqz(p) for p in P0)
            P0 = stokes_rotate(P0, ch(st["pend"][0]), ch(st["pend"][1]))
            col = msoa_matvec(st["beta"], tuple(p * f_em for p in P0))
            w_em = ch(mis_em) * em_weight
            Lr_dir = jnp.where(
                active_em[:, None],
                pack([c * w_em for c in col]),
                0.0,
            )
        else:
            Lr_dir = jnp.where(
                active_em[:, None],
                pack([st["beta"] * ch(mis_em) * f_em * em_weight]), 0.0)

        film_st = splat_pair_any(
            st["film"], film_cfg, L,
            distance, Le * splat_scale,
            distance + ds.dist * st["eta"], Lr_dir * splat_scale,
            active,
            icfg.temporal_filter, icfg.gaussian_stddev,
        )

        bs = bsdf_api.sample(lb, si.wi, rnd1(2), rnd2(3), cont)
        d_world = si.frame.to_world(bs.wo)
        new_ray = si.spawn_ray(d_world)

        L_acc = st["L"] + Le + Lr_dir
        if polarized:
            from ..bsdf.polarized import specular_params_soa
            from ..core.mueller import (
                msoa_apply_fresnel_cols,
                msoa_apply_rotator_cols,
                msoa_where,
                rot2_compose,
            )
            from ..scene.scene import BSDF_NULL

            m_hs = si.wi + bs.wo
            m_hs = m_hs / jnp.maximum(
                jnp.linalg.norm(m_hs, axis=-1, keepdims=True), 1e-12)
            cos_i_s = jnp.where(
                bs.delta, jnp.abs(si.wi[:, 2]),
                jnp.abs(jnp.sum(si.wi * m_hs, axis=-1)))
            transmitted = bs.wo[:, 2] * si.wi[:, 2] < 0.0
            # Structured bounce update (no sandwich construction, no 64-madd
            # product): beta' @ R(pend') = beta @ R(pend) @ R_out @ F @ R_in
            # with R(pend)@R_out composed by angle addition, F applied as a
            # column mix, and R_in deferred into the next pending slot.
            is_spec, A, B, Cc, S, ci2, si2, co2, so2 = specular_params_soa(
                lb, -d_world, -st["d"], cos_i_s, transmitted=transmitted)
            pc2, ps2 = st["pend"]
            cc, cs = rot2_compose(pc2, ps2, co2, so2)
            f = sqz(bs.weight)
            spec_beta = msoa_apply_fresnel_cols(
                msoa_apply_rotator_cols(st["beta"], ch(cc), ch(cs)),
                sqz(A) * f, sqz(B) * f, sqz(Cc) * f, sqz(S) * f)
            # non-specular: column 0 survives for every lobe (x f); columns
            # 1-3 survive only for null (identity P — polarization passes)
            is_null = lb.kind == BSDF_NULL
            nullf = ch(is_null.astype(jnp.float32))
            sp = ch(is_spec)
            beta = tuple(
                jnp.where(sp, spec_beta[4 * i + j],
                          st["beta"][4 * i + j] * f
                          * (1.0 if j == 0 else nullf))
                for i in range(4) for j in range(4))
            beta = msoa_where(ch(cont), beta, st["beta"])
            # pending: specular lanes defer R_in; null keeps the current
            # rotator; depolarizing lanes reset (depolarizer @ R = depol)
            keep = is_null & cont
            specp = is_spec & cont
            pend = (
                jnp.where(specp, ci2, jnp.where(keep, pc2,
                          jnp.where(cont, 1.0, pc2))),
                jnp.where(specp, si2, jnp.where(keep, ps2,
                          jnp.where(cont, 0.0, ps2))),
            )
            beta_max = beta[0] if mono else jnp.max(beta[0], axis=-1)
        else:
            beta = jnp.where(ch(cont), st["beta"] * sqz(bs.weight),
                             st["beta"])
            beta_max = beta if mono else jnp.max(beta, axis=-1)
        eta = jnp.where(cont, st["eta"] * bs.eta, st["eta"])

        cont = cont & (beta_max != 0.0)
        rr_prob = jnp.minimum(beta_max * eta * eta, 0.95)
        cont = cont & (rr_prob > 0.0)
        rr_active = depth >= jnp.uint32(icfg.rr_depth)
        rr_scale = jnp.where(rr_prob > 0.0,
                             1.0 / jnp.maximum(rr_prob, 1e-30), 0.0)
        rr_mask = rr_active & cont
        if polarized:
            from ..core.mueller import msoa_where as _mw

            beta = _mw(ch(rr_mask),
                       tuple(e * ch(rr_scale) for e in beta), beta)
        else:
            beta = jnp.where(ch(rr_mask), beta * ch(rr_scale), beta)
        cont = cont & (~rr_active | (rnd1(5) < rr_prob))

        # ---- regeneration: finished paths bank their L and start the
        # lane's next sample ------------------------------------------------
        finished = active & ~cont
        steady = st["steady"] + jnp.where(finished[:, None], L_acc, 0.0)
        next_sample = st["sample_idx"] + jnp.uint32(L)
        has_more = next_sample < jnp.uint32(spp_total)
        regen = finished & has_more
        lane_live = st["lane_live"] & ~(finished & ~has_more)
        sample_idx = jnp.where(regen, next_sample, st["sample_idx"])
        o_new, d_new = gen_ray(sample_idx)

        if polarized:
            # fresh samples restart from the identity with the new ray's
            # sensor-alignment rotator in the pending slot
            from ..core.mueller import msoa_where as _mw

            beta_next = _mw(ch(regen), beta_init(d_new), beta)
            npc2, nps2 = pend_init(d_new)
            pend_next = (jnp.where(regen, npc2, pend[0]),
                         jnp.where(regen, nps2, pend[1]))
        else:
            beta_next = jnp.where(ch(regen), 1.0, beta)
        out = dict(
            **(dict(pend=pend_next) if polarized else {}),
            o=jnp.where(regen[:, None], o_new, new_ray.o),
            d=jnp.where(regen[:, None], d_new, d_world),
            beta=beta_next,
            L=jnp.where((finished | regen)[:, None], 0.0, L_acc),
            eta=jnp.where(regen, 1.0, eta),
            distance=jnp.where(regen, 0.0, distance),
            depth=jnp.where(regen, 0, depth + 1).astype(jnp.uint32),
            sample_idx=sample_idx,
            lane_live=lane_live,
            path_active=jnp.where(regen, True, cont) & lane_live,
            prev_p=jnp.where(regen[:, None], o_new,
                             jnp.where(hit[:, None], si.p, st["prev_p"])),
            prev_pdf=jnp.where(regen, 1.0,
                               jnp.where(cont, bs.pdf, st["prev_pdf"])),
            prev_delta=jnp.where(regen, True,
                                 jnp.where(cont, bs.delta,
                                           st["prev_delta"])),
            steady=steady,
            film=film_st,
            n_rays=st["n_rays"]
            + jnp.sum(active.astype(jnp.float32))
            + jnp.sum(active_em.astype(jnp.float32)),
            it=st["it"] + 1,
        )
        return out

    final = jax.lax.while_loop(cond, body, state)
    return final["film"], final["steady"], final["n_rays"], final["it"]
