"""Path Replay Backpropagation for the transient path tracer.

JAX re-design of the reference's differential phase
(/root/reference/mitransient/integrators/common.py:215-409 +
transientpath.py:259-316): **two primal-shaped sweeps, O(1) memory in path
depth** — no taping of the wavefront loop.

Sweep 1 (primal) computes the total path radiance ``L`` per lane
(``state_out``, common.py:371-384).  Sweep 2 replays the identical path —
trivially possible because the counter-based sampler regenerates the same
numbers for the same (seed, lane, dimension) — and at every vertex forms the
locally-differentiable contribution

    Lo(theta) = Le(theta) + Lr_dir(theta) + L_rest * replace_grad(1, f(theta)/f_detached)

(the re-attachment trick of transientpath.py:261-293), reads the adjoint
radiance at the vertex's time bin (``gather_derivatives_at_distance``,
transient_hdr_film.py:161-171 -> transientpath.py:309-311) and accumulates
``d<deltaL_read, Lo>/d theta`` into dense parameter-table gradients via
``jax.grad`` of the per-bounce scalar.  Table rows are fetched by plain
indexing (ops/gather.py), so the parameter VJP is XLA's scatter-add of the
per-lane cotangents into the table rows.

Matching the reference's semantics exactly:
* the adjoint is read once per vertex at ``bin(distance)`` and pairs the
  *whole* Lo (the reference's deliberate time-attribution approximation for
  the NEE/indirect terms, transientpath.py:309-311);
* sampling is detached: delta-lobe parameters receive no gradient through
  the indirect term (detached PRB, cf. transient_prbvolpath.py docstring);
* ``L_rest`` is peeled per vertex: L <- L - Le - Lr_dir (transientpath.py:230).

Differentiable parameters: the BSDF reflectance and emitter radiance tables
(the reference's diff-transient examples optimize exactly these).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..bsdf import api as bsdf_api
from ..core.math import mis_weight
from ..core.records import Ray
from ..film.transient_film import time_bin
from ..scene.scene import (
    SceneData,
    emitter_eval_hit,
    pdf_emitter_direction,
    ray_intersect,
    sample_emitter_direction,
)
from ..scene.schema import FilmConfig, IntegratorConfig
from .path import DIMS_PER_BOUNCE


def replace_grad(value_of, grad_of):
    """Dr.Jit ``dr.replace_grad(a, b)``: primal value of ``a``, derivative of
    ``b`` (transientpath.py:288)."""
    return grad_of + jax.lax.stop_gradient(value_of - grad_of)


class DiffParams(NamedTuple):
    """The differentiable parameter tables.

    Matches the surface ``mi.traverse`` exposes in the reference's
    diff-transient workloads: dense reflectance + emitter radiance + medium
    albedo (round 1), plus bitmap-texture texels (the staircase scene's
    roughplastic ``diffuse_reflectance`` bitmaps,
    examples/diff-transient/staircase/scene.xml:33-82), GGX roughness
    ``alpha`` and medium extinction ``sigma_t``."""

    bsdf_reflectance: jnp.ndarray  # (B, C)
    emitter_radiance: jnp.ndarray  # (E, C)
    medium_albedo: jnp.ndarray  # (M, C)
    bsdf_alpha: jnp.ndarray = None  # (B,) GGX alpha_u
    bsdf_alpha_v: jnp.ndarray = None  # (B,) GGX alpha_v (None if isotropic)
    medium_sigma_t: jnp.ndarray = None  # (M,)
    bsdf_textures: jnp.ndarray = None  # (NT, H, W, C) atlas (None if untextured)
    # per-shape rigid-motion deltas (scene.GeomParams; zeros at the current
    # pose) — gradients w.r.t. these are d(render)/d(shape pose), flowing
    # through the attached ray_intersect (the reference's dr.resume_grad
    # around scene.ray_intersect, transientpath.py:148-151)
    shape_translate: jnp.ndarray = None  # (S, 3)
    shape_rotate: jnp.ndarray = None  # (S, 3) axis-angle about shape pivot
    emitter_position: jnp.ndarray = None  # (E, 3) delta-emitter positions


def extract_params(sd: SceneData) -> DiffParams:
    return DiffParams(
        bsdf_reflectance=sd.bsdf.reflectance,
        emitter_radiance=sd.emitter.radiance,
        medium_albedo=sd.medium.albedo,
        bsdf_alpha=sd.bsdf.alpha,
        bsdf_alpha_v=sd.bsdf.alpha_v,
        medium_sigma_t=sd.medium.sigma_t,
        bsdf_textures=sd.bsdf.textures,
        shape_translate=(sd.geom.translate if sd.geom is not None else None),
        shape_rotate=(sd.geom.rotate if sd.geom is not None else None),
        emitter_position=sd.emitter.position,
    )


def insert_params(sd: SceneData, p: DiffParams) -> SceneData:
    geom = sd.geom
    if geom is not None and p.shape_translate is not None:
        geom = geom._replace(translate=p.shape_translate,
                             rotate=p.shape_rotate)
    return sd._replace(
        bsdf=sd.bsdf._replace(
            reflectance=p.bsdf_reflectance,
            alpha=p.bsdf_alpha if p.bsdf_alpha is not None else sd.bsdf.alpha,
            alpha_v=(p.bsdf_alpha_v if p.bsdf_alpha_v is not None
                     else sd.bsdf.alpha_v),
            textures=(p.bsdf_textures if p.bsdf_textures is not None
                      else sd.bsdf.textures),
        ),
        emitter=sd.emitter._replace(
            radiance=p.emitter_radiance,
            position=(p.emitter_position if p.emitter_position is not None
                      else sd.emitter.position)),
        medium=sd.medium._replace(
            albedo=p.medium_albedo,
            sigma_t=(p.medium_sigma_t if p.medium_sigma_t is not None
                     else sd.medium.sigma_t),
        ),
        geom=geom,
    )


def grads_to_named(scene, grads: DiffParams) -> dict:
    """Map DiffParams table gradients onto the scene's traverse paths
    (mi.traverse semantics, reference nlos.py:18-32).  Includes the raw
    tables under ``'__tables__'``."""
    out = {"__tables__": grads}
    for path, (table, idx) in scene._param_paths.items():
        if table == "bsdf.reflectance":
            out[path] = grads.bsdf_reflectance[idx]
        elif table == "emitter.radiance":
            out[path] = grads.emitter_radiance[idx]
        elif table == "medium.albedo":
            out[path] = grads.medium_albedo[idx]
        elif table == "bsdf.alpha" and grads.bsdf_alpha is not None:
            # the isotropic `alpha` path drives BOTH GGX leaves (alpha_u and
            # alpha_v move in lockstep, see ParamMap.apply) -> chain rule
            # sums their partials.  The two halves routinely have opposite
            # signs off-peak, so dropping one flips the gradient.
            g = grads.bsdf_alpha[idx]
            if grads.bsdf_alpha_v is not None:
                g = g + grads.bsdf_alpha_v[idx]
            out[path] = g
        elif table == "bsdf.alpha_u" and grads.bsdf_alpha is not None:
            out[path] = grads.bsdf_alpha[idx]
        elif table == "bsdf.alpha_v" and grads.bsdf_alpha_v is not None:
            out[path] = grads.bsdf_alpha_v[idx]
        elif table == "medium.sigma_t" and grads.medium_sigma_t is not None:
            out[path] = grads.medium_sigma_t[idx]
        elif table == "bsdf.textures" and grads.bsdf_textures is not None:
            out[path] = grads.bsdf_textures[idx]
        elif table == "shape.translate" and grads.shape_translate is not None:
            out[path] = grads.shape_translate[idx]
        elif table == "shape.rotate" and grads.shape_rotate is not None:
            out[path] = grads.shape_rotate[idx]
        elif table == "emitter.position" and grads.emitter_position is not None:
            out[path] = grads.emitter_position[idx]
    return out


def read_adjoint(grad_tr_flat: jnp.ndarray, grad_st_flat: jnp.ndarray,
                 film_cfg: FilmConfig, pix: jnp.ndarray,
                 distance: jnp.ndarray) -> jnp.ndarray:
    """The ``gather_derivatives_at_distance`` read kernel: adjoint radiance
    at (pixel, bin(distance)).  The steady adjoint is added for every bin of
    the pixel, mirroring ``deltaL = dtransient + reshape(dsteady)``
    (common.py:363-366).

    grad_tr_flat: (HW * T, C); grad_st_flat: (HW, C).
    """
    b, ok = time_bin(film_cfg, distance)
    idx = pix * film_cfg.temporal_bins + jnp.minimum(
        b, film_cfg.temporal_bins - 1
    )
    val = grad_tr_flat[idx]
    return jnp.where(ok[:, None], val, 0.0) + grad_st_flat[pix]


def sample_adjoint(
    sd: SceneData,
    sampler_key,
    ray: Ray,
    pix: jnp.ndarray,
    ray_weight: jnp.ndarray,
    L_total: jnp.ndarray,  # (N, C) state_out from the primal sweep
    grad_tr_flat: jnp.ndarray,
    grad_st_flat: jnp.ndarray,
    film_cfg: FilmConfig,
    icfg: IntegratorConfig,
    sample_scale,
    base_dim: int,
    initial_distance: jnp.ndarray | None = None,
    mode: str = "backward",
    tangents: DiffParams | None = None,
):
    """The replay sweep.

    mode='backward': returns DiffParams gradients (the VJP of
    <grad_in, render(theta)> w.r.t. the parameter tables).
    mode='forward': returns the per-(lane,bounce) JVP contributions splatted
    by the caller — here, (delta_splat_vals (N, C) accumulated per bounce
    via callback is avoided; we return the forward-derivative L, and per
    bounce the caller's film is updated through the returned carry) — see
    render.render_forward for the driver.
    """
    n = pix.shape[0]
    C = sd.bsdf.reflectance.shape[-1]
    key = sampler_key

    theta0 = extract_params(sd)
    grads0 = jax.tree.map(jnp.zeros_like, theta0)

    distance0 = (
        initial_distance if initial_distance is not None
        else jnp.zeros((n,), jnp.float32)
    )
    if icfg.camera_unwarp:
        si0 = ray_intersect(sd, ray, jnp.ones((n,), bool))
        distance0 = distance0 - jnp.where(si0.valid, si0.t, 0.0)

    splat_w = ray_weight * sample_scale

    carry0 = dict(
        o=ray.o,
        d=ray.d,
        beta=jnp.ones((n, C), jnp.float32),
        L_rest=L_total,
        eta=jnp.ones((n,), jnp.float32),
        distance=distance0,
        active=jnp.ones((n,), bool),
        prev_p=ray.o,
        prev_pdf=jnp.ones((n,), jnp.float32),
        prev_delta=jnp.ones((n,), bool),
        grads=grads0,
    )

    def bounce(it, st):
        from ..core.rng import draw_bounce_block

        ub = draw_bounce_block(key, it, n, DIMS_PER_BOUNCE)

        def rnd1(k):
            return ub[:, k]

        def rnd2(k):
            return ub[:, k : k + 2]

        active = st["active"]
        si = ray_intersect(sd, Ray.make(st["o"], st["d"]), active)
        hit = active & si.valid
        distance = st["distance"] + jnp.where(hit, si.t, 0.0) * st["eta"]

        lb_det = bsdf_api.gather_lane_bsdf(sd.bsdf, si.bsdf_id, si.uv)

        # detached MIS weights / NEE sample (identical to primal)
        pdf_em_hit = pdf_emitter_direction(sd, st["prev_p"], si)
        pdf_em_hit = jnp.where(st["prev_delta"], 0.0, pdf_em_hit)
        mis = mis_weight(st["prev_pdf"], pdf_em_hit)

        active_next = active & (it + 1 < icfg.max_depth) & si.valid
        active_em0 = active_next & bsdf_api.is_smooth(lb_det)
        ds, em_weight_det = sample_emitter_direction(
            sd, si.p, rnd2(0), True, active_em0
        )
        active_em = active_em0 & (ds.pdf > 0.0)
        wo_em = si.frame.to_local(ds.d)
        _f_em_det, pdf_bsdf_em = bsdf_api.eval_pdf(lb_det, si.wi, wo_em,
                                                   active_em)
        mis_em = jnp.where(ds.delta, 1.0, mis_weight(ds.pdf, pdf_bsdf_em))

        # detached BSDF sample (consumes the same dims as primal)
        bs = bsdf_api.sample(lb_det, si.wi, rnd1(2), rnd2(3), active_next)
        wo_sampled = bs.wo
        f_det_sampled = bs.weight * bs.pdf[:, None]  # f*cos detached

        beta_det = st["beta"]
        L_rest = st["L_rest"]
        nee_vis = (em_weight_det.sum(axis=-1) != 0.0) & active_em

        def contributions(theta: DiffParams):
            sdt = insert_params(sd, theta)
            lb = bsdf_api.gather_lane_bsdf(sdt.bsdf, si.bsdf_id, si.uv)
            # Le: attached emitter radiance at the hit
            Le_raw = emitter_eval_hit(sdt, si, st["d"])
            Le = jnp.where(
                (hit & ~jnp.bool_(icfg.discard_direct_light))[:, None],
                beta_det * mis[:, None] * Le_raw,
                0.0,
            )
            # Lr_dir: attached BSDF value and emitter radiance; detached pdf
            # and visibility (the re-evaluation of transientpath.py:196-213)
            f_em, _ = bsdf_api.eval_pdf(lb, si.wi, wo_em, active_em)
            from ..scene.scene import emitter_eval_direction

            em_idx = jnp.maximum(ds.emitter_id, 0)
            cos_em = jnp.sum(ds.n * -ds.d, axis=-1)
            em_val = emitter_eval_direction(
                sdt, em_idx, ds.p, ds.n, ds.d, ds.dist, cos_em
            )
            em_weight = jnp.where(
                nee_vis[:, None],
                em_val / jnp.maximum(
                    jax.lax.stop_gradient(ds.pdf)[:, None], 1e-30),
                0.0,
            )
            Lr_dir = jnp.where(
                active_em[:, None],
                beta_det * mis_em[:, None] * f_em * em_weight,
                0.0,
            )
            # Lr_ind: re-attachment of the sampled BSDF value
            f_cur, _ = bsdf_api.eval_pdf(lb, si.wi, wo_sampled, active_next)
            inv_det = jnp.where(
                f_det_sampled != 0.0,
                1.0 / jnp.where(f_det_sampled != 0.0, f_det_sampled, 1.0),
                0.0,
            )
            ratio = replace_grad(jnp.ones_like(f_cur), f_cur * inv_det)
            # the indirect term scales the radiance of the *remaining* path
            # only: the reference subtracts the current vertex's Le + Lr_dir
            # from L before forming Lr_ind (transientpath.py:230 -> :290)
            Lr_ind = jax.lax.stop_gradient(L_rest - Le - Lr_dir) * ratio
            Lo = Le + Lr_dir + Lr_ind
            return Lo, (Le, Lr_dir)

        if mode == "backward":
            dL_read = read_adjoint(grad_tr_flat, grad_st_flat, film_cfg, pix,
                                   distance)
            weight_lane = jnp.where(active, splat_w, 0.0)

            def scalar_obj(theta):
                Lo, aux = contributions(theta)
                return jnp.sum(dL_read * Lo * weight_lane[:, None]), aux

            g, (Le_det, Lr_dir_det) = jax.grad(
                scalar_obj, has_aux=True)(theta0)
            grads = jax.tree.map(jnp.add, st["grads"], g)
            fwd_splat = None
        else:  # forward: JVP of Lo along `tangents`
            def lo_only(theta):
                Lo, aux = contributions(theta)
                return Lo, aux

            Lo, dLo, (Le_det, Lr_dir_det) = jax.jvp(
                lo_only, (theta0,), (tangents,), has_aux=True
            )
            fwd_splat = jnp.where(active[:, None], dLo * splat_w[:, None], 0.0)

        Le_det = jax.lax.stop_gradient(Le_det)
        Lr_dir_det = jax.lax.stop_gradient(Lr_dir_det)

        # ---- state update: identical to the primal sweep -----------------
        d_world = si.frame.to_world(bs.wo)
        new_ray = si.spawn_ray(d_world)
        beta = jnp.where(active_next[:, None], beta_det * bs.weight, beta_det)
        eta = jnp.where(active_next, st["eta"] * bs.eta, st["eta"])
        L_rest = L_rest - Le_det - Lr_dir_det

        beta_max = jnp.max(beta, axis=-1)
        active_next = active_next & (beta_max != 0.0)
        rr_prob = jnp.minimum(beta_max * eta * eta, 0.95)
        active_next = active_next & (rr_prob > 0.0)
        rr_active = it >= icfg.rr_depth
        beta = jnp.where(
            (rr_active & active_next)[:, None],
            beta * jnp.where(
                rr_prob > 0.0, 1.0 / jnp.maximum(rr_prob, 1e-30), 0.0
            )[:, None],
            beta,
        )
        rr_continue = rnd1(5) < rr_prob
        active_next = active_next & (~rr_active | rr_continue)

        out = dict(
            o=new_ray.o,
            d=d_world,
            beta=beta,
            L_rest=L_rest,
            eta=eta,
            distance=distance,
            active=active_next,
            prev_p=jnp.where(hit[:, None], si.p, st["prev_p"]),
            prev_pdf=jnp.where(active_next, bs.pdf, st["prev_pdf"]),
            prev_delta=jnp.where(active_next, bs.delta, st["prev_delta"]),
            grads=st["grads"] if mode != "backward" else grads,
        )
        if mode == "forward":
            return out, (fwd_splat, distance)
        return out, None

    if mode == "backward":
        def body(it, st):
            out, _ = bounce(it, st)
            return out

        final = jax.lax.fori_loop(0, icfg.max_depth, body, carry0)
        return final["grads"]
    else:
        # forward mode: scan so per-bounce splat values come back stacked
        def body(st, it):
            out, aux = bounce(it, st)
            return out, aux

        final, (splats, dists) = jax.lax.scan(
            body, carry0, jnp.arange(icfg.max_depth)
        )
        return splats, dists  # (D, N, C), (D, N)
