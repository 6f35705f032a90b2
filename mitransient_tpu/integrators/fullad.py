"""Full reverse-mode AD for the NLOS and volumetric transient integrators.

The reference differentiates these integrators with the same detached-PRB
replay as the plain path tracer (transientnlospath.py:860-917,
transient_prbvolpath.py:243-386).  Here they are differentiated by
``jax.grad`` straight through the wavefront loop: XLA tapes the (static
trip-count) ``fori_loop`` as a scan and runs the exact adjoint.  Sampling
decisions are detached inside the loops (stop_gradient on RR, detached
pdfs), so the estimator matches detached PRB — with one deliberate
improvement: every splat's adjoint is read at its *own* time bin (the
film scatter is differentiated exactly) instead of the reference's
read-at-vertex-distance approximation (transientpath.py:309-311).

Gradients accumulate over spp chunks (parameter gradients are additive over
sample subsets), so arbitrarily large budgets work at bounded memory.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.rng import Sampler
from ..film.transient_film import develop_any, film_init_any
from ..scene.schema import Scene
from .prb import DiffParams, extract_params, insert_params


def _skip_le(scene) -> bool:
    from .nlos_path import can_skip_le

    return can_skip_le(scene.data)


def fullad_grads(sd, ctx, gs, gt_full, seed, stream, inv_total, *,
                 film_cfg, icfg, spp, hw, kind,
                 skip_le: bool = False, polarized: bool = False,
                 spectral: bool = False) -> DiffParams:
    """Parameter-gradient contribution of one spp-chunk sample stream.

    Traceable (no jit): parallel.mesh wraps it in shard_map with
    ``stream = pass * n_devices + device_index`` so the multi-chip gradient
    is the psum of per-device calls of this function.

    ``polarized``/``spectral`` must match the scene variant so the taped
    estimator is the SAME estimator the primal rendered (film gets
    4x channels for Stokes output; spectral lanes carry hero wavelengths
    and splat in sRGB) — previously the flags were dropped and a polarized
    scene was differentiated through an unpolarized RGB estimator."""

    def loss_fn(theta: DiffParams):
        sdt = insert_params(sd, theta)
        C = sdt.bsdf.reflectance.shape[-1]
        Cf = C * (4 if polarized else 1)
        film = film_init_any(film_cfg, Cf, scan_pixels=hw)
        sampler = Sampler(seed, spp * hw, stream=stream)
        if kind == "transient_nlos_path":
            from .nlos_path import sample_nlos_primal, sample_nlos_rays

            ray, rw = sample_nlos_rays(ctx, spp, hw)
            film, L, _v, _r = sample_nlos_primal(
                sdt, ctx, sampler, ray, rw, film, film_cfg, icfg,
                inv_total, base_dim=2, spp=spp, skip_le=skip_le,
                polarized=polarized, spectral=spectral)
        elif kind == "transient_path":
            from ..sensors.perspective import sample_rays
            from .path import sample_primal

            ray, pix, rw = sample_rays(ctx, sampler, film_cfg.width,
                                       film_cfg.height, spp)
            film, L, _v, _r = sample_primal(
                sdt, sampler, ray, pix, rw, film, film_cfg, icfg,
                inv_total, base_dim=2, spp=spp, polarized=polarized,
                spectral=spectral, cam_vertical=ctx.R[:, 1])
        else:  # transient_prbvolpath
            from ..sensors.perspective import sample_rays
            from .volpath import sample_volpath_primal

            ray, pix, rw = sample_rays(ctx, sampler, film_cfg.width,
                                       film_cfg.height, spp)
            film, L, _v, _r = sample_volpath_primal(
                sdt, sampler, ray, pix, rw, film, film_cfg, icfg,
                inv_total, base_dim=2, spp=spp, spectral=spectral,
                polarized=polarized, cam_vertical=ctx.R[:, 1])
        _steady_dev, transient = develop_any(
            film, film_cfg, shape_hw=(film_cfg.height, film_cfg.width))
        # steady partial: per-pass sum of L * inv_total (box filter weights)
        steady_partial = (
            L.reshape(spp, hw, L.shape[-1]).sum(axis=0) * inv_total
        )
        return (jnp.sum(gt_full * transient)
                + jnp.sum(gs * steady_partial))

    return jax.grad(loss_fn)(extract_params(sd))


@partial(jax.jit,
         static_argnames=("film_cfg", "icfg", "spp", "hw", "kind",
                          "skip_le", "polarized", "spectral"),
         donate_argnames=())
def _fullad_pass(sd, ctx, gs, gt_full, seed, pass_idx, inv_total, *,
                 film_cfg, icfg, spp, hw, kind, skip_le=False,
                 polarized=False, spectral=False):
    """One spp-chunk's parameter-gradient contribution (single device)."""
    return fullad_grads(sd, ctx, gs, gt_full, seed, pass_idx, inv_total,
                        film_cfg=film_cfg, icfg=icfg, spp=spp, hw=hw,
                        kind=kind, skip_le=skip_le, polarized=polarized,
                        spectral=spectral)


def render_backward_fullad(scene: Scene, grad_in, spp=None, seed=0,
                           sensor=0, max_lanes=1 << 20):
    cfg = scene.sensors[sensor]
    icfg = scene.integrator
    film_cfg = cfg.film
    kind = icfg.kind
    spp = spp if spp is not None else cfg.spp
    hw = film_cfg.width * film_cfg.height
    polarized = scene.variant.polarized
    spectral = scene.variant.spectral
    C = scene.variant.color_channels * (4 if polarized else 1)
    T = film_cfg.temporal_bins

    if film_cfg.kind == "phasor_hdr_film":
        raise NotImplementedError(
            "the phasor film is not differentiable (matching the "
            "reference's PhasorHDRFilm); use transient_hdr_film for "
            "gradients")
    if kind == "transient_nlos_path":
        if icfg.capture_type == "exhaustive":
            raise ValueError(
                "Exhaustive capture is not supported in differentiable "
                "rendering (transientnlospath.py:729-731)")
        from .nlos_path import prepare_nlos_cached

        ctx = prepare_nlos_cached(scene, cfg, sensor)
    else:
        from ..sensors.perspective import build_camera

        ctx = build_camera(cfg)

    grad_steady, grad_transient = grad_in
    gs = (jnp.zeros((hw, C), jnp.float32) if grad_steady is None
          else jnp.asarray(grad_steady, jnp.float32).reshape(hw, C))
    gt = (jnp.zeros((film_cfg.height, film_cfg.width, T, C), jnp.float32)
          if grad_transient is None
          else jnp.asarray(grad_transient, jnp.float32).reshape(
              film_cfg.height, film_cfg.width, T, C))

    spp_chunk = max(1, min(spp, max_lanes // max(hw, 1)))
    n_passes = (spp + spp_chunk - 1) // spp_chunk
    spp_chunk = (spp + n_passes - 1) // n_passes
    total_spp = spp_chunk * n_passes

    grads = None
    for p in range(n_passes):
        g = _fullad_pass(
            scene.data, ctx, gs, gt, jnp.uint32(seed), jnp.uint32(p),
            jnp.float32(1.0 / total_spp),
            film_cfg=film_cfg, icfg=icfg, spp=spp_chunk, hw=hw,
            kind=kind,
            skip_le=(kind == "transient_nlos_path" and _skip_le(scene)),
            polarized=polarized, spectral=spectral)
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)

    from .prb import grads_to_named

    return grads_to_named(scene, grads)
