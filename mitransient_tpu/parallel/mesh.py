"""Multi-device / multi-host SPMD rendering over a jax.sharding.Mesh.

The reference has no multi-device code at all (SURVEY.md section 2.3): its
parallelism is one Dr.Jit megakernel on one device.  Here the wavefront
generalizes: the **spp axis is the data-parallel axis**.  Every
device renders the full scan with an independent counter-based sample stream
(stream id = pass * n_devices + global_device_index), producing a private
transient film partial; partials, ray counters and parameter gradients are
``psum``-all-reduced (the mesh may span processes; see
parallel.distributed).  The mesh is 1-D: every card of a host reaches every
other at the same rate, so no axis layout is better than another.  Scene geometry / BSDF /
emitter / NLOS-context tables are replicated — they are tiny next to the
wavefront state.  This is the distributed equivalent of the reference's
sequential pass splitting (common.py:51-85): passes become (device, pass)
pairs.

Every workload shards identically because the film partial is an additive
histogram: perspective transient_path, transient_prbvolpath (volumetric),
transient_nlos_path (single + confocal captures), polarized and spectral
variants all route through :func:`render_sharded`; gradients through
:func:`render_backward_sharded` (PRB replay for transient_path, full-loop
AD for NLOS/volumetric — same dispatch as the single-device ``render``).

Determinism: the counter-based RNG means the set of samples drawn for a
given (seed, total_spp, n_devices) partitioning is reproducible and
independent of the process layout — N devices in one process and N devices
across two hosts draw identical samples (tests/test_multihost.py).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..core.rng import Sampler
from ..film.transient_film import (
    develop_any as develop,
    film_init_any as film_init,
    splat_steady,
)
from ..integrators.path import sample_primal
from ..scene.schema import Scene
from ..sensors.perspective import build_camera, sample_rays
from .distributed import fetch, replicate


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D spp-sharding mesh.  ``jax.devices()`` is the *global* device list,
    so after ``init_distributed`` this mesh spans every host."""
    devs = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np

    return Mesh(np.asarray(devs), ("shard",))


def _sensor_context(scene: Scene, cfg):
    """(is_nlos, replicated-context) for the sensor: camera arrays for
    perspective, the precomputed NLOS target tables for capture meters."""
    nlos = (cfg.kind == "nlos_capture_meter"
            or scene.integrator.kind == "transient_nlos_path")
    if nlos:
        from ..integrators.nlos_path import prepare_nlos_cached

        return True, prepare_nlos_cached(scene, cfg)
    return False, build_camera(cfg)


def render_sharded(
    scene: Scene,
    mesh: Mesh,
    spp: int | None = None,
    seed: int = 0,
    sensor: int = 0,
    spp_per_pass_per_device: int | None = None,
    return_stats: bool = False,
):
    """Distributed ``render``: returns (steady, transient) replicated.

    ``spp`` is the *global* sample count; it is split across ``mesh.size``
    devices and sequential passes.  Supports every sensor/integrator/variant
    combination of the single-device ``render`` except exhaustive NLOS scans
    (whose 6-D film exceeds a single pass; render those per-laser-pixel and
    shard each, as render_nlos_exhaustive does locally).
    """
    cfg = scene.sensors[sensor]
    icfg = scene.integrator
    if icfg.capture_type == "exhaustive" and (
            cfg.kind == "nlos_capture_meter"
            or icfg.kind == "transient_nlos_path"):
        return render_nlos_exhaustive_sharded(
            scene, mesh, spp=spp, seed=seed, sensor=sensor,
            return_stats=return_stats)
    film_cfg = cfg.film
    ndev = mesh.size
    spp = spp if spp is not None else cfg.spp
    # crop windows: lanes cover the DATA (crop) dims; uv mapping uses the
    # full sensor (mi.Film crop semantics) — same scheme as render()
    dw, dh = film_cfg.data_width, film_cfg.data_height
    hw = dw * dh
    polarized = scene.variant.polarized
    spectral = scene.variant.spectral
    volumetric = icfg.kind == "transient_prbvolpath"

    spp_dev = max(1, spp // ndev)
    chunk = spp_per_pass_per_device or min(
        spp_dev, max(1, (1 << 21) // hw))
    n_passes = (spp_dev + chunk - 1) // chunk
    chunk = (spp_dev + n_passes - 1) // n_passes
    total_spp = chunk * n_passes * ndev

    nlos, ctx = _sensor_context(scene, cfg)
    if nlos and film_cfg.is_cropped:
        raise NotImplementedError(
            "NLOS capture films do not support crop windows")
    C_film = scene.variant.color_channels * (4 if polarized else 1)
    scan_pixels = hw if (nlos or film_cfg.is_cropped) else None

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def one_pass(sd, ctx_, seed_, pass_idx):
        didx = jax.lax.axis_index("shard")
        stream = pass_idx * ndev + didx.astype(jnp.uint32)
        sampler = Sampler(seed_, hw * chunk, stream=stream)
        film = film_init(film_cfg, C_film, scan_pixels=scan_pixels)
        if nlos:
            from ..integrators.nlos_path import (
                sample_nlos_primal,
                sample_nlos_rays,
            )

            from ..integrators.nlos_path import can_skip_le

            ray, ray_weight = sample_nlos_rays(ctx_, chunk, hw)
            film, L, _valid, n_rays = sample_nlos_primal(
                sd, ctx_, sampler, ray, ray_weight, film, film_cfg, icfg,
                sample_scale=1.0 / total_spp, base_dim=2, spp=chunk,
                polarized=polarized, spectral=spectral,
                skip_le=can_skip_le(scene.data),
            )
        else:
            ray, pix, ray_weight = sample_rays(
                ctx_, sampler, dw, dh, chunk,
                crop_offset=(film_cfg.crop_offset_x, film_cfg.crop_offset_y),
                full_size=(film_cfg.width, film_cfg.height))
            if volumetric:
                from ..integrators.volpath import sample_volpath_primal

                film, L, _valid, n_rays = sample_volpath_primal(
                    sd, sampler, ray, pix, ray_weight, film, film_cfg, icfg,
                    sample_scale=1.0 / total_spp, base_dim=2, spp=chunk,
                    polarized=polarized, spectral=spectral,
                    cam_vertical=ctx_.R[:, 1],
                )
            else:
                film, L, _valid, n_rays = sample_primal(
                    sd, sampler, ray, pix, ray_weight, film, film_cfg, icfg,
                    sample_scale=1.0 / total_spp, base_dim=2, spp=chunk,
                    polarized=polarized, spectral=spectral,
                    cam_vertical=ctx_.R[:, 1],
                )
        if (not nlos) and film_cfg.rfilter == "gaussian":
            from ..film.transient_film import splat_steady_gaussian

            # reproduce the camera jitter (sampler dims 0-1 of this stream)
            jit2 = Sampler(seed_, hw * chunk, stream=stream).next_2d()
            film = splat_steady_gaussian(
                film, dh, dw, chunk, L, ray_weight,
                jit2, stddev=film_cfg.rfilter_stddev)
        else:
            film = splat_steady(film, chunk, L, ray_weight)
        # all-reduce the film partials over the mesh
        film = jax.tree.map(lambda x: jax.lax.psum(x, "shard"), film)
        n_rays = jax.lax.psum(n_rays, "shard")
        return film, n_rays

    from ..scene.scene import primal_sd

    one_pass_jit = jax.jit(one_pass)
    sd, ctx = replicate((primal_sd(scene.data), ctx), mesh)

    acc = None
    total_rays = 0.0
    for p in range(n_passes):
        film, n_rays = one_pass_jit(sd, ctx, jnp.uint32(seed), jnp.uint32(p))
        total_rays = total_rays + fetch(n_rays)
        acc = film if acc is None else jax.tree.map(jnp.add, acc, film)
    steady, transient = develop(
        acc, film_cfg,
        shape_hw=(film_cfg.height, film_cfg.width) if nlos else (dh, dw))
    if return_stats:
        return steady, transient, {"rays": total_rays, "spp": total_spp,
                                   "devices": ndev}
    return steady, transient


def render_nlos_exhaustive_sharded(
    scene: Scene,
    mesh: Mesh,
    spp: int | None = None,
    seed: int = 0,
    sensor: int = 0,
    max_lanes: int = 1 << 21,
    progress_callback=None,
    return_stats: bool = False,
):
    """Distributed exhaustive NLOS capture: the LASER AXIS is sharded over
    the mesh — each device runs the fused all-laser-slab wavefront
    (integrators/nlos_path.sample_nlos_exhaustive_primal) on its block of
    illumination points with the identical sample streams as the local
    driver (path sampling is laser-independent), so the sharded 6-D film
    equals the local one bit-for-bit while the per-bounce NEE work divides
    by ``mesh.size``.  Polarized/spectral variants and non-delta emitters
    fall back to the per-point round-robin driver."""
    import numpy as np

    from ..integrators.nlos_path import (
        EM_PROJECTOR,
        exhaustive_laser_targets,
        prepare_exhaustive_lasers,
        prepare_nlos_cached,
        sample_nlos_exhaustive_primal,
        sample_nlos_rays,
    )
    from ..scene.scene import EM_POINT

    cfg = scene.sensors[sensor]
    film_cfg = cfg.film
    kinds = scene.data.emitter.ks.kinds
    delta_laser = kinds and all(k in (EM_PROJECTOR, EM_POINT)
                                for k in kinds)
    if (scene.variant.polarized or scene.variant.spectral
            or not delta_laser or not scene.integrator.nlos_laser_sampling):
        return _render_nlos_exhaustive_sharded_perpoint(
            scene, mesh, spp=spp, seed=seed, sensor=sensor,
            max_lanes=max_lanes, progress_callback=progress_callback,
            return_stats=return_stats)
    if not film_cfg.exhaustive_scan:
        raise ValueError("exhaustive capture requires a film with "
                         "exhaustive_scan=True (transient_hdr_film.py:80-88)")
    lw, lh = film_cfg.laser_scan_width, film_cfg.laser_scan_height
    if lw <= 0 or lh <= 0:
        raise ValueError("laser_scan_width/height must be set for "
                         "exhaustive captures")
    icfg = scene.integrator
    spp = spp if spp is not None else cfg.spp
    h, w = film_cfg.height, film_cfg.width
    hw = h * w
    C = scene.variant.color_channels
    T = film_cfg.temporal_bins
    ndev = mesh.size

    targets, tvalid = exhaustive_laser_targets(scene, cfg, icfg)
    lasers = prepare_exhaustive_lasers(scene, targets)
    lasers = lasers._replace(
        wall_clear=lasers.wall_clear & jnp.asarray(tvalid))
    L = targets.shape[0]

    if not scene.laser_focused:
        from ..nlos import focus_emitter_at_relay_wall_3dpoint

        focus_emitter_at_relay_wall_3dpoint(
            targets[int(np.argmax(tvalid))], scene)
    saved_icfg = scene.integrator
    scene.integrator = icfg._replace(capture_type="single")
    try:
        ctx = prepare_nlos_cached(scene, cfg, sensor)
    finally:
        scene.integrator = saved_icfg

    spp_chunk = max(1, min(spp, max_lanes // max(hw, 1)))
    n_passes = (spp + spp_chunk - 1) // spp_chunk
    spp_chunk = (spp + n_passes - 1) // n_passes
    total_spp = spp_chunk * n_passes

    Ld = (L + ndev - 1) // ndev
    L_pad = Ld * ndev
    if L_pad > L:
        pad = L_pad - L
        lasers = jax.tree.map(
            lambda a: jnp.concatenate(
                [a, jnp.repeat(a[-1:], pad, axis=0)], axis=0), lasers)
        lasers = lasers._replace(
            wall_clear=lasers.wall_clear.at[L:].set(False))
    lasers_b = jax.tree.map(
        lambda a: a.reshape((ndev, Ld) + a.shape[1:]), lasers)

    from ..film.transient_film import TransientFilmState, t_pad_of

    slab_stride = Ld * hw
    T_pad = t_pad_of(film_cfg)

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P("shard"), P("shard"), P(), P()),
        out_specs=(P("shard"), P(), P()),
        check_vma=False,
    )
    def one_pass(sd, ctx_, lasers_d, tr_d, seed_, pass_idx):
        lasers_ = jax.tree.map(lambda a: a[0], lasers_d)
        n = spp_chunk * hw
        sampler = Sampler(seed_, n, stream=pass_idx)
        ray, ray_weight = sample_nlos_rays(ctx_, spp_chunk, hw)
        film = TransientFilmState(
            steady=jnp.zeros((hw, C), jnp.float32),
            steady_weight=jnp.zeros((hw,), jnp.float32),
            transient=tr_d[0],
            n_negative=jnp.zeros((), jnp.float32),
            n_invalid=jnp.zeros((), jnp.float32),
        )
        film, L_sum, _valid, n_rays = sample_nlos_exhaustive_primal(
            sd, ctx_, lasers_, sampler, ray, ray_weight, film, film_cfg,
            icfg, 1.0 / total_spp, spp=spp_chunk, hw=hw,
        )
        L_tot = jax.lax.psum(L_sum, "shard")  # sum over the full grid
        n_rays = jax.lax.psum(n_rays, "shard")
        return film.transient[None], L_tot, n_rays

    from ..scene.scene import primal_sd

    one_pass_jit = jax.jit(one_pass, donate_argnums=(3,))
    sd, ctx = replicate((primal_sd(scene.data), ctx), mesh)

    tr = jnp.zeros((ndev, C, T_pad, slab_stride), jnp.float32)
    steady_val = np.zeros((hw, C), np.float32)
    total_rays = 0.0
    for p in range(n_passes):
        tr, L_tot, n_rays = one_pass_jit(sd, ctx, lasers_b, tr,
                                         jnp.uint32(seed), jnp.uint32(p))
        steady_val += np.asarray(L_tot).reshape(
            spp_chunk, hw, C).sum(axis=0)
        total_rays += float(np.asarray(n_rays))
        if progress_callback is not None:
            progress_callback((p + 1) / n_passes)

    steady = (steady_val / (total_spp * L)).reshape(h, w, C)
    tr_np = np.asarray(tr)  # (ndev, C, T_pad, slab_stride)
    out = np.zeros((h, w, lh, lw, T, C), np.float32)
    for k in range(ndev):
        blk = tr_np[k][:, :T, : Ld * hw].reshape(C, T, Ld, hw)
        for l_loc in range(Ld):
            i = k * Ld + l_loc
            if i >= L:
                break
            ly, lx = divmod(i, lw)
            out[:, :, ly, lx] = np.transpose(
                blk[:, :, l_loc, :], (2, 1, 0)).reshape(h, w, T, C)
    if return_stats:
        return steady, out, {"rays": total_rays, "spp": spp * L,
                             "devices": ndev}
    return steady, out


def _render_nlos_exhaustive_sharded_perpoint(
    scene: Scene,
    mesh: Mesh,
    spp: int | None = None,
    seed: int = 0,
    sensor: int = 0,
    max_lanes: int = 1 << 21,
    progress_callback=None,
    return_stats: bool = False,
):
    """Per-point fallback (polarized / spectral / non-delta emitters): the
    laser grid is round-robined over the mesh — each device renders WHOLE
    illumination points with the full spp budget and the identical
    pass/stream layout as the local per-point driver."""
    import numpy as np

    from ..integrators.nlos_path import (
        can_skip_le,
        prepare_nlos,
        sample_nlos_primal,
        sample_nlos_rays,
    )
    from ..nlos import focus_emitter_at_relay_wall_3dpoint

    cfg = scene.sensors[sensor]
    film_cfg = cfg.film
    if not film_cfg.exhaustive_scan:
        raise ValueError("exhaustive capture requires a film with "
                         "exhaustive_scan=True (transient_hdr_film.py:80-88)")
    lw, lh = film_cfg.laser_scan_width, film_cfg.laser_scan_height
    if lw <= 0 or lh <= 0:
        raise ValueError("laser_scan_width/height must be set for "
                         "exhaustive captures")
    spp = spp if spp is not None else cfg.spp
    hw = film_cfg.width * film_cfg.height
    h, w = film_cfg.height, film_cfg.width
    polarized = scene.variant.polarized
    C_film = scene.variant.color_channels * (4 if polarized else 1)
    T = film_cfg.temporal_bins
    ndev = mesh.size

    wall_shape = scene.shapes[cfg.shape_index]
    px, py = np.meshgrid(np.arange(lw), np.arange(lh))
    uv = np.stack([(px.ravel() + 0.5) / lw, (py.ravel() + 0.5) / lh], -1)
    laser_targets = wall_shape.position_from_uv(uv).astype(np.float32)
    n_pts = lh * lw

    # identical pass/stream layout as the local driver (render_nlos)
    spp_chunk = max(1, min(spp, max_lanes // max(hw, 1)))
    n_passes = (spp + spp_chunk - 1) // spp_chunk
    spp_chunk = (spp + n_passes - 1) // n_passes
    total_spp = spp_chunk * n_passes

    saved_icfg = scene.integrator
    scene.integrator = saved_icfg._replace(capture_type="single")
    icfg = scene.integrator
    try:
        skip_le = can_skip_le(scene.data)
        ctxs = []
        for i in range(n_pts):
            focus_emitter_at_relay_wall_3dpoint(laser_targets[i], scene)
            ctxs.append(prepare_nlos(scene, cfg))
    finally:
        scene.integrator = saved_icfg

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P("shard"), P(), P()),
        out_specs=((P("shard"), P("shard")), P("shard")),
        check_vma=False,
    )
    def one_round(sd, ctx_b, seed_, pass_idx):
        ctx_ = jax.tree.map(lambda a: a[0], ctx_b)  # this device's context
        sampler = Sampler(seed_, hw * spp_chunk, stream=pass_idx)
        film = film_init(film_cfg, C_film, scan_pixels=hw)
        ray, ray_weight = sample_nlos_rays(ctx_, spp_chunk, hw)
        film, L, _valid, n_rays = sample_nlos_primal(
            sd, ctx_, sampler, ray, ray_weight, film, film_cfg, icfg,
            sample_scale=1.0 / total_spp, base_dim=2, spp=spp_chunk,
            polarized=polarized, spectral=scene.variant.spectral,
            skip_le=skip_le,
        )
        film = splat_steady(film, spp_chunk, L, ray_weight)
        tr = film.transient[None]  # (1, C, T_pad, HW_pad) -> stacked
        st = (film.steady / jnp.maximum(film.steady_weight, 1.0)[:, None])[
            None]
        return (tr, st), n_rays[None]

    from ..scene.scene import primal_sd

    one_round_jit = jax.jit(one_round)
    sd = replicate(primal_sd(scene.data), mesh)

    out = np.zeros((h, w, lh, lw, T, C_film), np.float32)
    steady_acc = np.zeros((h, w, C_film), np.float32)
    total_rays = 0.0
    n_rounds = (n_pts + ndev - 1) // ndev
    for r in range(n_rounds):
        idx = [min(r * ndev + k, n_pts - 1) for k in range(ndev)]
        ctx_b = jax.tree.map(
            lambda *leaves: jnp.stack(leaves), *[ctxs[i] for i in idx])
        tr_acc = None
        st_acc = None
        for p in range(n_passes):
            (tr, st), nr = one_round_jit(sd, ctx_b, jnp.uint32(seed),
                                         jnp.uint32(p))
            tr_acc = tr if tr_acc is None else tr_acc + tr
            st_acc = st if st_acc is None else st_acc + st
            total_rays += float(jnp.sum(nr))
        tr_np = np.asarray(tr_acc)  # (ndev, C, T_pad, HW_pad)
        st_np = np.asarray(st_acc) / n_passes
        for k in range(ndev):
            i = r * ndev + k
            if i >= n_pts:
                break
            ly, lx = divmod(i, lw)
            slab = np.transpose(tr_np[k][:, :T, :hw], (2, 1, 0)).reshape(
                h, w, T, C_film)
            out[:, :, ly, lx] = slab
            steady_acc += st_np[k].reshape(h, w, C_film) / n_pts
        if progress_callback is not None:
            progress_callback((r + 1) / n_rounds)

    if return_stats:
        return steady_acc, out, {"rays": total_rays, "spp": spp * n_pts,
                                 "devices": ndev}
    return steady_acc, out


def _grads_to_paths(scene: Scene, grads) -> dict:
    """Map raw parameter-table gradients to traversal paths — all
    differentiable tables, matching single-device render_backward."""
    from ..integrators.prb import grads_to_named

    return grads_to_named(scene, grads)


def render_backward_sharded(
    scene: Scene,
    mesh: Mesh,
    grad_in,
    spp: int | None = None,
    seed: int = 0,
    sensor: int = 0,
):
    """Distributed differential rendering: every device runs the backward
    estimator on its spp share (independent counter streams), parameter
    gradients are psum-all-reduced — the full data-parallel training step of
    an inverse-rendering loop (the distributed generalization the reference
    lacks, SURVEY.md section 2.3).

    Dispatch matches single-device ``render_backward``: PRB two-sweep replay
    for transient_path; full-loop AD (integrators/fullad.py) for
    transient_nlos_path and transient_prbvolpath.  Returns the same gradient
    dict (all three parameter tables mapped to traversal paths).
    """
    cfg = scene.sensors[sensor]
    icfg = scene.integrator
    film_cfg = cfg.film
    if film_cfg.is_cropped:
        raise NotImplementedError(
            "sharded rendering with a cropped film is not supported")
    ndev = mesh.size
    spp = spp if spp is not None else cfg.spp
    spp_dev = max(1, spp // ndev)
    total_spp = spp_dev * ndev
    hw = film_cfg.width * film_cfg.height
    polarized = scene.variant.polarized
    spectral = scene.variant.spectral
    C = scene.variant.color_channels * (4 if polarized else 1)
    T = film_cfg.temporal_bins

    grad_steady, grad_transient = grad_in
    gs = (jnp.zeros((hw, C), jnp.float32) if grad_steady is None
          else jnp.asarray(grad_steady, jnp.float32).reshape(hw, C))

    if (icfg.kind in ("transient_nlos_path", "transient_prbvolpath")
            or polarized or spectral):
        # polarized/spectral transient_path also routes through full-loop
        # AD: the PRB replay below is the unpolarized-RGB estimator
        from ..integrators.fullad import fullad_grads

        if icfg.capture_type == "exhaustive" and (
                icfg.kind == "transient_nlos_path"):
            raise ValueError(
                "Exhaustive capture is not supported in differentiable "
                "rendering (transientnlospath.py:729-731)")
        gt_full = (jnp.zeros((film_cfg.height, film_cfg.width, T, C),
                             jnp.float32)
                   if grad_transient is None
                   else jnp.asarray(grad_transient, jnp.float32).reshape(
                       film_cfg.height, film_cfg.width, T, C))
        nlos, ctx = _sensor_context(scene, cfg)
        kind = icfg.kind

        @partial(
            shard_map, mesh=mesh,
            in_specs=(P(),) * 5, out_specs=P(), check_vma=False,
        )
        def step(sd, ctx_, gs_, gt_, seed_):
            didx = jax.lax.axis_index("shard").astype(jnp.uint32)
            from ..integrators.nlos_path import can_skip_le

            g = fullad_grads(
                sd, ctx_, gs_, gt_, seed_, didx, 1.0 / total_spp,
                film_cfg=film_cfg, icfg=icfg, spp=spp_dev, hw=hw, kind=kind,
                skip_le=(kind == "transient_nlos_path"
                         and can_skip_le(scene.data)),
                polarized=polarized, spectral=spectral)
            return jax.tree.map(lambda x: jax.lax.psum(x, "shard"), g)

        sd, ctx, gs, gt_full = replicate(
            (scene.data, ctx, gs, gt_full), mesh)
        grads = jax.jit(step)(sd, ctx, gs, gt_full, jnp.uint32(seed))
        return _grads_to_paths(scene, grads)

    # --- transient_path: PRB two-sweep replay per device -------------------
    from ..integrators.prb import sample_adjoint

    gt = (jnp.zeros((hw * T, C), jnp.float32) if grad_transient is None
          else jnp.asarray(grad_transient, jnp.float32).reshape(hw * T, C))
    cam = build_camera(cfg)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def step(sd, cam_, gs_, gt_, seed_):
        didx = jax.lax.axis_index("shard").astype(jnp.uint32)
        n = hw * spp_dev
        sampler = Sampler(seed_, n, stream=didx)
        ray, pix, ray_weight = sample_rays(
            cam_, sampler, film_cfg.width, film_cfg.height, spp_dev)
        film = film_init(film_cfg, C)
        _f, L, _v, _r = sample_primal(
            sd, sampler, ray, pix, ray_weight, film, film_cfg, icfg,
            sample_scale=1.0 / total_spp, base_dim=2, spp=spp_dev,
            enable_film=False,
        )
        grads = sample_adjoint(
            sd, sampler.key, ray, pix, ray_weight, L, gt_, gs_,
            film_cfg, icfg, 1.0 / total_spp, base_dim=2, mode="backward",
        )
        return jax.tree.map(lambda x: jax.lax.psum(x, "shard"), grads)

    sd, cam, gs, gt = replicate((scene.data, cam, gs, gt), mesh)
    grads = jax.jit(step)(sd, cam, gs, gt, jnp.uint32(seed))
    return _grads_to_paths(scene, grads)
