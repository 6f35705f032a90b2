"""Pinhole perspective camera ray generation.

JAX equivalent of Mitsuba's ``perspective`` sensor +
``ADIntegrator.sample_rays`` film-position sampling consumed by the reference
(mitransient/integrators/common.py:159).  Conventions: camera looks along its
local +z (Mitsuba ``look_at``), film u grows right / v grows down, pixel
(0, 0) top-left; camera-space x axis is the look_at 'left' vector so
``x_cam = (1 - 2u) * tan_half_x`` reproduces Mitsuba's image orientation.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..core.math import normalize
from ..core.records import Ray
from ..core.rng import Sampler
from ..scene.schema import SensorConfig


class CameraArrays(NamedTuple):
    """Device-side camera parameters."""

    R: jnp.ndarray  # (3, 3) columns = camera x/y/z axes in world space
    origin: jnp.ndarray  # (3,)
    tan_half: jnp.ndarray  # (2,) [x, y]


def build_camera(cfg: SensorConfig) -> CameraArrays:
    m = cfg.to_world.m
    fov_rad = math.radians(cfg.fov)
    w, h = cfg.film.width, cfg.film.height
    aspect = w / h
    t = math.tan(fov_rad / 2.0)
    axis = cfg.fov_axis
    if axis == "smaller":
        axis = "x" if w <= h else "y"
    elif axis == "larger":
        axis = "x" if w >= h else "y"
    if axis == "x":
        tx, ty = t, t / aspect
    else:
        tx, ty = t * aspect, t
    return CameraArrays(
        R=jnp.asarray(m[:3, :3], jnp.float32),
        origin=jnp.asarray(m[:3, 3], jnp.float32),
        tan_half=jnp.asarray([tx, ty], jnp.float32),
    )


def sample_rays(
    cam: CameraArrays,
    sampler: Sampler,
    width: int,
    height: int,
    spp: int,
    crop_offset: tuple[int, int] = (0, 0),
    full_size: tuple[int, int] | None = None,
):
    """Generate ``H*W*spp`` lanes (spp-major: lane = s * HW + pix, the
    layout the Pallas transient-splat kernel requires).

    ``width``/``height`` are the DATA (crop-window) dimensions; with a
    crop, ``crop_offset`` places the window on the full sensor and
    ``full_size`` gives the full film dimensions for the uv mapping
    (mi.Film crop semantics: the projection is that of the full sensor).

    Returns (Ray, pix (N,) int32, ray_weight (N,)).  Consumes sampler dims
    0-1 (pixel jitter).
    """
    fw, fh = full_size if full_size is not None else (width, height)
    ox, oy = crop_offset
    hw = width * height
    n = hw * spp
    lane = jnp.arange(n, dtype=jnp.int32)
    pix = lane % hw
    px = (pix % width).astype(jnp.float32) + float(ox)
    py = (pix // width).astype(jnp.float32) + float(oy)

    jitter = sampler.next_2d()  # dims 0-1
    u = (px + jitter[:, 0]) / fw
    v = (py + jitter[:, 1]) / fh

    cx = (1.0 - 2.0 * u) * cam.tan_half[0]
    cy = (1.0 - 2.0 * v) * cam.tan_half[1]
    # camera -> world (d_cam = (cx, cy, 1)) as elementwise sums: exact
    # float32, and no K=3 matrix product for XLA to hand to cuBLAS
    d_world = normalize(cx[:, None] * cam.R[:, 0] + cy[:, None] * cam.R[:, 1]
                        + cam.R[:, 2])
    o = jnp.broadcast_to(cam.origin, (n, 3))
    ray = Ray.make(o, d_world)
    return ray, pix, jnp.ones((n,), jnp.float32)
