"""SoA interaction / sample records (pytrees).

JAX equivalents of Mitsuba's ``SurfaceInteraction3f`` /
``DirectionSample3f`` / ``PositionSample3f`` records that the reference
integrators carry through their wavefront loops
(/root/reference/mitransient/integrators/transientpath.py:129,166).
Represented as NamedTuples of dense ``(N, ...)`` arrays so they are pytrees
and thread through ``lax.fori_loop`` carries and ``shard_map`` unchanged.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .frame import Frame


class Ray(NamedTuple):
    o: jnp.ndarray  # (N, 3) origin
    d: jnp.ndarray  # (N, 3) unit direction
    maxt: jnp.ndarray  # (N,) maximum t (inf for camera rays)

    @staticmethod
    def make(o, d, maxt=None):
        if maxt is None:
            maxt = jnp.full(o.shape[:-1], jnp.inf, jnp.float32)
        return Ray(o, d, maxt)


class SurfaceInteraction(NamedTuple):
    valid: jnp.ndarray  # (N,) bool — hit anything
    t: jnp.ndarray  # (N,) hit distance (inf on miss)
    p: jnp.ndarray  # (N, 3) hit point
    n: jnp.ndarray  # (N, 3) geometric normal (unit, faces ray-independent side)
    frame: Frame  # shading frame (n == frame.n for flat shading)
    uv: jnp.ndarray  # (N, 2)
    wi: jnp.ndarray  # (N, 3) incident dir in local frame (toward viewer)
    prim: jnp.ndarray  # (N,) int32 triangle index (-1 miss)
    shape_id: jnp.ndarray  # (N,) int32
    bsdf_id: jnp.ndarray  # (N,) int32
    emitter_id: jnp.ndarray  # (N,) int32 (-1 = not an emitter)

    def spawn_ray(self, d: jnp.ndarray, offset_eps: float = 1e-4) -> Ray:
        """Offset along the geometric normal on the side of ``d`` to avoid
        self-intersection (epsilon offsetting in lieu of Mitsuba's
        scale-aware ray epsilons)."""
        side = jnp.sign(jnp.sum(self.n * d, axis=-1, keepdims=True))
        o = self.p + self.n * side * offset_eps
        return Ray.make(o, d)


class PositionSample(NamedTuple):
    p: jnp.ndarray  # (N, 3)
    n: jnp.ndarray  # (N, 3)
    uv: jnp.ndarray  # (N, 2)
    pdf: jnp.ndarray  # (N,) area-measure pdf


class DirectionSample(NamedTuple):
    """Sample of a direction toward an emitter from a reference point.

    ``pdf`` is in solid-angle measure at the reference point and includes
    emitter-selection probability (matching
    ``scene.sample_emitter_direction``)."""

    p: jnp.ndarray  # (N, 3) sampled point on the emitter
    n: jnp.ndarray  # (N, 3) emitter normal at p
    d: jnp.ndarray  # (N, 3) unit direction ref -> p
    dist: jnp.ndarray  # (N,)
    pdf: jnp.ndarray  # (N,)
    delta: jnp.ndarray  # (N,) bool — delta emitter (no MIS vs BSDF sampling)
    emitter_id: jnp.ndarray  # (N,) int32


class BSDFSample(NamedTuple):
    wo: jnp.ndarray  # (N, 3) sampled outgoing dir, local frame
    pdf: jnp.ndarray  # (N,)
    eta: jnp.ndarray  # (N,) relative IOR of the sampled event
    delta: jnp.ndarray  # (N,) bool — sampled a Dirac lobe
    weight: jnp.ndarray  # (N, C) or Mueller — bsdf * cos / pdf
