"""Small vector-math helpers over SoA ``(..., 3)`` jnp arrays.

The reference stack keeps vectors as Dr.Jit ``Point3f``/``Vector3f`` wide
arrays; here a wavefront of N rays is a dense ``(N, 3)`` float32 array, so
every op is a plain elementwise array op with no AoS/SoA conversion.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

EPS = 1e-6
INF = jnp.inf


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis -> shape ``(...)``."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def norm(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(dot(a, a), 0.0))


def squared_norm(a: jnp.ndarray) -> jnp.ndarray:
    return dot(a, a)


def normalize(a: jnp.ndarray) -> jnp.ndarray:
    # sqrt-of-clamped-square keeps the VJP finite for zero vectors (sqrt's
    # VJP at 0 is inf, which poisons masked gradients as inf * 0 = NaN);
    # identical to the naive form whenever |a| >= 1e-12
    n2 = dot(a, a)
    return a / jnp.sqrt(jnp.maximum(n2, 1e-24))[..., None]


def safe_rcp(x: jnp.ndarray) -> jnp.ndarray:
    """Reciprocal that returns 0 where ``x == 0`` (Dr.Jit's masked ``dr.rcp``
    idiom used e.g. in the reference russian roulette,
    mitransient/integrators/transientpath.py:255)."""
    nz = jnp.abs(x) > 1e-20
    return jnp.where(nz, 1.0 / jnp.where(nz, x, 1.0), 0.0)


def safe_div(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """``a / b`` with 0 where ``|b|`` is (denormal-)zero (broadcasts).

    The threshold (vs ``b == 0``) keeps degenerate-geometry divisions
    (sliver-triangle barycentric determinants etc.) from producing primal
    infs that turn into NaN gradients through downstream masks."""
    bz = jnp.abs(b) < 1e-20
    return jnp.where(bz, 0.0, a / jnp.where(bz, 1.0, b))


def safe_sqrt(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(x, 0.0))


def stable_sqrt(x: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """sqrt clamped at 0 like safe_sqrt but with a FINITE gradient when the
    argument touches 0 (sqrt's VJP is 1/(2 sqrt) -> inf at 0, which turns
    into NaN through any downstream where-mask: inf * 0).  Value deviates
    only for x in (0, eps): sqrt(eps) = 1e-6."""
    return jnp.sqrt(jnp.maximum(x, eps)) * (x > 0.0)


def stable_normalize(v: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """normalize() whose VJP stays finite for zero-length vectors
    (jnp.linalg.norm's VJP is v/|v| -> NaN at 0, which poisons masked
    gradients); returns 0 for the zero vector."""
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    return v / jnp.sqrt(jnp.maximum(n2, eps * eps))


def lerp(a, b, t):
    return a + (b - a) * t


def mis_weight(pdf_a: jnp.ndarray, pdf_b: jnp.ndarray) -> jnp.ndarray:
    """Power heuristic (beta=2) multiple importance sampling weight.

    Mirrors ``mitsuba.ad.integrators.common.mis_weight`` as consumed by the
    reference (mitransient/integrators/transientpath.py:6,168-171): returns
    ``pdf_a^2 / (pdf_a^2 + pdf_b^2)`` and 0 when ``pdf_a == 0``.
    """
    a2 = pdf_a * pdf_a
    w = safe_div(a2, a2 + pdf_b * pdf_b)
    return jnp.where(jnp.isfinite(w), w, 0.0)


def rodrigues(w: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrices from axis-angle vectors ``w`` (..., 3) — angle =
    |w| radians about w.  Series-safe at w -> 0 (R == I exactly at w == 0,
    with the correct derivative dR = skew(dw)); used for the differentiable
    per-shape rotation deltas of geometry gradients."""
    theta2 = jnp.sum(w * w, axis=-1)
    # clamp at 1e-12 (not smaller): the reciprocal's VJP squares the
    # denominator, and (1e-24)^2 underflows f32 -> inf * 0 = NaN
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-12))
    small = theta2 < 1e-12
    # sin(t)/t and (1-cos t)/t^2 with Taylor fallbacks near 0
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0,
                  (1.0 - jnp.cos(theta)) / jnp.maximum(theta2, 1e-12))
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    K = jnp.stack([
        jnp.stack([zero, -wz, wy], axis=-1),
        jnp.stack([wz, zero, -wx], axis=-1),
        jnp.stack([-wy, wx, zero], axis=-1),
    ], axis=-2)  # (..., 3, 3)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), K.shape)
    K2 = jnp.einsum("...ij,...jk->...ik", K, K, precision=jax.lax.Precision.HIGHEST)
    return eye + a[..., None, None] * K + b[..., None, None] * K2


def matvec3(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Batched (..., 3, 3) @ (..., 3)."""
    return jnp.einsum("...ij,...j->...i", m, v, precision=jax.lax.Precision.HIGHEST)
