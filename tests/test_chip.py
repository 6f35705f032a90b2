"""Tests that need the card: the compiled Triton-route intersection kernels
and the dispatch that picks them.  Marked ``chip``; they skip unless JAX's
default backend is a GPU.  On the card they run as the last phase of
``python chip_smoke.py`` (``MITR_CHIP_TESTS=1 pytest -m chip
tests/test_chip.py`` by hand).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mitransient_tpu.ops.intersect import (closest_hit, intersect_soup,
                                           ray_test, ray_test_soup)
from mitransient_tpu.ops.intersect_triton import (closest_hit_triton,
                                                  ray_test_triton)

pytestmark = pytest.mark.chip


def _case(m, n, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    e1 = rng.uniform(-0.6, 0.6, (m, 3)).astype(np.float32)
    e2 = rng.uniform(-0.6, 0.6, (m, 3)).astype(np.float32)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = (rng.uniform(-0.5, 0.5, (n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxt = np.where(rng.uniform(size=n) < 0.5, np.inf,
                    rng.uniform(0.5, 4.0, n)).astype(np.float32)
    act = rng.uniform(size=n) < 0.9
    return tuple(jnp.asarray(x) for x in (v0, e1, e2, o, d, maxt, act))


@pytest.mark.parametrize("m,n", [(36, 1 << 16), (37, 1000), (300, 4099)])
def test_compiled_kernels_match_reference(m, n):
    args = _case(m, n, seed=m + n)
    t_r, p_r, _u, _v = (np.asarray(x) for x in intersect_soup(*args))
    t_k, p_k = (np.asarray(x) for x in closest_hit_triton(*args))
    same = p_r == p_k
    # random triangles in general position: exact ties are vanishingly rare
    assert same.mean() > 0.9999
    hit = same & (p_r >= 0)
    np.testing.assert_allclose(t_k[hit], t_r[hit], rtol=1e-5)
    occ_r = np.asarray(ray_test_soup(*args))
    occ_k = np.asarray(ray_test_triton(*args))
    assert (occ_r == occ_k).mean() > 0.9999


def test_dispatch_takes_kernels_on_gpu():
    args = _case(36, 1024, seed=0)
    for fn, name in ((closest_hit, "mitr_closest_hit"),
                     (ray_test, "mitr_any_hit")):
        hlo = jax.jit(fn).lower(*args).as_text()
        assert "triton" in hlo and name in hlo, name
