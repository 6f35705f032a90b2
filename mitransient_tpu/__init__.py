"""mitransient_tpu — transient light-transport rendering in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
`diegoroyo/mitransient` (transient + NLOS differentiable rendering on top of
Mitsuba 3): dense wavefront path tracing under ``jit``, SoA scene pytrees,
counter-based RNG, scatter-add transient films, PRB-style two-sweep
differentiation, and ``shard_map`` scaling over device meshes.

Unlike the reference (which refuses to import without a Mitsuba variant set,
reference __init__.py:3-13), variants here are plain values — see
``set_variant`` / ``variant`` — defaulting to ``rgb``.
"""
import os as _os

import jax as _jax

# Persistent compilation cache.  JAX reads JAX_COMPILATION_CACHE_DIR itself;
# when it is set nothing is configured here.  Otherwise the cache lives in
# one fixed, git-ignored directory of the checkout: the path is part of what
# makes a later process find the entries again.
COMPILE_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from . import nlos, vis, vis_polarized  # noqa: F401
from .log import LogLevel, log, set_log_level  # noqa: F401
from .core.spectrum import (  # noqa: F401
    is_monochromatic,
    is_polarized,
    is_rgb,
    set_variant,
    variant,
)
from .render import (  # noqa: F401
    load_film_state,
    render,
    render_aovs,
    render_backward,
    render_forward,
    save_film_state,
)
from .scene.schema import Scene, load_dict, traverse  # noqa: F401
from .scene.xml_loader import load_file  # noqa: F401
from .utils import cornell_box, speed_of_light  # noqa: F401
from .version import __version__  # noqa: F401
