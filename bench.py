"""Benchmark: transient Cornell box + NLOS rays/sec on one GPU (BASELINE.md).

Workloads:
* the canonical transient cbox — 256x256 px, 300 time bins, start_opl 3.5,
  bin_width_opl 0.02, max_depth 8 (reference mitransient/utils.py:78-220)
* NLOS single capture — 32x32 scan, 300 bins, laser + hidden-geometry
  sampling at spp 2048 (nlos-z-simple.xml pattern, ``utils.nlos_scene``)

Run from the repository root on a machine with a GPU (one JAX process per
card):

    python bench.py [transient_cbox] [nlos_single]

The first line names the device; then one JSON line per workload
(``{"metric", "value", "unit", "vs_baseline", "detail"}``).  ``value``
counts rays actually traced (closest-hit wavefront rays + NEE shadow rays,
i.e. active lanes per bounce), divided by the best wall time of the timed
reps, each of which ends in ``jax.block_until_ready``.  The reference
publishes no numbers (BASELINE.md), so ``vs_baseline`` is None.  Without a
GPU the run fails.
"""
from __future__ import annotations

import json
import time

import jax

from benchmarks.device import header


def _bench(name, scene, spp, img, device, reps=3, **kw):
    import mitransient_tpu as mitr

    # warmup / compile at the same per-pass shapes as the timed reps
    jax.block_until_ready(mitr.render(scene, spp=spp, seed=0, **kw))
    best = None
    for rep in range(reps):
        t0 = time.perf_counter()
        s, t, stats = mitr.render(scene, spp=spp, seed=1 + rep,
                                  return_stats=True, **kw)
        jax.block_until_ready((s, t))
        dt = time.perf_counter() - t0
        if best is None or dt < best:
            best = dt
    rays = float(stats["rays"])
    print(json.dumps({
        "metric": f"{name}_rays_per_sec",
        "value": rays / best,
        "unit": "rays/s",
        "vs_baseline": None,  # the reference publishes no numbers
        "detail": {
            "device": device,
            "spp": int(stats["spp"]),
            "wall_s": best,
            "rays": rays,
            "img": img,
        },
    }), flush=True)


def main():
    import sys

    import mitransient_tpu as mitr

    device = header()
    print(json.dumps({"device": device}), flush=True)
    names = sys.argv[1:] or ["transient_cbox", "nlos_single"]

    if "transient_cbox" in names:
        _bench("transient_cbox", mitr.load_dict(mitr.cornell_box()), 1024,
               [256, 256, 300], device)

    if "nlos_single" in names:
        nscene = mitr.load_dict(mitr.utils.nlos_scene(sx=32, sy=32))
        mitr.nlos.focus_emitter_at_relay_wall_pixel([16.0, 16.0], nscene)
        _bench("nlos_single", nscene, 2048, [32, 32, 300], device)


if __name__ == "__main__":
    main()
