"""Inverse rendering on the REAL staircase scene: recover perturbed bitmap
texels from the transient video by gradient descent.

The reference's flagship differentiable-transient asset
(/root/reference/examples/diff-transient/staircase/scene.xml: 262k
triangles, bitmap-textured roughplastic walls, max_depth 65, 400 bins)
driven through this framework's texture-gradient path: the wallpaper
texture's atlas texels (`<bsdf>.diffuse_reflectance.data` traverse path)
are darkened, then recovered by Adam on the L2 transient loss via
``render_backward`` (PRB two-sweep replay; texel adjoints are the VJPs of
the atlas lookups, integrators/prb.py).

    python examples/diff_transient/optimize_staircase_texture.py [--quick]

Quick mode shrinks the film/bins/depth.  Every query tests all 262k
triangles (there is no BVH traversal on the GPU yet), so the full config
is slow.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import numpy as np
import optax

from common import example_args

import mitransient_tpu as mitr

SCENE = "/root/reference/examples/diff-transient/staircase/scene.xml"


def main():
    args = example_args("optimize_staircase_texture", __doc__)
    if not os.path.exists(SCENE):
        print("reference staircase scene not mounted; nothing to do")
        return
    if args.quick:
        res, bins, binw, spp, iters, md, lr = (10, 48, 0.25, 4, 2, 3, 0.25)
    else:
        res, bins, binw, spp, iters, md, lr = (64, 200, 0.1, 64, 40, 8, 0.1)
    spp = args.spp or spp

    scene = mitr.load_file(SCENE, resx=res, resy=res, spp=spp,
                           max_depth=md)
    # trim the time window to the configured bin budget (the indirect tail
    # carrying the texture signal spans OPL ~3-15 at shallow depths)
    cfg = scene.sensors[0]
    scene.sensors[0] = cfg._replace(film=cfg.film._replace(
        temporal_bins=bins, start_opl=3.0, bin_width_opl=binw))
    params = mitr.traverse(scene)
    # optimize the wallpaper texture — the dominant visible textured surface
    # (the lampshade/painting textures get little light at shallow depths)
    tex_paths = [k for k in params.keys() if k.endswith(".data")]
    assert tex_paths, "no textured BSDFs found in the staircase scene"
    wall = [k for k in tex_paths if "Wallpaper" in k]
    path = wall[0] if wall else sorted(tex_paths)[0]
    true_tex = np.asarray(params[path]).copy()

    _s, target = mitr.render(scene, spp=spp, seed=0, regenerate=False)
    target = np.asarray(target)

    # perturb: darken the texels 40%
    theta = true_tex * 0.6
    params[path] = theta
    params.update()

    opt = optax.adam(lr)
    opt_state = opt.init(theta)
    loss0 = None
    for it in range(iters):
        _s, t = mitr.render(scene, spp=spp, seed=0, regenerate=False)
        diff = np.asarray(t) - target
        loss = float((diff ** 2).sum())
        if loss0 is None:
            loss0 = loss
        # full-AD backward: exact per-splat time attribution (PRB's
        # read-at-vertex-distance approximation misattributes the
        # fine-binned indirect texture signal on this scene)
        grads = mitr.render_backward(scene, (None, 2.0 * diff), spp=spp,
                                     seed=0, method="fullad")
        # a handful of degenerate mesh lanes (sliver triangles) can leave
        # isolated non-finite adjoints; drop them rather than the step
        g = np.nan_to_num(np.asarray(grads[path]), nan=0.0,
                          posinf=0.0, neginf=0.0)
        upd, opt_state = opt.update(g, opt_state)
        theta = np.clip(theta + np.asarray(upd), 0.0, 1.0)
        params[path] = theta
        params.update()
        err = float(np.abs(theta - true_tex).mean())
        print(f"iter {it:02d}  loss {loss:.6e}  mean|texel err| {err:.4f}",
              flush=True)
    assert loss0 > 0, "perturbed texels produced no transient difference"
    assert loss < loss0 * 0.7, (loss0, loss)
    print(f"staircase texel optimization: loss {loss0:.3e} -> {loss:.3e}")


if __name__ == "__main__":
    main()
