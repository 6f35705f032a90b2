"""Large meshes: scenes beyond a few thousand triangles use the same
brute-force triangle sweep as the canonical small scenes (the reference
hands them to Embree/OptiX BVHs; a GPU BVH traversal is future work)."""
import numpy as np


def test_scene_builds_accel_above_threshold():
    """An 8192-triangle mesh renders through the same triangle sweep as the
    small scenes: finite, non-zero output."""
    import mitransient_tpu as mitr

    # a finely-subdivided quad -> 8192 triangles
    n = 64
    xs = np.linspace(-1, 1, n + 1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    P = np.stack([X, Y, np.zeros_like(X)], -1).reshape(-1, 3)

    def vid(i, j):
        return i * (n + 1) + j

    faces = []
    for i in range(n):
        for j in range(n):
            faces.append([vid(i, j), vid(i + 1, j), vid(i, j + 1)])
            faces.append([vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)])
    sc = mitr.load_dict({
        "type": "scene",
        "integrator": {"type": "transient_path", "max_depth": 3},
        "mesh": {
            "type": "mesh", "vertices": P.astype(np.float32),
            "faces": np.asarray(faces, np.int32),
            "bsdf": {"type": "diffuse", "reflectance": 0.6},
        },
        "light": {
            "type": "rectangle",
            "to_world": {"translate": [0, 0, 2],
                          "scale": [0.3, 0.3, 1.0]},
            "emitter": {"type": "area", "radiance": 10.0},
        },
        "sensor": {
            "type": "perspective", "fov": 45,
            "to_world": {"look_at": {"origin": [0, 0, 3],
                                      "target": [0, 0, 0],
                                      "up": [0, 1, 0]}},
            "film": {"type": "transient_hdr_film", "width": 8, "height": 8,
                     "temporal_bins": 16, "start_opl": 0.0,
                     "bin_width_opl": 0.8},
        },
    })
    assert sc.data.tri.v0.shape[0] == 2 * n * n + 2  # mesh + light quad
    s, t = mitr.render(sc, spp=2, seed=0)
    assert np.isfinite(np.asarray(s)).all()
    assert float(np.asarray(s).max()) > 0.0
