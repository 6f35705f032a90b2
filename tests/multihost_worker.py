"""Worker process for the multi-host SPMD test (tests/test_multihost.py).

Each worker is one 'host': it initializes jax.distributed against the shared
coordinator, contributes its local CPU devices to the global mesh, renders
its spp shard, participates in the cross-process psum (the cross-host path),
and writes the fully-replicated result to disk.

Usage: python multihost_worker.py <proc_id> <nproc> <port> <outfile>
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    proc_id, nproc, port, outfile = (
        int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    # platform setup must precede any jax backend initialization
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

    from mitransient_tpu.parallel.distributed import (
        fetch,
        global_mesh,
        init_distributed,
    )

    init_distributed(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=nproc, process_id=proc_id,
                     local_device_count=2)
    assert jax.process_count() == nproc
    assert jax.device_count() == 2 * nproc

    import numpy as np

    import mitransient_tpu as mitr
    from mitransient_tpu.parallel.mesh import (
        render_backward_sharded,
        render_sharded,
    )

    d = mitr.cornell_box()
    d["sensor"]["film"]["width"] = 8
    d["sensor"]["film"]["height"] = 8
    d["sensor"]["film"]["temporal_bins"] = 30
    d["sensor"]["film"]["start_opl"] = 0.0
    d["sensor"]["film"]["bin_width_opl"] = 0.6
    d["integrator"]["max_depth"] = 3
    d["integrator"]["rr_depth"] = 99
    scene = mitr.load_dict(d)

    mesh = global_mesh()
    steady, transient = render_sharded(scene, mesh, spp=16, seed=0)
    ones_t = np.ones((8, 8, 30, 3), np.float32)
    grads = render_backward_sharded(scene, mesh, (None, ones_t),
                                    spp=8, seed=0)
    g = grads["__tables__"]
    out = fetch({"steady": steady, "transient": transient,
                 "g_bsdf": g.bsdf_reflectance,
                 "g_emitter": g.emitter_radiance})
    np.savez(outfile, **out)
    jax.distributed.shutdown()
    print(f"worker {proc_id} OK", flush=True)


if __name__ == "__main__":
    main()
