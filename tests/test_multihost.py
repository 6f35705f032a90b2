"""Multi-host (multi-process) SPMD correctness (SURVEY.md section 2.3
'across hosts'; BASELINE '>=90% rays/s scaling at 2 hosts').

Real 2-host hardware is not available to the tests, so the cross-host path
is proven the way JAX itself tests it: two OS processes, each owning 2 virtual CPU
devices, joined by ``jax.distributed`` + gloo collectives into one 4-device
mesh.  The psum of film partials and parameter gradients crosses the process
boundary — the same program that runs across hosts.

Determinism contract under test: sample streams are keyed by *global* device
index, so the 2-process x 2-device render must equal the 1-process x
4-device render bit-for-bit (modulo all-reduce summation order).
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax

import mitransient_tpu as mitr
from mitransient_tpu.parallel.mesh import (
    make_mesh,
    render_backward_sharded,
    render_sharded,
)

HERE = os.path.dirname(__file__)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def multihost_outputs(tmp_path_factory):
    """Run the 2-process render once; yields the two workers' outputs."""
    tmp = tmp_path_factory.mktemp("mh")
    port = _free_port()
    env = dict(os.environ)
    # workers configure their own virtual-device platform
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    outs = [str(tmp / f"out{i}.npz") for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "multihost_worker.py"),
             str(i), "2", str(port), outs[i]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(HERE))
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, _ = p.communicate()
        logs.append(stdout.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i][-4000:]}"
    return [dict(np.load(o)) for o in outs]


def test_processes_agree_bitwise(multihost_outputs):
    """Both hosts hold the identical replicated film and gradients after the
    cross-process all-reduce."""
    a, b = multihost_outputs
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_multihost_equals_single_process(multihost_outputs):
    """2 processes x 2 devices == 1 process x 4 devices: the global-device-
    indexed sample streams make the process layout invisible (the multi-host
    determinism requirement for allclose validation, SURVEY.md section 7
    hard part 7)."""
    a = multihost_outputs[0]
    d = mitr.cornell_box()
    d["sensor"]["film"]["width"] = 8
    d["sensor"]["film"]["height"] = 8
    d["sensor"]["film"]["temporal_bins"] = 30
    d["sensor"]["film"]["start_opl"] = 0.0
    d["sensor"]["film"]["bin_width_opl"] = 0.6
    d["integrator"]["max_depth"] = 3
    d["integrator"]["rr_depth"] = 99
    scene = mitr.load_dict(d)
    mesh = make_mesh(4)
    steady, transient = render_sharded(scene, mesh, spp=16, seed=0)
    ones_t = np.ones((8, 8, 30, 3), np.float32)
    grads = render_backward_sharded(scene, mesh, (None, ones_t), spp=8,
                                    seed=0)
    g = grads["__tables__"]
    # same sample set; tolerance only absorbs all-reduce ordering
    np.testing.assert_allclose(a["steady"], np.asarray(steady), rtol=2e-6,
                               atol=1e-7)
    np.testing.assert_allclose(a["transient"], np.asarray(transient),
                               rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(a["g_bsdf"], np.asarray(g.bsdf_reflectance),
                               rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(a["g_emitter"],
                               np.asarray(g.emitter_radiance),
                               rtol=2e-5, atol=1e-7)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs multiple devices")
def test_scaling_efficiency_measurable():
    """The scaling harness itself: render the same global spp on 1 vs 4
    devices and verify the per-pass structure divides the work (ray counts
    equal), which is what makes >=90% scaling achievable on a real mesh —
    the arithmetic is identical, only the all-reduce is added."""
    scene = mitr.load_dict(mitr.cornell_box())
    _s1, _t1, st1 = render_sharded(scene, make_mesh(1), spp=32, seed=0,
                                   return_stats=True)
    _s4, _t4, st4 = render_sharded(scene, make_mesh(4), spp=32, seed=0,
                                   return_stats=True)
    assert st4["devices"] == 4
    # same total sample budget split 4 ways: ray totals statistically equal
    r1, r4 = float(st1["rays"]), float(st4["rays"])
    assert abs(r1 - r4) / r1 < 0.05
