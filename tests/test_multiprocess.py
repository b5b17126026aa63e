"""Multi-host simulation: 2 jax.distributed processes x 4 CPU devices.

The reference has no distributed surface; this validates the framework's
multi-host story (SURVEY.md §4 testing blueprint) end-to-end: global mesh
over two OS processes, pmax width agreement and psum'd round-trip
validation riding real (Gloo) cross-process collectives.
"""

import os
import socket
import subprocess
import sys
import textwrap


_WORKER = textwrap.dedent("""
    import os, sys
    pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address="127.0.0.1:" + port,
                               num_processes=nproc, process_id=pid)
    import numpy as np
    sys.path.insert(0, {repo!r})
    from fastlanes_tpu.parallel import mesh as pmesh, shard as psh

    mesh = pmesh.make_mesh()
    assert len(jax.devices()) == 4 * nproc, len(jax.devices())
    rng = np.random.default_rng(7)
    values = rng.integers(0, 1 << 11, (64, 1024), np.int64).astype(np.uint32)
    w = int(psh.global_max_bits(mesh, values, "u32"))
    assert w == 11, w
    bad = int(psh.sharded_roundtrip_check(mesh, values, w, "u32"))
    assert bad == 0, bad
    print("OK", pid, flush=True)
""").format(repo=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run_workers(worker, port, env):
    procs = [subprocess.Popen([sys.executable, str(worker), str(pid), "2", port],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env)
             for pid in range(2)]
    try:
        return [p.communicate(timeout=240)[0] for p in procs], procs
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        return None, procs


def test_two_process_distributed_roundtrip(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    outs = procs = None
    for _attempt in range(2):  # bind-then-close port pick is racy: retry once
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = str(s.getsockname()[1])
        outs, procs = _run_workers(worker, port, env)
        if outs is not None:
            break
    assert outs is not None, "workers hung twice (coordinator port race?)"
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-2000:]}"
        assert f"OK {pid}" in out
