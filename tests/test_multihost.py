"""Multi-host (DCN-path) solve: a REAL 2-process CPU cluster.

The CI analogue of N accelerator hosts (SURVEY.md §5.8): two processes, two
virtual devices each, joined via ``jax.distributed`` with gloo CPU
collectives; the level-striped solve's per-level psum crosses the
process boundary — the structural equivalent of DCN traffic.
"""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def test_two_process_sharded_solve():
    port = 12000 + (os.getpid() % 2000)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_multihost_worker.py"),
             str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert "MULTIHOST_OK" in out, f"proc {pid} output:\n{out[-3000:]}"
