"""Multi-process jax.distributed test: two OS processes x
4 CPU devices over jax.distributed.initialize — a real process boundary
under the 8-device mesh (the DCN analogue). The worker runs the DP/SP
batched align step with the sp axis laid out across the processes and the
full sharded IRLS solve, each checked against single-controller references.
See tests/multiprocess_worker.py.
"""

import os
import socket
import subprocess
import sys

import pytest

_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_worker = os.path.join(_repo, "tests", "multiprocess_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.timeout(600)
def test_two_process_mesh_collectives():
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = _repo
    procs = [
        subprocess.Popen(
            [sys.executable, _worker, str(port), str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=_repo,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multi-process workers timed out\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"MULTIPROC OK {pid}" in out, f"worker {pid} output:\n{out}"
