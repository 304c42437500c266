"""Real multi-process ``jax.distributed`` validation (SURVEY.md §5
"multi-host without a cluster"; VERDICT r1 item 5).

tests/test_multihost.py proves N-host determinism with SIMULATED hosts
(sequential in-process runs).  This file launches two actual OS
processes that rendezvous through the jax.distributed coordination
service on localhost (CPU backend), each encoding its strided share of
blocks; rank 0 merges.  The merged triplet must be byte-identical to a
single-host run — including under lossy quality quantization.
"""

import os
import socket
import subprocess
import sys

import pytest

from scalce_tpu.config import Config
from scalce_tpu.pipeline import driver
from scalce_tpu.utils.synth import synth_fastq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "multihost_compress.py")
BLOCK = 1024
N_READS = 4 * BLOCK


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child_env():
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
    })
    return env


def _launch_hosts(tmp, input_path, out_prefix, extra=()):
    port = _free_port()
    procs = []
    for rank in range(2):
        cmd = [sys.executable, SCRIPT, input_path, "-o", out_prefix,
               "--coordinator", f"localhost:{port}",
               "--num-processes", "2", "--process-id", str(rank),
               "--block-reads", str(BLOCK), *extra]
        logf = open(os.path.join(tmp, f"host{rank}.log"), "wb")
        procs.append((subprocess.Popen(cmd, env=_child_env(), cwd=REPO,
                                       stdout=logf, stderr=logf), logf))
    fail = None
    for rank, (p, logf) in enumerate(procs):
        try:
            rc = p.wait(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = -9
        logf.close()
        if rc != 0 and fail is None:
            with open(os.path.join(tmp, f"host{rank}.log"), "rb") as f:
                fail = (rank, rc, f.read()[-3000:])
    if fail is not None:
        pytest.fail(f"host {fail[0]} exited {fail[1]}:\n"
                    f"{fail[2].decode(errors='replace')}")


def _triplet_bytes(prefix):
    out = {}
    for ext in (".scalcen", ".scalcer", ".scalceq"):
        path = f"{prefix}.00{ext}"
        assert os.path.exists(path), f"missing {path}"
        with open(path, "rb") as f:
            out[ext] = f.read()
    return out


def _single_host_reference(tmp, input_path, lossy=0):
    ref_prefix = os.path.join(tmp, "ref")
    cfg = Config(mode="compress", inputs=(input_path,), output=ref_prefix,
                 block_reads=BLOCK, lossy_pct=lossy)
    driver.compress(cfg)
    return _triplet_bytes(ref_prefix)


@pytest.mark.parametrize("lossy", [0, 30], ids=["lossless", "lossy30"])
def test_two_process_distributed_matches_single_host(tmp_path, lossy):
    tmp = str(tmp_path)
    input_path = os.path.join(tmp, "in.fastq")
    with open(input_path, "wb") as f:
        f.write(synth_fastq(N_READS, 100, seed=33, var_len=True,
                            n_rate=0.005))

    mh_prefix = os.path.join(tmp, "mh")
    extra = ("-p", str(lossy)) if lossy else ()
    _launch_hosts(tmp, input_path, mh_prefix, extra)

    ref = _single_host_reference(tmp, input_path, lossy)
    got = _triplet_bytes(mh_prefix)
    for ext in ref:
        assert got[ext] == ref[ext], (
            f"2-process merge differs from single host on {ext} "
            f"({len(got[ext])} vs {len(ref[ext])} bytes)")


PROBE = os.path.join(REPO, "scripts", "dist_probe.py")


def _launch_probe(tmp, probe, n_procs=2, devices_per_proc=1):
    port = _free_port()
    env = _child_env()
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                        f"{devices_per_proc}")
    procs = []
    for rank in range(n_procs):
        cmd = [sys.executable, PROBE, probe,
               "--coordinator", f"localhost:{port}",
               "--num-processes", str(n_procs), "--process-id", str(rank),
               "--workdir", tmp]
        logf = open(os.path.join(tmp, f"probe{rank}.log"), "wb")
        procs.append((subprocess.Popen(cmd, env=env, cwd=REPO,
                                       stdout=logf, stderr=logf), logf))
    for rank, (p, logf) in enumerate(procs):
        try:
            rc = p.wait(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = -9
        logf.close()
        if rc != 0:
            with open(os.path.join(tmp, f"probe{rank}.log"), "rb") as f:
                pytest.fail(f"probe rank {rank} exited {rc}:\n"
                            f"{f.read()[-3000:].decode(errors='replace')}")


def test_barrier_orders_cross_process_writes(tmp_path):
    """Every rank writes pre_RANK before the barrier; after it, every
    rank must observe EVERY pre-file (rank 1 writes 1.5 s late, so a
    non-blocking barrier would race rank 0 past the check)."""
    tmp = str(tmp_path)
    _launch_probe(tmp, "barrier")
    for rank in range(2):
        with open(os.path.join(tmp, f"post_{rank}")) as f:
            seen = f.read().split(",")
        assert seen == ["pre_0", "pre_1"], (rank, seen)


def test_global_histogram_is_true_allreduce(tmp_path):
    """global_quality_histogram must hand every rank the SUM of all
    ranks' local histograms (rank r contributes (r+1)*(i+1))."""
    import numpy as np
    tmp = str(tmp_path)
    _launch_probe(tmp, "hist")
    want = np.arange(1, 65, dtype=np.int64) * 3      # (1+2)*(i+1)
    for rank in range(2):
        got = np.load(os.path.join(tmp, f"hist_{rank}.npy"))
        assert np.array_equal(got, want), (rank, got[:5], want[:5])


def test_two_process_four_device_dp_matches_single_host(tmp_path):
    """2 processes x 4 local devices each, --data-parallel on top of the
    cross-host strided split: merged triplet byte-identical to the plain
    single-host single-device run (VERDICT r3 #5b)."""
    tmp = str(tmp_path)
    input_path = os.path.join(tmp, "in.fastq")
    with open(input_path, "wb") as f:
        f.write(synth_fastq(8 * BLOCK, 100, seed=44, var_len=True,
                            n_rate=0.005))

    port = _free_port()
    env = _child_env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    mh_prefix = os.path.join(tmp, "mh")
    procs = []
    for rank in range(2):
        cmd = [sys.executable, SCRIPT, input_path, "-o", mh_prefix,
               "--coordinator", f"localhost:{port}",
               "--num-processes", "2", "--process-id", str(rank),
               "--block-reads", str(BLOCK), "--data-parallel"]
        logf = open(os.path.join(tmp, f"host{rank}.log"), "wb")
        procs.append((subprocess.Popen(cmd, env=env, cwd=REPO,
                                       stdout=logf, stderr=logf), logf))
    for rank, (p, logf) in enumerate(procs):
        try:
            rc = p.wait(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = -9
        logf.close()
        if rc != 0:
            with open(os.path.join(tmp, f"host{rank}.log"), "rb") as f:
                pytest.fail(f"host {rank} exited {rc}:\n"
                            f"{f.read()[-3000:].decode(errors='replace')}")

    ref = _single_host_reference(tmp, input_path)
    got = _triplet_bytes(mh_prefix)
    for ext in ref:
        assert got[ext] == ref[ext], (
            f"2-proc x 4-device DP differs from single host on {ext}")
