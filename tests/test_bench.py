"""bench.py contract test: the driver parses exactly one JSON line with
the documented keys, so a bench regression must fail CI, not the round."""

import json
import os
import subprocess
import sys


def test_bench_emits_one_json_line():
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "BENCH_READS": "4096",
        "BENCH_BLOCK_READS": "1024",
        "BENCH_TIME_BUDGET": "600",
        "BENCH_DEVICE": "0",       # the device legs need the GPU
    })
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "bench.py")],
        capture_output=True, text=True, timeout=420, env=env, cwd=repo)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [l for l in out.stdout.splitlines() if l.strip()]
    assert len(lines) == 1, f"expected ONE json line, got: {lines}"
    rec = json.loads(lines[0])
    # the documented core keys plus the round-3 extensions (device leg
    # + wall spreads; VERDICT r2 #1 / weak #6)
    assert {"metric", "value", "unit", "vs_baseline",
            "encode_walls_s", "device_encode_gbps",
            "ratio",
            # round-5 extensions (VERDICT r4 #3/#4 + ADVICE r4)
            "encode_median_gbps", "workdir", "loadavg",
            "paired_encode_gbps", "device_decode_gbps"} <= set(rec)
    assert rec["metric"] == "encode_throughput"
    assert rec["unit"] == "GB/s"
    assert rec["value"] > 0
    assert rec["device_encode_gbps"] is None      # BENCH_DEVICE=0
    assert rec["device_decode_gbps"] is None      # BENCH_DEVICE=0
    assert len(rec["encode_walls_s"]) >= 1
    assert rec["workdir"] in ("tmpfs", "disk")
    assert rec["encode_median_gbps"] > 0
    assert rec["paired_encode_gbps"] > 0          # paired leg always on
