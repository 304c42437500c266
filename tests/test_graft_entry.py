"""__graft_entry__ contract: entry() compiles and dryrun_multichip runs
on a virtual 8-device mesh (what the round driver checks)."""

import os
import subprocess
import sys


def test_graft_entry_contract():
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
    })
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "__graft_entry__.py")],
        capture_output=True, text=True, timeout=420, env=env, cwd=repo)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "entry compile: True" in out.stdout
    assert "dryrun_multichip(8) OK" in out.stdout
