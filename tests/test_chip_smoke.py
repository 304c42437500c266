"""chip_smoke.py must refuse to report success without a GPU."""

import os
import subprocess
import sys


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=repo)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
