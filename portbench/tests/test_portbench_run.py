"""`run.py` on a machine without a card: a message, a non-zero exit and
no result line."""

import os
import subprocess
import sys

import pytest

from portbench import spec


@pytest.mark.parametrize("trace", ["0", "1"])
def test_no_card_no_result(trace):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(spec.HERE, "run.py"), "--workload",
         "interp256_ddim50_b64", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", trace], capture_output=True, text=True, env=env,
        cwd=spec.ROOT, timeout=300)
    assert proc.returncode != 0
    assert "metrics" not in proc.stdout and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
