"""The port's graft entry: dryrun_multichip in a bare process.

dryrun_multichip asks for the CPU itself (EBT_TORCH_DEVICE=cpu for its own
process and its services, the mock CUDA driver for the pjrt leg), so it is
run here in a fresh interpreter with none of those set, without conftest,
under its own time limit.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n_devices", [2, 4])
def test_dryrun_multichip_bare_subprocess(n_devices):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("EBT_", "JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c",
         "from elbencho_tpu_torch.graft_entry import dryrun_multichip; "
         f"dryrun_multichip({n_devices}); "
         "import sys; assert 'jax' not in sys.modules; print('dryrun ok')"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "dryrun ok" in proc.stdout
    # the staged leg's per-device rows and the pjrt leg's clock, host-framed
    for dev in range(n_devices):
        assert f":{dev} xfer lat us" in proc.stdout
    assert "clock=onready" in proc.stdout
