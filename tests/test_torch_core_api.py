"""The port's public surface: ``repro_torch.core`` exports the JAX
package's ``repro.core.__all__`` (``state_shardings`` too, since the
sharding slice), each name importable; and the reliability plane's modules
import neither JAX nor the JAX package."""
import os
import subprocess
import sys
from pathlib import Path

import repro.core as jcore
import repro_torch.core as tcore

SRC = Path(__file__).resolve().parents[1] / "src"


def test_all_is_the_references_minus_state_shardings():
    assert sorted(tcore.__all__) == sorted(jcore.__all__)
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None, name


def test_reliability_plane_imports_no_jax():
    code = ("import sys\n"
            "import repro_torch.core, repro_torch.core.faults, "
            "repro_torch.core.weightsync, repro_torch.launch.inspect_ckpt, "
            "repro_torch.launch.serve\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "PYTHONPATH": str(SRC)})
