"""Nothing the harness or its references import has the top-level name of
JAX or of the JAX package: names are compared whole (the port's name,
``repro_torch``, begins with ``repro``)."""
import ast
import json
import subprocess
import sys

from crbench.tests.conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_no_source_file_names_them():
    for path in (REPO / "crbench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_a_run_loads_none_of_them(tmp_path):
    """A whole tiny run on the CPU in a fresh process, then its
    ``sys.modules``."""
    code = f"""
import json, sys
sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]
from pathlib import Path
from crbench.tests.conftest import make_tiny_root
from crbench.run import run_cell
root = make_tiny_root(Path({str(tmp_path)!r}) / "root")
out = run_cell(root, "hubert-recover", 11, 1.0, False, device="cpu")
print(json.dumps([out["correct"],
                  sorted({{m.split(".")[0] for m in sys.modules}})]))
"""
    env = {"PATH": "/usr/bin:/bin", "TMPDIR": str(tmp_path),
           "HOME": str(tmp_path)}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    correct, top = json.loads(p.stdout.strip().splitlines()[-1])
    assert correct is True
    assert "repro_torch" in top
    assert not set(top) & FORBIDDEN
