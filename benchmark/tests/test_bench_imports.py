"""What the benchmark may import: nothing under benchmark/ imports JAX or
the JAX package (top-level module names compared whole; the port's name
begins with the JAX package's), and the plain reference imports nothing
of the port either."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
JAX = {"jax", "jaxlib", "flax", "sigfish_tpu"}


def _imports(path: str) -> set[str]:
    """Top-level names of every module the file imports (absolute ones)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def _sources(top: str) -> list[str]:
    return [os.path.join(d, f) for d, _, fs in os.walk(top) for f in fs if f.endswith(".py")]


def test_no_file_imports_jax_or_the_jax_package():
    bad = {p: _imports(p) & JAX for p in _sources(BENCH)}
    assert not {p: s for p, s in bad.items() if s}


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(BENCH, "reference")
    bad = {p: s for p in _sources(ref) if (s := _imports(p) & (JAX | {"sigfish_tpu_torch"}))}
    assert not bad
    # and at run time: the reference maps with the port blocked
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('sigfish_tpu', 'sigfish_tpu_torch', 'jax', 'jaxlib'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from benchmark import check, traffic\n"
        "from benchmark.reference import mapper\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_the_scan_catches_what_it_should(tmp_path):
    p = tmp_path / "bad.py"
    p.write_text("import jax.numpy as jnp\nfrom sigfish_tpu.ops import sdtw\nimport sigfish_tpu_torch\n")
    assert _imports(str(p)) & JAX == {"jax", "sigfish_tpu"}
