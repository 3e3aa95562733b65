"""The port stands alone: no file of `sr_for_cfd_tpu_torch/` and not
`chip_smoke.py` imports jax, flax or the JAX package, and importing the
port needs none of h5py, msgpack, matplotlib or flax."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "sr_for_cfd_tpu"}


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "sr_for_cfd_tpu_torch")):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_file_imports_no_jax(path):
    bad = FORBIDDEN & set(_imported_roots(path))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {sorted(bad)}"


def test_port_imports_without_optional_packages():
    """Import every module of the port with jax, flax, h5py, msgpack and
    matplotlib made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'flax', 'h5py', 'msgpack', 'matplotlib', 'sr_for_cfd_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import sr_for_cfd_tpu_torch as pkg\n"
        "for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
