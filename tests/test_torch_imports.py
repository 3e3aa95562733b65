"""The port stands alone: no file of `sr_for_cfd_tpu_torch/` and not
`chip_smoke.py` imports jax, flax, optax, msgpack or the JAX package,
h5py, matplotlib and tensorflow are imported only inside functions, and
importing the port (its command line included) needs none of h5py,
msgpack, matplotlib, tensorflow or flax."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "sr_for_cfd_tpu"}
# imported only inside the functions that need them (the card's machine
# has none of them)
LAZY = {"h5py", "matplotlib", "tensorflow"}


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


def _module_level_roots(path):
    """Roots imported outside any function body."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                yield from (a.name.split(".")[0] for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                yield child.module.split(".")[0]
            yield from walk(child)

    return set(walk(tree))


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_file_imports_h5py_only_inside_functions(path):
    bad = LAZY & _module_level_roots(path)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {sorted(bad)} at module level"


@pytest.fixture(scope="module")
def without_optional_packages():
    """One interpreter with jax, flax, h5py, msgpack, matplotlib, tensorflow
    and the JAX package unimportable: it imports every module of the port
    and builds the command line's parser ('imports ok'), then calls each
    function that reads or writes .h5 ('h5py ok' when each raised an
    ImportError naming h5py). The finished process."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'flax', 'h5py', 'msgpack', 'matplotlib', 'tensorflow',\n"
        "          'sr_for_cfd_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import sr_for_cfd_tpu_torch as pkg\n"
        "for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "import sr_for_cfd_tpu_torch.cli as cli\n"
        "cli.build_parser().parse_args(['hybrid'])\n"
        "print('imports ok', flush=True)\n"
        "import sr_for_cfd_tpu_torch.workflow.training as tr\n"
        "from sr_for_cfd_tpu_torch.config import MeshParameters\n"
        "from sr_for_cfd_tpu_torch.io import hdf5\n"
        "calls = [lambda: hdf5.load_paired_reynolds_multi(['x.h5'], 10, 20),\n"
        "         lambda: hdf5.save_fields_hdf5('x.h5', {}, MeshParameters(nx=2, ny=2), 1.0),\n"
        "         lambda: tr.evaluate_shipped_model(10, 400, 'swish_tpu_bfs', ['x.h5'],\n"
        "                                           device='cpu')]\n"
        "for call in calls:\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError as e:\n"
        "        assert 'h5py' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError('no ImportError')\n"
        "print('h5py ok')\n"
    )
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)


def test_hdf5_functions_without_h5py_raise_naming_it(without_optional_packages):
    """With h5py unimportable the sweep and the training pipeline import,
    and each function that reads or writes .h5 raises an ImportError that
    names h5py."""
    out = without_optional_packages
    assert out.returncode == 0 and out.stdout.split()[-2:] == ["h5py", "ok"], out.stderr


def test_port_imports_without_optional_packages(without_optional_packages):
    """Import every module of the port with jax, flax, h5py, msgpack,
    matplotlib and tensorflow made unimportable, and build the command
    line's parser."""
    out = without_optional_packages
    assert out.stdout.startswith("imports ok\n"), out.stderr
