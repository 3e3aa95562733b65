"""The port's native `.dat` writer (`io/native_io.py`, `io/native/fastdat.cpp`)
against the JAX package's, on the CPU.

On a seeded (3, 34, 34) float64 stack with NaN (both signs), +-inf and
-0.0, the port's `save_full_field` writes the same bytes as the JAX
package's: through the native writers on both sides (glibc prints a
negative NaN as `-nan`), and through the Python fallbacks on both sides
(Python prints `nan`). A build that fails, and a native call that fails
after appending part of a body, leave the file the Python writer's, whole.
The library is built into the package's `_build/`, never beside its source.
"""

import numpy as np
import pytest

from sr_for_cfd_tpu_torch.config import MeshParameters
from sr_for_cfd_tpu_torch.io import datfiles as tdat
from sr_for_cfd_tpu_torch.io import native_io as tnative


def _stack(seed):
    g = np.random.default_rng(seed)
    var = g.standard_normal((3, 34, 34)) * 10.0 ** g.integers(-8, 4, (3, 34, 34))
    var[0, 1, 1], var[0, 1, 2] = np.nan, -np.nan
    var[1, 2, 2], var[1, 3, 3] = np.inf, -np.inf
    var[2, 4, 4], var[2, 5, 5] = -0.0, -4e-7
    return var


def _jax_save(path, var):
    from sr_for_cfd_tpu.config import MeshParameters as JaxMesh
    from sr_for_cfd_tpu.io import datfiles as jdat

    jdat.save_full_field(str(path), var, JaxMesh(nx=32, ny=32), 400.0, 2e-3)
    return path.read_bytes()


def _port_save(path, var):
    tdat.save_full_field(str(path), var, MeshParameters(nx=32, ny=32), 400.0, 2e-3)
    return path.read_bytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_native_writer_is_jax_s_byte_for_byte(tmp_path, seed):
    from sr_for_cfd_tpu.io import native_io as jnative

    var = _stack(seed)
    before = dict(tnative.used)
    got = _port_save(tmp_path / "port.dat", var)
    assert tnative.used["native"] == before["native"] + 1
    assert tnative.used["python"] == before["python"]
    assert jnative._load() is not None
    assert got == _jax_save(tmp_path / "jax.dat", var)
    assert b"-nan \t" in got and b"-inf \t" in got and b"-0.000000 \t" in got


def test_fallback_is_jax_s_byte_for_byte(tmp_path, monkeypatch):
    """Both packages without their native writer: the Python bodies agree,
    and differ from the native one only where glibc writes `-nan`."""
    from sr_for_cfd_tpu.io import native_io as jnative

    var = _stack(2)
    native = _port_save(tmp_path / "native.dat", var)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_failed", True)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_failed", "unavailable in this test")
    before = tnative.used["python"]
    got = _port_save(tmp_path / "port.dat", var)
    assert tnative.used["python"] == before + 1
    assert got == _jax_save(tmp_path / "jax.dat", var)
    assert b"-nan" not in got
    assert got == native.replace(b"-nan \t", b"nan \t")


def test_python_writer_alone_is_the_fallback(tmp_path):
    var = _stack(3)
    var[0, 1, 2] = np.nan  # one NaN sign, where both writers print alike
    tdat.save_full_field_python(str(tmp_path / "py.dat"), var, MeshParameters(nx=32, ny=32),
                                400.0, 2e-3)
    assert (tmp_path / "py.dat").read_bytes() == _port_save(tmp_path / "port.dat", var)


@pytest.mark.parametrize("failure", ["build", "append"])
def test_failed_native_write_rewrites_the_whole_file(tmp_path, monkeypatch, failure):
    """A compiler that is missing, or a native call that fails after
    appending part of a body: the file is the Python writer's, from its
    first byte."""
    var = _stack(4)
    want = tdat.save_full_field_python
    want(str(tmp_path / "want.dat"), var, MeshParameters(nx=32, ny=32), 400.0, 2e-3)
    out = tmp_path / "port.dat"
    out.write_bytes(b"stale bytes of an earlier file\n" * 100)
    if failure == "build":
        monkeypatch.setattr(tnative, "_lib", None)
        monkeypatch.setattr(tnative, "_failed", None)
        monkeypatch.setattr(tnative, "LIB", tmp_path / "build" / "_fastdat.so")
        monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(tnative, "COMPILER", str(tmp_path / "no-such-compiler"))
        assert "no-such-compiler" in tnative.unavailable()
        assert not (tmp_path / "build" / "_fastdat.so").exists()
    else:
        def partial(filename, v):
            with open(filename, "a") as f:
                f.write("\n# ########## U velocity ############ \n0.1")
            return False

        monkeypatch.setattr(tnative, "append_field_sections", partial)
    _port_save(out, var)
    assert out.read_bytes() == (tmp_path / "want.dat").read_bytes()


def test_library_is_built_in_the_build_directory():
    assert tnative.unavailable() is None
    assert tnative.LIB.parent == tnative.SRC.parent.parent.parent / "_build"
    assert tnative.LIB.exists() and tnative.LIB.stat().st_mtime >= tnative.SRC.stat().st_mtime
    assert not list(tnative.SRC.parent.glob("*.so"))
