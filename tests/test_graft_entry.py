"""Entry-point contract: entry() jits; dryrun_multichip runs on the mesh it
is given and refuses a mesh it cannot have."""

import sys

import jax
import numpy as np
import pytest


sys.path.insert(0, ".")
import __graft_entry__ as graft  # noqa: E402


def test_entry_forward_jits():
    fn, args = graft.entry()
    out = np.asarray(jax.jit(fn)(*args))
    assert out.shape == (8,)
    assert np.all((out >= 0.0) & (out <= 1.0))


def test_dryrun_runs_on_native_mesh(capsys):
    # conftest forces 8 virtual devices, so n=8 runs in-process.
    graft.dryrun_multichip(8)
    assert "OK" in capsys.readouterr().out


def test_dryrun_raises_when_devices_short():
    # n=16 > the 8 available devices: no silent fallback onto another mesh
    with pytest.raises(RuntimeError, match="needs 16 devices"):
        graft.dryrun_multichip(16)
