"""The driver contract: entry() compiles and dryrun_multichip(n) executes.

Regression: dryrun_multichip once failed with "requested 8 devices, have 1"
because it never provisioned the virtual CPU mesh itself.  Here conftest
already provides 8 CPU devices, so the in-process branch runs; the
subprocess fallback is exercised separately for an n the parent cannot
satisfy.
"""

import subprocess
import sys

import numpy as np
import pytest

import __graft_entry__ as graft


def test_entry_executes():
    fn, args = graft.entry()
    out = np.asarray(fn(*args))
    assert out.shape == args[0].shape
    assert out.dtype == np.uint8


@pytest.mark.parametrize("n", [8, 4, 2, 1])
def test_dryrun_multichip_in_process(n, capsys):
    graft.dryrun_multichip(n)
    assert "dryrun_multichip OK" in capsys.readouterr().out


def test_dryrun_multichip_subprocess_fallback():
    """n=16 exceeds the 8 visible devices -> must re-exec and still pass
    (this is the exact driver scenario: requested n > available)."""
    graft.dryrun_multichip(16)


def test_driver_invocation_shape():
    """Byte-for-byte what the driver runs: fresh python, import, call."""
    code = (
        "import sys; sys.path.insert(0, %r); "
        "import __graft_entry__; __graft_entry__.dryrun_multichip(8)"
        % graft._REPO_DIR
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "dryrun_multichip OK" in proc.stdout
