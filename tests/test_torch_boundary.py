"""The port stands alone: bwa_tpu_torch and chip_smoke.py import neither JAX
nor anything of the JAX package, and chip_smoke.py refuses to report a
result without a CUDA card or outside the repository."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_GUARD = r"""
import importlib, importlib.abc, pkgutil, sys
sys.modules["jax"] = None


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "bwa_tpu" or name.startswith("bwa_tpu."):
            raise ImportError("the port may not import " + name)
        return None


sys.meta_path.insert(0, _Refuse())
sys.path.insert(0, {repo!r})
import bwa_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(bwa_tpu_torch.__path__,
                                              "bwa_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = [m for m in sys.modules if m == "jax" and sys.modules[m] is not None
       or m == "bwa_tpu" or m.startswith(("bwa_tpu.", "jax."))]
assert not bad, bad
print(len(mods))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax_and_no_jax_package():
    r = subprocess.run([sys.executable, "-c", _GUARD.format(repo=str(REPO))],
                       capture_output=True, text=True, cwd=REPO, env=_env(),
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 20  # every module was imported


def test_chip_smoke_fails_without_card(tmp_path):
    """No CUDA here: non-zero exit and no result line, from the repository
    root and from a directory holding only chip_smoke.py."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes((REPO / "chip_smoke.py").read_bytes())
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, lone)):
        r = subprocess.run([sys.executable, str(script)], capture_output=True,
                           text=True, cwd=cwd, env=_env(), timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_native_client_execs_only_the_port():
    """native/client.c execs the port's CLI and dlopens the port's
    library, never bwa_tpu's; server.py's socket directory is the port's
    own, so a bwa_tpu daemon for the same index never answers."""
    src = (REPO / "bwa_tpu_torch" / "native" / "client.c").read_text()
    assert '"bwa_tpu_torch.cli"' in src and '"bwa_tpu.cli"' not in src
    assert "bwa_tpu_torch_native.so" in src
    assert "bwa_tpu_native.so" not in src
    assert "/bwa_tpu_torch_daemon" in src
    from bwa_tpu_torch import server

    env = dict(os.environ)
    try:
        os.environ.pop("BWA_TPU_DAEMON_DIR", None)
        os.environ["TMPDIR"] = "/tmp"
        assert str(server.sock_dir()) == "/tmp/bwa_tpu_torch_daemon"
    finally:
        os.environ.clear()
        os.environ.update(env)
