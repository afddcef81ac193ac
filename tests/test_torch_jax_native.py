"""The JAX package's native library, built once for the port's tests.

bwa_tpu/native/build.py compiles into one fixed temporary name beside the
cached library (bwa_tpu_native_<hash>.so.tmp) and then renames it.  Test
workers that start together on an empty cache all compile into that one
name, and every worker but the first finds it gone when it renames
(FileNotFoundError), which fails the fixture of a whole test module.  The
port's tests that reach bwa_tpu's native code call jax_native() before
they use it: it builds the library under a file lock into a name of its
own and renames that into place, so bwa_tpu's get_lib finds it built."""

import fcntl
import os
import subprocess
import sys
import time
from pathlib import Path


def jax_native():
    """bwa_tpu's native library, built under a lock when it is missing."""
    from bwa_tpu.native import build

    so = build._CACHE_DIR / (
        f"bwa_tpu_native_{build._build_hash(build._hash_files())}.so")
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / "port_tests.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            mine = so.with_name(f"{so.stem}.{os.getpid()}.so")
            build._compile(build._source_files(), mine)
            os.replace(mine, so)
    # a bwa_tpu worker that was already compiling may still rename its
    # file over ours; it is whole once that compile has ended
    for attempt in range(60):
        try:
            return build.get_lib()
        except OSError:
            if attempt == 59:
                raise
            time.sleep(1)


def test_jax_native_built_once_by_concurrent_workers(tmp_path):
    """Three processes that need the library at once on an empty cache:
    all load it, one library is built, no temporary file is left (beside
    the lock and get_lib's stable-name link)."""
    tests = Path(__file__).resolve().parent
    env = dict(os.environ, BWA_TPU_CACHE=str(tmp_path),
               PYTHONPATH=os.pathsep.join([str(tests), str(tests.parent)]))
    code = "from test_torch_jax_native import jax_native; jax_native()"
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    files = sorted(f.name for f in tmp_path.iterdir() if not f.is_symlink()
                   and f.name != "port_tests.lock")
    assert len(files) == 1 and files[0].endswith(".so"), files
