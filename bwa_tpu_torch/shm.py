"""Shared-memory index residency — the bwashm.c analog.

The reference stages the flattened index into POSIX shm (`/bwaidx-<name>`,
registry in `/bwactl`; bwashm.c:16-122) so that every later `bwa mem`
invocation on the same host attaches instantly instead of re-reading the
index from disk.  The port keeps the reference's *semantics* — stage once
per host, attach by basename, list/destroy — but stages its own parsed
array layout (ckpt/words/ssa/pac, the dense-SA sidecar when present, and
a JSON header) as files under /dev/shm (tmpfs, or BWA_TPU_SHM_DIR),
attached read-only via np.memmap.  The layout and the registry
(`bwa_tpu_ctl.json`, `bwa_tpu_idx-<name>/`) are those of the JAX package,
so a staging made by either attaches in the other.  The attached arrays
are read-only: every upload to the card copies them.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np

CTL = "bwa_tpu_ctl.json"
PREFIX = "bwa_tpu_idx-"

_ARRAYS = ("ckpt", "words", "ssa", "pac")


def _shm_root() -> Path:
    return Path(os.environ.get("BWA_TPU_SHM_DIR", "/dev/shm"))


def _name_of(hint: str) -> str:
    """The registry key is the basename, as in bwa_shm_test
    (bwashm.c:130-133)."""
    return os.path.basename(str(hint))


def _ctl_path() -> Path:
    return _shm_root() / CTL


def _read_ctl() -> dict:
    try:
        return json.loads(_ctl_path().read_text())
    except (OSError, ValueError):
        return {}


def _write_ctl(ctl: dict) -> None:
    tmp = _ctl_path().with_suffix(".tmp")
    tmp.write_text(json.dumps(ctl))
    os.replace(tmp, _ctl_path())


def shm_test(hint: str) -> bool:
    """Is the index named by `hint` staged? (bwa_shm_test)."""
    name = _name_of(hint)
    entry = _read_ctl().get(name)
    return entry is not None and (_shm_root() / entry["dir"] / "meta.json").exists()


def shm_stage(prefix: str) -> int:
    """Load the index from disk and stage it (bwa_shm_stage semantics)."""
    from bwa_tpu_torch.index.fmindex import FMIndex

    fm = FMIndex.load_from_disk(prefix)
    name = _name_of(prefix)
    d = _shm_root() / (PREFIX + name)
    d.mkdir(parents=True, exist_ok=True)
    total = 0
    meta: dict = {
        "primary": int(fm.primary),
        "seq_len": int(fm.seq_len),
        "sa_intv": int(fm.sa_intv),
        "L2": [int(v) for v in fm.L2],
        "arrays": {},
        "bnt": {
            "l_pac": int(fm.bnt.l_pac),
            "seed": int(fm.bnt.seed),
            "contigs": [
                dict(name=c.name, anno=c.anno, offset=int(c.offset),
                     length=int(c.length), n_ambs=int(c.n_ambs),
                     gi=int(c.gi), is_alt=bool(c.is_alt))
                for c in fm.bnt.contigs
            ],
            "holes": [dict(offset=int(h.offset), length=int(h.length),
                           amb=h.amb) for h in fm.bnt.holes],
        },
    }
    for nm in _ARRAYS:
        arr = np.ascontiguousarray(getattr(fm, nm))
        (d / (nm + ".bin")).write_bytes(arr.tobytes())
        meta["arrays"][nm] = dict(dtype=str(arr.dtype), shape=list(arr.shape))
        total += arr.nbytes
    if fm.sad is not None:  # dense-SA sidecar rides along when present
        arr = np.ascontiguousarray(fm.sad)
        (d / "sad.bin").write_bytes(arr.tobytes())
        meta["arrays"]["sad"] = dict(dtype=str(arr.dtype),
                                     shape=list(arr.shape))
        total += arr.nbytes
    (d / "meta.json").write_text(json.dumps(meta))
    ctl = _read_ctl()
    ctl[name] = dict(dir=PREFIX + name, l_mem=total)
    _write_ctl(ctl)
    return 0


def shm_attach(hint: str):
    """FMIndex over read-only memmaps of the staged arrays; None if the
    index is not staged (bwa_idx_load_from_shm)."""
    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.index.pack import Bnt, Contig, Hole

    name = _name_of(hint)
    entry = _read_ctl().get(name)
    if entry is None:
        return None
    d = _shm_root() / entry["dir"]
    try:
        meta = json.loads((d / "meta.json").read_text())
    except (OSError, ValueError):
        return None
    arrs = {}
    for nm in _ARRAYS:
        info = meta["arrays"][nm]
        arrs[nm] = np.memmap(d / (nm + ".bin"), dtype=np.dtype(info["dtype"]),
                             mode="r", shape=tuple(info["shape"]))
    sad = None
    if "sad" in meta["arrays"]:
        info = meta["arrays"]["sad"]
        sad = np.memmap(d / "sad.bin", dtype=np.dtype(info["dtype"]),
                        mode="r", shape=tuple(info["shape"]))
    mb = meta["bnt"]
    bnt = Bnt(
        l_pac=mb["l_pac"], seed=mb["seed"],
        contigs=[Contig(name=c["name"], anno=c["anno"], offset=c["offset"],
                        length=c["length"], n_ambs=c["n_ambs"], gi=c["gi"],
                        is_alt=c["is_alt"]) for c in mb["contigs"]],
        holes=[Hole(offset=h["offset"], length=h["length"], amb=h["amb"])
               for h in mb["holes"]],
    )
    fmi = FMIndex(primary=meta["primary"],
                  L2=np.asarray(meta["L2"], dtype=np.int64),
                  seq_len=meta["seq_len"], ckpt=arrs["ckpt"],
                  words=arrs["words"], sa_intv=meta["sa_intv"],
                  ssa=arrs["ssa"], bnt=bnt, pac=arrs["pac"])
    if sad is not None:
        fmi.__dict__["sad"] = sad
    return fmi


def shm_list() -> int:
    """Print name + staged bytes per index (bwa_shm_list)."""
    ctl = _read_ctl()
    if not ctl:
        return -1
    for name, entry in ctl.items():
        print(f"{name}\t{entry['l_mem']}")
    return 0


def shm_destroy() -> int:
    """Unlink every staged index and the registry (bwa_shm_destroy)."""
    ctl = _read_ctl()
    if not ctl and not _ctl_path().exists():
        return -1
    for entry in ctl.values():
        shutil.rmtree(_shm_root() / entry["dir"], ignore_errors=True)
    try:
        os.unlink(_ctl_path())
    except OSError:
        pass
    return 0


def main_shm(argv: list[str]) -> int:
    """`shm` subcommand (main_shm, bwashm.c:184-217)."""
    import getopt as getopt_mod

    to_list = to_drop = 0
    try:
        opts, args = getopt_mod.getopt(argv, "ldf:")
    except getopt_mod.GetoptError as e:
        print(f"[main_shm] {e}", file=sys.stderr)
        return 1
    for c, _v in opts:
        if c == "-l":
            to_list = 1
        elif c == "-d":
            to_drop = 1
        # -f tmpFile: peak-memory staging aid; our arrays stage directly
    if not args and not to_list and not to_drop:
        print("\nUsage: python -m bwa_tpu_torch.cli shm [-d|-l] [-f tmpFile] "
              "[idxbase]\n\n"
              "Options: -d       destroy all indices in shared memory\n"
              "         -l       list names of indices in shared memory\n"
              "         -f FILE  temporary file to reduce peak memory\n",
              file=sys.stderr)
        return 1
    if args and (to_list or to_drop):
        print("[E::main_shm] open -l or -d cannot be used when 'idxbase' "
              "is present", file=sys.stderr)
        return 1
    ret = 0
    if args:
        if not shm_test(args[0]):
            if shm_stage(args[0]) < 0:
                print("[E::main_shm] failed to stage the index in shared "
                      "memory", file=sys.stderr)
                ret = 1
        else:
            print(f"[M::main_shm] index '{args[0]}' is already in shared "
                  "memory", file=sys.stderr)
    if to_list:
        shm_list()
    if to_drop:
        shm_destroy()
    return ret
