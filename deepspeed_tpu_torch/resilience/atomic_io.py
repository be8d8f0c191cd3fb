"""Crash-safe file I/O: write-to-temp + fsync + atomic rename, and a
crc32 checksum manifest for checkpoint directories.

Durability contract (docs/RESILIENCE.md):

* A reader NEVER observes a partially-written file at the published path:
  payloads land in ``<path>.tmp.<pid>``, are fsync'd, and only then
  ``os.replace``'d over the target (atomic on POSIX), followed by a
  best-effort directory fsync so the rename itself survives power loss.
* A crash mid-write leaves the OLD content (or absence) intact plus
  harmless ``*.tmp.*`` debris, which every reader and the manifest walk
  ignore.
* ``write_manifest``/``verify_manifest`` pin every file in a checkpoint
  tag directory to its crc32+size (``manifest.json``); npz archives
  additionally get per-array crc32s so a corrupt restore can name the
  exact tensor.  ``verify_manifest`` is the validity oracle behind the
  checkpoint loader's fall-back-to-newest-valid-tag behaviour.

Every writer takes an optional fault-injection ``site`` so the chaos
harness can tear or corrupt exactly this write (see fault_injection.py
for the torn_write/corrupt semantics).  The port's copy of the JAX
package's ``resilience/atomic_io.py`` (numpy and the stdlib only).
"""

import io
import json
import os
import zlib
from typing import Callable, Dict, List, Optional

import numpy as np

from ..utils.logging import logger
from .fault_injection import InjectedCrash, writer_fault

MANIFEST_NAME = "manifest.json"
_TMP_MARKER = ".tmp."


def _fsync_dir(dirpath: str) -> None:
    """Best-effort directory fsync (persists the rename); some filesystems
    (and platforms) refuse O_RDONLY dir fds — never fatal."""
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _corrupt_file(path: str, fraction: float, truncate: bool) -> None:
    """Enact a 'corrupt' fault on the PUBLISHED file: silent truncation or
    a single byte flip — the detection job belongs to the manifest."""
    size = os.path.getsize(path)
    if truncate or size == 0:
        with open(path, "rb+") as f:  # atomic-ok: fault-injection corruptor
            f.truncate(max(0, int(size * fraction)))
        return
    pos = min(size - 1, int(size * fraction))
    with open(path, "rb+") as f:  # atomic-ok: fault-injection corruptor
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))


def atomic_write_bytes(path: str, data: bytes, site: Optional[str] = None) -> str:
    """Atomically publish ``data`` at ``path`` (temp + fsync + rename +
    dir fsync).  ``site`` names the fault-injection point wrapped around
    this write."""
    path = os.path.abspath(path)
    spec = writer_fault(site)  # raising kinds (os_error/crash/...) fire here
    tmp = f"{path}{_TMP_MARKER}{os.getpid()}"
    try:
        with open(tmp, "wb") as f:  # atomic-ok: the atomic-write helper itself
            if spec is not None and spec.kind == "torn_write":
                f.write(data[:int(len(data) * spec.fraction)])
                f.flush()
                os.fsync(f.fileno())
                # simulated process death mid-write: the temp debris stays,
                # the published path is never touched
                raise InjectedCrash(f"torn write at site '{site}' ({path})")
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
    except Exception:
        if not (spec is not None and spec.kind == "torn_write") and os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
        raise
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))
    if spec is not None and spec.kind == "corrupt":
        _corrupt_file(path, spec.fraction, spec.truncate)
    return path


def atomic_write_text(path: str, text: str, site: Optional[str] = None) -> str:
    return atomic_write_bytes(path, text.encode("utf-8"), site=site)


def atomic_write_json(path: str, obj, site: Optional[str] = None, **json_kw) -> str:
    return atomic_write_bytes(path, json.dumps(obj, **json_kw).encode("utf-8"), site=site)


def atomic_savez(path: str, arrays: Dict[str, np.ndarray], site: Optional[str] = None) -> str:
    """np.savez with the atomic-write discipline (the whole archive is
    serialized to memory first — group files are bounded by construction)."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)  # atomic-ok: serializes to memory, published atomically below
    return atomic_write_bytes(path, buf.getvalue(), site=site)


# ------------------------------------------------------------------ crc32

def crc32_bytes(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def crc32_file(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF


def crc32_array(arr: np.ndarray) -> int:
    return crc32_bytes(np.ascontiguousarray(arr).tobytes())


def npz_array_crcs(path: str) -> Dict[str, dict]:
    """Per-array crc32/shape/dtype of an npz archive (raises on a torn or
    corrupt archive — callers treat that as invalid)."""
    out = {}
    with np.load(path) as z:
        for name in z.files:
            arr = z[name]
            out[name] = {"crc32": crc32_array(arr), "shape": list(arr.shape),
                         "dtype": str(arr.dtype)}
    return out


# --------------------------------------------------------------- manifest

def build_manifest(root: str, match: Optional[Callable[[str], bool]] = None) -> dict:
    """Walk ``root`` and checksum every file (excluding the manifest itself
    and temp debris).  ``match(relpath)`` restricts coverage.

    Deliberately reads BACK the published bytes (one extra read of the tag
    per save): the crc recorded is of what actually landed on disk, so a
    write that tore between buffer and media is caught at save time (npz
    archives pay a second read for per-array diagnostic crcs; a torn npz
    fails the save here rather than the restore).  The load side has a
    ``verify_checksums_on_load`` opt-out for very large trees; the save
    side keeps the read-back unconditionally — it IS the write check."""
    root = os.path.abspath(root)
    files = {}
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in sorted(filenames):
            if fn == MANIFEST_NAME or _TMP_MARKER in fn:
                continue
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, root)
            if match is not None and not match(rel):
                continue
            entry = {"bytes": os.path.getsize(full), "crc32": crc32_file(full)}
            if fn.endswith(".npz"):
                try:
                    entry["arrays"] = npz_array_crcs(full)
                except InjectedCrash:
                    raise  # a crash must not be laundered into an OSError
                except Exception as e:
                    # a manifest is built right after a fenced save; an
                    # unreadable archive here is a real save failure
                    raise OSError(f"npz archive {full} unreadable while "
                                  f"building manifest: {e}") from e
            files[rel] = entry
    return {"version": 1, "files": files}


def write_manifest(root: str, site: Optional[str] = "ckpt.manifest_write",
                   match: Optional[Callable[[str], bool]] = None) -> dict:
    manifest = build_manifest(root, match=match)
    atomic_write_json(os.path.join(root, MANIFEST_NAME), manifest, site=site, indent=2)
    return manifest


def has_manifest(root: str) -> bool:
    return os.path.exists(os.path.join(root, MANIFEST_NAME))


def verify_manifest(root: str, match: Optional[Callable[[str], bool]] = None,
                    require: bool = False) -> List[str]:
    """Return a list of integrity errors ([] == valid).  A missing manifest
    is only an error under ``require`` (legacy checkpoints predate it)."""
    root = os.path.abspath(root)
    mpath = os.path.join(root, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return [f"{root}: missing {MANIFEST_NAME}"] if require else []
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        entries = manifest["files"]
    except (OSError, ValueError, KeyError) as e:
        return [f"{mpath}: unreadable manifest ({e})"]
    errors = []
    for rel, entry in entries.items():
        if match is not None and not match(rel):
            continue
        full = os.path.join(root, rel)
        if not os.path.exists(full):
            errors.append(f"{rel}: listed in manifest but missing")
            continue
        size = os.path.getsize(full)
        if size != entry.get("bytes"):
            errors.append(f"{rel}: size {size} != manifest {entry.get('bytes')}")
            continue
        crc = crc32_file(full)
        if crc != entry.get("crc32"):
            errors.append(f"{rel}: crc32 {crc:#010x} != manifest "
                          f"{int(entry.get('crc32', 0)):#010x}")
    return errors
