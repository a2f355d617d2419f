"""The checkpoint commit protocol (counterpart of the commit helpers of
``areal_tpu/base/recover.py``): every checkpoint dir (the HF weight-sync
export today) is written to a ``<path>.tmp-<tag>`` staging dir, a
``COMMIT.json`` manifest (step, version, format) is fsynced into it, and
the staging dir is atomically renamed over ``<path>``. A crash at ANY
instant leaves either the old committed checkpoint or the new one, never a
half-written dir that a reader would load.

``RecoverInfo`` and its dump/load (trainer restart bookkeeping) come with
trainer checkpoints.
"""

import glob as glob_mod
import json
import logging
import os
import shutil
from typing import List, Optional

logger = logging.getLogger("areal_tpu_torch.recover")

CKPT_MANIFEST = "COMMIT.json"
_TMP_MARK = ".tmp-"
_OLD_MARK = ".old-"


def _fsync_path(p: str) -> None:
    """Best-effort fsync of a file or directory (a rename is only durable
    once the parent directory's entry is flushed)."""
    try:
        fd = os.open(p, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass  # e.g. a filesystem that cannot fsync directories



def staging_path(path: str, tag: str) -> str:
    """The staging dir for one save attempt. ``tag`` must be identical on
    every host of a multihost save (all processes write shards into the same
    dir), so callers derive it from the step counter, not a random nonce."""
    return f"{path}{_TMP_MARK}{tag}"


def prepare_staging(path: str, tag: str) -> str:
    """Clear leftovers of a previously crashed attempt with the same tag.
    Returns the staging path WITHOUT creating it (the writer creates its
    target itself)."""
    tmp = staging_path(path, tag)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    return tmp


def write_manifest(dirpath: str, manifest: dict) -> None:
    """Fsync ``COMMIT.json`` into ``dirpath`` — the presence of a parseable
    manifest IS the committed bit."""
    p = os.path.join(dirpath, CKPT_MANIFEST)
    tmp = p + ".part"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, p)
    _fsync_path(dirpath)


def read_manifest(dirpath: str) -> Optional[dict]:
    """The manifest of a committed checkpoint dir, or None when the dir is
    missing, uncommitted (no manifest: a crashed mid-save leftover), or the
    manifest itself is corrupt."""
    p = os.path.join(dirpath, CKPT_MANIFEST)
    try:
        with open(p) as f:
            m = json.load(f)
        return m if isinstance(m, dict) else None
    except (OSError, ValueError):
        return None


def is_committed(dirpath: str) -> bool:
    return read_manifest(dirpath) is not None


def commit_checkpoint(staging: str, path: str, manifest: dict) -> str:
    """Commit ``staging`` as ``path``: fsync the manifest into the staging
    dir, move any previous committed dir aside, atomically rename the
    staging dir into place, then delete the old one. Every intermediate
    state is recoverable by :func:`resolve_committed`."""
    write_manifest(staging, manifest)
    parent = os.path.dirname(os.path.abspath(path))
    old = None
    if os.path.exists(path):
        old = f"{path}{_OLD_MARK}displaced"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(path, old)
    os.rename(staging, path)
    _fsync_path(parent)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    logger.debug("committed checkpoint %s (manifest %s)", path, manifest)
    return path


def _candidates(path: str) -> List[str]:
    return (
        [path]
        + sorted(glob_mod.glob(glob_mod.escape(path) + _TMP_MARK + "*"))
        + sorted(glob_mod.glob(glob_mod.escape(path) + _OLD_MARK + "*"))
    )


def resolve_committed(path: str) -> Optional[str]:
    """Newest committed checkpoint for the canonical ``path``.

    Handles every crash window of :func:`commit_checkpoint`: an uncommitted
    staging dir is discarded; a COMMITTED staging/displaced sibling that is
    newer than ``path`` (crash between the manifest fsync and the renames)
    is promoted into place; stale committed siblings are cleaned. Returns
    ``path`` when a committed checkpoint ends up there, else None.
    """
    best, best_key = None, None
    for cand in _candidates(path):
        m = read_manifest(cand)
        if m is None:
            continue
        # prefer the canonical path on ties: it finished its swap
        key = (m.get("step", -1), m.get("version", -1), cand == path)
        if best_key is None or key > best_key:
            best, best_key = cand, key
    if best is None:
        return None
    if best != path:
        # the canonical dir was missing/uncommitted/stale and a committed
        # sibling (a crash between manifest fsync and the renames) is
        # promoted
        logger.warning(
            "promoting newest committed checkpoint %s -> %s "
            "(a previous save crashed mid-commit)", best, path,
        )
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(best, path)
        _fsync_path(os.path.dirname(os.path.abspath(path)))
    # strays (uncommitted staging dirs, superseded committed siblings) are
    # now garbage — a restarted save would otherwise trip over them
    for cand in _candidates(path):
        if cand != path:
            shutil.rmtree(cand, ignore_errors=True)
    return path


def discard_checkpoint(path: str) -> None:
    """THE sanctioned way to delete a dir that may hold a live checkpoint
    (e.g. weight-sync pruning). Centralized here so the async-hygiene pass
    can flag every other ``rmtree`` on checkpoint-capable paths."""
    shutil.rmtree(path, ignore_errors=True)
