"""Failure-recovery bookkeeping and the checkpoint commit protocol (the
counterpart of ``areal_tpu/base/recover.py``).

``RecoverInfo`` holds what a restarted trainer needs besides its engine
state: step counters, frequency-control states, the samples consumed and
the model version; it is dumped atomically as JSON at every checkpoint
tick.

Every checkpoint dir (the HF weight-sync export, the trainer's recover
checkpoint) is written to a ``<path>.tmp-<tag>`` staging dir, a
``COMMIT.json`` manifest (step, version, format, per-tree checksums) is
fsynced into it, and the staging dir is atomically renamed over
``<path>``. A crash at ANY instant leaves either the old committed
checkpoint or the new one, never a half-written dir that a reader would
load.
"""

import dataclasses
import glob as glob_mod
import hashlib
import json
import logging
import os
import shutil
from typing import Dict, Iterator, List, Optional, Tuple

from areal_tpu_torch.base import constants
from areal_tpu_torch.base import metrics as metrics_mod

logger = logging.getLogger("areal_tpu_torch.recover")

RECOVER_INFO_FILE = "recover_info.json"
CKPT_MANIFEST = "COMMIT.json"
_TMP_MARK = ".tmp-"
_OLD_MARK = ".old-"


@dataclasses.dataclass
class StepInfo:
    epoch: int = 0
    epoch_step: int = 0
    global_step: int = 0

    def next(self, steps_per_epoch: Optional[int] = None) -> "StepInfo":
        epoch, epoch_step = self.epoch, self.epoch_step + 1
        if steps_per_epoch is not None and epoch_step >= steps_per_epoch:
            epoch, epoch_step = epoch + 1, 0
        return StepInfo(epoch, epoch_step, self.global_step + 1)


@dataclasses.dataclass
class RecoverInfo:
    recover_start: StepInfo = dataclasses.field(default_factory=StepInfo)
    last_step_info: StepInfo = dataclasses.field(default_factory=StepInfo)
    save_ctl_states: Dict[str, dict] = dataclasses.field(default_factory=dict)
    ckpt_ctl_states: Dict[str, dict] = dataclasses.field(default_factory=dict)
    eval_ctl_states: Dict[str, dict] = dataclasses.field(default_factory=dict)
    data_loading_dp_idx: int = 0
    hash_vals_to_ignore: List[int] = dataclasses.field(default_factory=list)
    # async-RL restart-the-world state: the resumed trainer republishes both
    # so the manager's staleness gate and the fleet's weight version
    # converge on the restored run instead of the crashed one
    samples_consumed: int = 0
    model_version: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RecoverInfo":
        d = dict(d)
        for k in ("recover_start", "last_step_info"):
            d[k] = StepInfo(**d[k])
        return cls(**d)


def dump(info: RecoverInfo, root: Optional[str] = None):
    root = root or constants.get_recover_root()
    path = os.path.join(root, RECOVER_INFO_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(info.to_dict(), f, indent=2)
    os.replace(tmp, path)
    logger.debug("dumped recover info to %s", path)


def load(root: Optional[str] = None) -> Optional[RecoverInfo]:
    root = root or constants.get_recover_root()
    path = os.path.join(root, RECOVER_INFO_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return RecoverInfo.from_dict(json.load(f))


def tree_leaves_with_path(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """``(dotted path, leaf)`` for every leaf of a dict / list tree, in a
    fixed order (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def tree_checksum(tree) -> str:
    """Structural checksum of a state tree: sha256 over every leaf's path,
    shape and dtype. It hashes no values, yet catches what matters at
    restore time: a manifest paired with the wrong tree, a truncated save,
    a model or optimizer config that drifted between save and load."""
    h = hashlib.sha256()
    for path, leaf in tree_leaves_with_path(tree):
        shape = tuple(getattr(leaf, "shape", ()))
        dtype = str(getattr(leaf, "dtype", type(leaf).__name__))
        h.update(f"{path}|{shape}|{dtype}\n".encode())
    return h.hexdigest()


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
        # promoted: the event guard/ckpt_fallbacks counts
        metrics_mod.counters.add(metrics_mod.GUARD_CKPT_FALLBACKS)
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
