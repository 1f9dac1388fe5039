"""Preemption-safe checkpoint and resume with ``torch.save``.

The port's counterpart of ``tosem_tpu/train/checkpoint.py``, with the
same contract and file names; ``torch.save``/``torch.load`` take the
place of orbax. A checkpoint is a directory holding the tree
(``state.pt``), an optional ``_tosem_extra.json`` (metric history, data
positions, anything the tree cannot carry) and a checksum manifest
``_tosem_manifest.json`` (``{"version": 1, "files": {name: sha256}}``).

Every save goes to a ``<path>.tmp.<pid>`` staging directory, gains the
manifest, and is atomically renamed into place, after which the parent
directory is fsynced: a kill at any point leaves either the previous
checkpoint or a complete new one, never a torn directory that restore
dies on. :func:`restore_checkpoint` verifies the manifest and raises
:class:`CheckpointCorruptError` on a mismatch; :func:`restore_or_init`
and :func:`latest_checkpoint` skip corrupt or partial candidates.
:func:`save_versioned` adds step-numbered checkpoints (``ckpt_<step>``)
with last-K retention for :func:`tosem_tpu_torch.train.trainer.fit`.

A tree is a nested dict of tensors and plain values, or an object
with ``state_dict()``/``load_state_dict()`` (a module, an optimizer, a
:class:`~tosem_tpu_torch.train.trainer.TrainState`). It is loaded with
``weights_only=True`` onto the CPU, then into the template.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

MANIFEST = "_tosem_manifest.json"
EXTRA = "_tosem_extra.json"
TREE = "state.pt"
_VERSION_PREFIX = "ckpt_"


class CheckpointCorruptError(RuntimeError):
    """Checkpoint content does not match its checksum manifest (torn
    write, bit rot, or a partial copy)."""


def _path(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


# Test seam for crash-consistency checks: when set, called with a tag
# naming the point save_checkpoint just passed ("staged" = staging dir
# complete, "renamed" = rename done but the parent directory not yet
# fsynced).
_crash_hook: Optional[Callable[[str], None]] = None


def _maybe_crash(tag: str) -> None:
    if _crash_hook is not None:
        _crash_hook(tag)


def _fsync_dir(path: str) -> None:
    """fsync a directory, so that the rename that put an entry in it
    persists. Best-effort: some filesystems refuse directory fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _walk_files(root: str) -> List[str]:
    out = []
    for dirpath, _, names in os.walk(root):
        for n in names:
            if n == MANIFEST:
                continue
            out.append(os.path.relpath(os.path.join(dirpath, n), root))
    return sorted(out)


def write_manifest(ckpt_dir: str) -> None:
    """Checksum every file under ``ckpt_dir`` into its manifest."""
    files = {rel: _file_sha256(os.path.join(ckpt_dir, rel))
             for rel in _walk_files(ckpt_dir)}
    tmp = os.path.join(ckpt_dir, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump({"version": 1, "files": files}, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(ckpt_dir, MANIFEST))


def verify_manifest(ckpt_dir: str, strict: bool = True) -> bool:
    """True = content matches its manifest. With no manifest at all,
    ``strict=False`` passes and ``strict=True`` fails."""
    mpath = os.path.join(ckpt_dir, MANIFEST)
    if not os.path.exists(mpath):
        return not strict
    try:
        with open(mpath) as f:
            files = json.load(f)["files"]
    except (OSError, ValueError, KeyError, TypeError):
        return False
    if not isinstance(files, dict) or set(files) != set(_walk_files(ckpt_dir)):
        return False
    return all(_file_sha256(os.path.join(ckpt_dir, rel)) == digest
               for rel, digest in files.items())


def _as_tree(tree: Any) -> Any:
    return tree.state_dict() if hasattr(tree, "state_dict") else tree


def _write_file(path: str, write: Callable) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint(path: str, tree: Any,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Atomic checkpoint write: ``torch.save`` into ``<path>.tmp.<pid>``,
    checksum-manifest it, then rename into place. A crash mid-write
    leaves the previous checkpoint intact (plus an ignorable staging
    dir); a crash mid-swap leaves a complete checkpoint under either the
    final or the ``.old`` name. ``extra`` (JSON-serialisable) rides in
    the directory and comes back from :func:`load_extra`."""
    p = _path(path)
    staging = f"{p}.tmp.{os.getpid()}"
    shutil.rmtree(staging, ignore_errors=True)
    os.makedirs(staging)
    _write_file(os.path.join(staging, TREE),
                lambda f: torch.save(_as_tree(tree), f))
    if extra is not None:
        _write_file(os.path.join(staging, EXTRA),
                    lambda f: f.write(json.dumps(extra).encode()))
    write_manifest(staging)
    _maybe_crash("staged")
    if os.path.exists(p):
        old = f"{p}.old.{os.getpid()}"
        shutil.rmtree(old, ignore_errors=True)
        os.rename(p, old)
        os.rename(staging, p)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(staging, p)
    _maybe_crash("renamed")
    # the rename lives in the parent directory's entries
    _fsync_dir(os.path.dirname(p))


def load_extra(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(os.path.join(_path(path), EXTRA)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _into(template: Any, loaded: Any) -> Any:
    """Put a loaded tree where the template says: through
    ``load_state_dict`` for a stateful object, onto the template leaf's
    device for a tensor, recursively for dicts."""
    if hasattr(template, "load_state_dict"):
        template.load_state_dict(loaded)
        return template
    if torch.is_tensor(template) and torch.is_tensor(loaded):
        return loaded.to(template.device)
    if isinstance(template, dict) and isinstance(loaded, dict):
        return {k: _into(template[k], v) if k in template else v
                for k, v in loaded.items()}
    return loaded


def restore_checkpoint(path: str, template: Any = None,
                       verify: bool = True) -> Any:
    """Restore into ``template`` (see :func:`_into`), or return the
    loaded tree when there is none. ``verify=True`` recomputes the
    checksum manifest first and raises :class:`CheckpointCorruptError` on
    any mismatch; a checkpoint without a manifest restores."""
    p = _path(path)
    if verify and not verify_manifest(p, strict=False):
        raise CheckpointCorruptError(
            f"checkpoint {p!r} failed checksum verification (torn write "
            "or corruption) — refusing to load it")
    loaded = torch.load(os.path.join(p, TREE), map_location="cpu",
                        weights_only=True)
    return loaded if template is None else _into(template, loaded)


def restore_or_init(path: str, init_fn: Callable[[], Any]) -> Any:
    """Restore if present, else ``init_fn()``. A corrupt or partial
    checkpoint is skipped with a warning and the fresh state returned."""
    tree = init_fn()
    p = _path(path)
    if os.path.isdir(p):
        try:
            return restore_checkpoint(p, tree)
        except CheckpointCorruptError as e:
            import warnings
            warnings.warn(f"{e}; initializing fresh state instead",
                          RuntimeWarning, stacklevel=2)
    return tree


# ----------------------------------------------- versioned + retention


def _version_dirs(root: str) -> List[Tuple[int, str]]:
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for n in names:
        if n.startswith(_VERSION_PREFIX):
            path = os.path.join(root, n)
            try:
                step = int(n[len(_VERSION_PREFIX):])
            except ValueError:
                continue
            # a stray file under a version name is not a candidate
            if os.path.isdir(path):
                out.append((step, path))
    return sorted(out)


def save_versioned(root: str, step: int, tree: Any,
                   extra: Optional[Dict[str, Any]] = None,
                   keep: int = 3) -> str:
    """Write ``root/ckpt_<step>`` atomically and prune to the last
    ``keep`` versions. Returns the checkpoint path."""
    root = _path(root)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"{_VERSION_PREFIX}{step:08d}")
    save_checkpoint(path, tree, extra=extra)
    if keep and keep > 0:
        for _, old in _version_dirs(root)[:-keep]:
            shutil.rmtree(old, ignore_errors=True)
    return path


def latest_checkpoint(root: str) -> Optional[Tuple[int, str]]:
    """Newest version under ``root`` that passes checksum verification.
    Versioned checkpoints always carry a manifest, so a torn entry with
    none is skipped, and so is a candidate that vanishes while scanned."""
    for step, path in reversed(_version_dirs(_path(root))):
        try:
            if verify_manifest(path, strict=True):
                return step, path
        except OSError:
            continue
    return None


def restore_latest(root: str, template: Any = None
                   ) -> Optional[Tuple[int, Any, Optional[Dict[str, Any]]]]:
    """``(step, tree, extra)`` from the newest valid version, or None
    when no usable checkpoint exists."""
    found = latest_checkpoint(root)
    if found is None:
        return None
    step, path = found
    # latest_checkpoint already verified this path
    return (step, restore_checkpoint(path, template, verify=False),
            load_extra(path))


def _snapshot(tree: Any) -> Any:
    """An owned host copy of a tree: nothing in it aliases a live
    parameter or optimizer buffer."""
    tree = _as_tree(tree)
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v) for v in tree)
    return tree


class AsyncCheckpointer:
    """Checkpoint cadence off the hot path: :meth:`save` takes an owned
    host snapshot of the tree on-step (the only cost the training loop
    pays) and hands serialisation and fsync to a background thread. The
    next ``save`` joins the previous write first (at most one snapshot in
    flight), and :meth:`flush` drains synchronously, as the preemption
    path of ``fit`` does. A failed background write re-raises at the next
    ``save``/``flush``."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None) -> None:
        snapshot = _snapshot(tree)
        self.flush()                           # join the previous write

        def work():
            try:
                save_versioned(self.root, step, snapshot, extra=extra,
                               keep=self.keep)
            except BaseException as e:         # surfaced at the next join
                self._err = e
        t = threading.Thread(target=work, daemon=True,
                             name="tosem-async-ckpt")
        t.start()
        self._thread = t

    def flush(self) -> None:
        """Wait for the in-flight write (if any); re-raise its error."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.flush()
