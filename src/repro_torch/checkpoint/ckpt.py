"""Checkpointing with atomic commits, async save, retention, and restore
onto a chosen device. Counterpart of ``repro/checkpoint/ckpt.py``,
without JAX: the same on-disk layout and the same flattened keys, so a
checkpoint written by either package loads in the other.

Layout:
  <dir>/step_<N>/manifest.json   — tree structure, shapes, dtypes
  <dir>/step_<N>/arrays.npz      — leaf arrays (host view)
  <dir>/step_<N>/COMMITTED       — written last; partial saves are ignored

A tree is nested dicts, lists and tuples whose leaves are tensors,
numpy arrays or Python scalars. Its flat keys are the reference's: the
path of a leaf joined with ``/``, dict keys visited in sorted order (as
``jax.tree_util`` visits them), sequence positions as ``str(i)``.
Tensors are written as ``.cpu().numpy()``, bfloat16 ones as their bit
patterns (``BF16_HOST``), restored bit for bit. ``process_index`` and
``process_count`` come from ``torch.distributed`` when it is
initialised, else 0 and 1.

Durability note: the commit is the ``os.rename`` of the staging dir to
its final name, followed by an fsync of the *parent* directory — the
rename alone only mutates the in-memory dentry cache, so a power cut
shortly after could roll the commit back even though readers already saw
it. The parent fsync is best-effort: platforms without directory file
descriptors (notably Windows) skip it and keep the weaker
rename-only guarantee.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

_SEP = "/"


def _children(node):
    """``(key, child)`` pairs of an inner node in the reference's order,
    or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten(tree, prefix=()):
    if tree is None:             # an empty subtree, as in jax.tree_util
        return {}
    kids = _children(tree)
    if kids is None:
        return {_SEP.join(prefix): tree}
    flat = {}
    for k, v in kids:
        flat.update(_flatten(v, prefix + (k,)))
    return flat


# numpy has no bfloat16: a bfloat16 tensor is written as its 16-bit
# patterns under a one-field structured dtype that names it, and read
# back bit for bit
BF16_HOST = np.dtype([("bfloat16", "<i2")])


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(BF16_HOST)
        return t.cpu().numpy()
    return np.asarray(leaf)


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A saved leaf as a tensor on ``device`` with the dtype it was saved
    with (``BF16_HOST`` leaves as bfloat16)."""
    if a.dtype == BF16_HOST:
        bits = np.array(a, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.as_tensor(a, device=device)


def _map_leaves(fn, tree, prefix=()):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_leaves(fn, v, prefix + (str(i),))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else type(tree)(out)
    if tree is None:
        return None
    return fn(_SEP.join(prefix), tree)


def _process() -> tuple:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _fsync_dir(path: str) -> None:
    """Flush a directory's entry table to disk so a just-committed rename
    survives power loss. Best-effort: platforms that cannot open
    directories (no ``O_DIRECTORY``, e.g. Windows) or filesystems that
    reject directory fsync keep the weaker rename-only guarantee."""
    if not hasattr(os, "O_DIRECTORY"):
        return
    try:
        fd = os.open(path, os.O_RDONLY | os.O_DIRECTORY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save(ckpt_dir: str, step: int, tree: Any, *,
         metadata: Optional[dict] = None, blocking: bool = True,
         retries: int = 3,
         retry_backoff_s: float = 0.05) -> threading.Thread | None:
    """Atomic checkpoint save. blocking=False returns the writer thread
    (arrays are copied to host memory synchronously, so the caller may
    mutate its tensors immediately).

    Transient I/O failures (``OSError`` from a flaky disk/NFS mount)
    retry up to ``retries`` times with exponential backoff, rebuilding
    the ``.tmp`` staging dir from scratch each attempt. After the last
    attempt the failure is reported as a ``warnings.warn`` instead of
    an exception — a serving run must not die because one snapshot
    failed — and the commit protocol guarantees no torn state either
    way: ``COMMITTED`` is written last inside the staging dir and the
    final rename is atomic, so readers (``latest_step``) only ever see
    the previous intact commit."""
    flat = {k: _host(v) for k, v in _flatten(tree).items()}
    index, count = _process()

    def write_once():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = dict(
            step=step,
            process_index=index,
            process_count=count,
            created=time.time(),
            keys={k: dict(shape=list(v.shape), dtype=str(v.dtype))
                  for k, v in flat.items()},
            metadata=metadata or {},
        )
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write(str(step))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(ckpt_dir)

    def write():
        last = None
        for attempt in range(max(1, retries)):
            try:
                write_once()
                return
            except OSError as e:
                last = e
                if attempt + 1 < max(1, retries):
                    time.sleep(retry_backoff_s * (2 ** attempt))
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{step:08d}.tmp"),
                      ignore_errors=True)
        warnings.warn(
            f"checkpoint save of step {step} to {ckpt_dir} gave up "
            f"after {max(1, retries)} attempts: {last!r} (the previous "
            f"commit is intact; serving continues)",
            RuntimeWarning, stacklevel=2)

    if blocking:
        write()
        return None
    th = threading.Thread(target=write, daemon=True)
    th.start()
    return th


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "COMMITTED")):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _committed(ckpt_dir: str, step: int) -> str:
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "COMMITTED")):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    return path


def load_manifest(ckpt_dir: str, step: int) -> dict:
    """The committed checkpoint's manifest (tree structure, shapes,
    dtypes, user metadata) — lets a consumer validate compatibility
    BEFORE paying for the array load, and reject mismatches with a
    clear error."""
    with open(os.path.join(_committed(ckpt_dir, step),
                           "manifest.json")) as f:
        return json.load(f)


def load_flat(ckpt_dir: str, step: int) -> dict:
    """The committed checkpoint's leaves as a flat ``{path: ndarray}``
    dict (paths are the manifest keys, ``/``-joined). The template-free
    restore path: consumers whose tree structure is not available as a
    live template rebuild their state from the keys."""
    path = _committed(ckpt_dir, step)
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        return {k: npz[k] for k in npz.files}


def load_named(ckpt_dir: str, kind: str,
               version: Optional[int] = None) -> tuple:
    """Load the latest committed checkpoint written FOR a specific
    consumer: the manifest's ``metadata["kind"]`` must equal ``kind``
    (and ``metadata["version"]`` must equal ``version`` when given)
    before any array bytes are read — a directory holding some other
    consumer's snapshots (or an incompatible format revision) is
    rejected with a clear error instead of silently misinterpreted.
    Returns ``(step, tree, metadata)`` with the nested-dict tree
    rebuilt via :func:`unflatten`; raises ``FileNotFoundError`` when
    the directory holds no committed step and ``ValueError`` on a
    kind/version mismatch. The prior bank's restore path."""
    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    meta = load_manifest(ckpt_dir, step).get("metadata", {})
    if meta.get("kind") != kind:
        raise ValueError(
            f"checkpoint at {ckpt_dir} step {step} has kind "
            f"{meta.get('kind')!r}, expected {kind!r}")
    if version is not None and meta.get("version") != version:
        raise ValueError(
            f"checkpoint at {ckpt_dir} step {step} has {kind} version "
            f"{meta.get('version')!r}, expected {version!r}")
    return step, unflatten(load_flat(ckpt_dir, step)), meta


def unflatten(flat: dict) -> dict:
    """Rebuild the nested-dict tree from a flat ``{a/b/c: leaf}`` dict
    (inverse of the dict part of the save-time flatten)."""
    out: dict = {}
    for k, v in flat.items():
        parts = k.split(_SEP)
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def restore(ckpt_dir: str, step: int, template: Any,
            device="cuda") -> Any:
    """Restore into ``template``'s structure, every leaf a tensor on
    ``device`` with the dtype it was saved with."""
    dev = resolve_device(device)
    flat = load_flat(ckpt_dir, step)
    return _map_leaves(lambda k, _: to_tensor(flat[k], dev), template)


class CheckpointManager:
    """save-every-k + retention + async writes + auto-resume."""

    def __init__(self, ckpt_dir: str, save_interval: int = 100,
                 keep: int = 3, async_save: bool = True):
        self.dir = ckpt_dir
        self.save_interval = save_interval
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def maybe_save(self, step: int, tree, metadata=None, force=False):
        if not force and (step % self.save_interval != 0):
            return False
        self.wait()
        if self.async_save:
            # copy to host memory NOW — the caller may overwrite these
            # tensors as soon as we return
            host_tree = _map_leaves(lambda _, v: _host(v), tree)

            def write_then_gc():
                save(self.dir, step, host_tree, metadata=metadata,
                     blocking=True)
                self._gc()
            self._pending = threading.Thread(target=write_then_gc,
                                             daemon=True)
            self._pending.start()
        else:
            save(self.dir, step, tree, metadata=metadata, blocking=True)
            self._gc()
        return True

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.dir)
            if d.startswith("step_") and not d.endswith(".tmp")
            and os.path.exists(os.path.join(self.dir, d, "COMMITTED")))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, template, device="cuda"):
        self.wait()
        s = latest_step(self.dir)
        if s is None:
            return None, None
        return s, restore(self.dir, s, template, device)
