"""Checkpoints with atomic commit and async save (``repro.checkpoint``).

The on-disk layout is the JAX package's, so a checkpoint written by
either package restores in the other (leaves in the same tree order):

    <dir>/step_000000123.tmp/     staging, renamed when complete
        manifest.json             step, treedef, leaf -> file, shape,
                                  dtype, crc32 of the stored bytes
        leaf_00000.npy ...        one file per leaf
    <dir>/step_000000123/         committed (atomic os.replace)

bf16 leaves are stored as uint16 views with "bfloat16" in the manifest
(no ``ml_dtypes`` needed). ``restore_latest`` walks newest to oldest,
skipping partial, missing or corrupt commits with a warning;
``keep_last`` removes old steps only after a newer commit.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import warnings
import zlib
from typing import Any, Optional

import numpy as np
import torch

from .. import tree

PyTree = Any

_SAVE_LOCK = threading.Lock()


class CheckpointCorruptError(RuntimeError):
    """A payload file (or the manifest) cannot be read back: names the
    ``path``, and the payload bytes the manifest expects against those on
    disk, so a truncated write and a garbage file tell themselves apart."""

    def __init__(self, path: str, msg: str, expected_bytes: Optional[int] = None,
                 actual_bytes: Optional[int] = None):
        detail = f"corrupt checkpoint file {path!r}: {msg}"
        if expected_bytes is not None:
            detail += (f" (expected {expected_bytes} payload bytes, "
                       f"file holds {actual_bytes})")
        super().__init__(detail)
        self.path = path
        self.expected_bytes = expected_bytes
        self.actual_bytes = actual_bytes


def _leaf_to_numpy(leaf) -> tuple[np.ndarray, str]:
    """The stored array and the dtype name the manifest records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _host_copy(leaf):
    return leaf.detach().cpu().clone() if isinstance(leaf, torch.Tensor) else leaf


def save(directory: str, step: int, tree_: PyTree, *, keep_last: int = 3,
         extra: Optional[dict] = None) -> str:
    """Synchronous save with atomic commit. Returns the committed path."""
    with _SAVE_LOCK:
        os.makedirs(directory, exist_ok=True)
        name = f"step_{step:09d}"
        tmp = os.path.join(directory, name + ".tmp")
        final = os.path.join(directory, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        leaves, treedef = tree.flatten(tree_)
        manifest = {"step": step, "treedef": repr(treedef), "n_leaves": len(leaves),
                    "extra": extra or {}, "leaves": []}
        for i, leaf in enumerate(leaves):
            arr, dtype_name = _leaf_to_numpy(leaf)
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append({
                "file": fname, "shape": list(arr.shape), "dtype": dtype_name,
                "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            })
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic commit
        _gc(directory, keep_last)
        return final


def save_async(directory: str, step: int, tree_: PyTree, *, keep_last: int = 3,
               extra: Optional[dict] = None) -> threading.Thread:
    """Background-thread save. The leaves are copied to the host on the
    caller's thread first, so training may go on at once."""
    host = tree.tree_map(_host_copy, tree_)
    t = threading.Thread(target=save, args=(directory, step, host),
                         kwargs=dict(keep_last=keep_last, extra=extra), daemon=True)
    t.start()
    return t


def _steps(directory: str, reverse: bool = False) -> list:
    return sorted((d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp")), reverse=reverse)


def _gc(directory: str, keep_last: int) -> None:
    for d in _steps(directory)[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def _is_valid(path: str) -> bool:
    man = os.path.join(path, "manifest.json")
    if not os.path.exists(man):
        return False
    try:
        with open(man) as f:
            m = json.load(f)
        missing = [leaf["file"] for leaf in m["leaves"]
                   if not os.path.exists(os.path.join(path, leaf["file"]))]
    except (json.JSONDecodeError, KeyError, OSError, TypeError):
        return False
    if missing:
        warnings.warn(
            f"checkpoint step {m.get('step', '?')} at {path!r} has a parseable "
            f"manifest but {len(missing)} missing payload file(s) (first: "
            f"{missing[0]!r}); skipping it", RuntimeWarning, stacklevel=2)
        return False
    return True


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    for d in _steps(directory, reverse=True):
        if _is_valid(os.path.join(directory, d)):
            return int(d.split("_")[1])
    return None


def _load_leaf(path: str, meta: dict) -> np.ndarray:
    fpath = os.path.join(path, meta["file"])
    bf16 = meta["dtype"] == "bfloat16"
    stored = np.dtype(np.uint16) if bf16 else np.dtype(meta["dtype"])
    expected = int(np.prod(meta["shape"], dtype=np.int64)) * stored.itemsize
    try:
        arr = np.load(fpath)
    except (ValueError, EOFError, OSError, KeyError) as e:
        try:
            actual = os.path.getsize(fpath)
        except OSError:
            actual = 0
        raise CheckpointCorruptError(fpath, str(e), expected, actual) from e
    if tuple(arr.shape) != tuple(meta["shape"]):
        raise CheckpointCorruptError(
            fpath, f"payload shape {tuple(arr.shape)} != manifest {meta['shape']}",
            expected, os.path.getsize(fpath))
    if "crc32" in meta:
        crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
        if crc != meta["crc32"]:
            raise CheckpointCorruptError(
                fpath, f"crc32 mismatch: payload {crc:#010x} != manifest "
                f"{meta['crc32']:#010x} (bytes flipped after commit)",
                expected, os.path.getsize(fpath))
    return arr


def _to_like(arr: np.ndarray, bf16: bool, ref):
    """The stored array as a leaf like ``ref`` (its dtype and device)."""
    if not isinstance(ref, torch.Tensor):
        return type(ref)(arr) if isinstance(ref, (int, float, bool)) else arr
    if bf16:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(
            arr, dtype=torch.empty((), dtype=ref.dtype).numpy().dtype))
    return t.to(device=ref.device, dtype=ref.dtype)


def restore(directory: str, step: int, like: PyTree) -> PyTree:
    """Restore step ``step`` into the structure, dtypes and devices of
    ``like``. A leaf count or shape that differs from ``like`` raises
    ``ValueError``; unreadable payloads raise
    :class:`CheckpointCorruptError`."""
    path = os.path.join(directory, f"step_{step:09d}")
    man = os.path.join(path, "manifest.json")
    try:
        with open(man) as f:
            manifest = json.load(f)
    except ValueError as e:
        try:
            size = os.path.getsize(man)
        except OSError:
            size = 0
        raise CheckpointCorruptError(man, f"manifest is not valid JSON: {e}",
                                     None, size) from e
    leaves_like, treedef = tree.flatten(like)
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"expected {len(leaves_like)}")
    out = []
    for i, (ref, meta) in enumerate(zip(leaves_like, manifest["leaves"])):
        arr = _load_leaf(path, meta)
        shape = tuple(ref.shape) if hasattr(ref, "shape") else np.shape(ref)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != expected {shape}")
        out.append(_to_like(arr, meta["dtype"] == "bfloat16", ref))
    return tree.unflatten(treedef, out)


def restore_latest(directory: str, like: PyTree):
    """``(step, tree)`` from the newest restorable checkpoint, or ``(None,
    None)``. Invalid or corrupt commits are skipped with a warning naming
    the step; a ``like`` of another structure still raises."""
    if not os.path.isdir(directory):
        return None, None
    for d in _steps(directory, reverse=True):
        path = os.path.join(directory, d)
        if not _is_valid(path):
            continue
        step = int(d.split("_")[1])
        try:
            return step, restore(directory, step, like)
        except CheckpointCorruptError as e:
            warnings.warn(
                f"checkpoint step {step} at {path!r} is corrupt and was skipped "
                f"({e}); falling back to an older checkpoint",
                RuntimeWarning, stacklevel=2)
    return None, None
