"""Checkpoints with atomic commit and exact resume.  Counterpart of
``repro.checkpoint.checkpoint``, in its on-disk layout, so a checkpoint
either package writes restores in the other.

Layout: ``<dir>/step_<N:08d>/`` holding ``arrays.npz`` (one array a leaf)
and ``manifest.msgpack`` (step, metadata, and each leaf's shape, dtype and
checksum, ``sha256(arr.tobytes())[:16]``).  A save writes into
``step_<N>.tmp`` and renames it: a writer killed mid-save never leaves a
committed step behind, and :func:`latest_step` skips ``.tmp`` folders and
folders without a manifest.

Leaves are keyed by JAX's path strings, so the keys are the reference's:
a NamedTuple field is ``.<name>``, a dict key bare, joined by ``/``
(``.params/layers/attn/wq``, ``.opt/.step``,
``.opt/.m/embed``); npz names replace ``/`` by ``__``.  Dicts flatten in
sorted-key order, NamedTuples in field order, as ``jax.tree_util`` does,
so the manifest's bytes are the reference's too.  The manifest goes
through ``_manifest_codec`` (the card's machine has no ``msgpack``).

A tensor leaf is stored as the numpy array of a host copy taken at save
time; one numpy cannot hold (bf16) raises ``TypeError`` naming the leaf,
never upcast.  A Python ``int`` leaf (``AdamWState.step``; the
reference's is a 0-d int32 array) is stored as a 0-d int32 array and
restored as an ``int``.  Restored tensors take the device and dtype of
``tree_like``'s leaves.
"""

from __future__ import annotations

import hashlib
import os
import queue as _queue
import shutil
import threading as _threading
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import _manifest_codec as codec

MANIFEST = "manifest.msgpack"
ARRAYS = "arrays.npz"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _paths(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) for every leaf, in ``jax.tree_util`` flatten order."""
    if _is_namedtuple(tree):
        for name in tree._fields:
            yield from _paths(getattr(tree, name), prefix + (f".{name}",))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    else:
        yield "/".join(prefix), tree


def _unflatten(tree, leaves: Iterator):
    """``tree``'s structure with its leaves replaced, in ``_paths`` order."""
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, n), leaves) for n in tree._fields))
    if isinstance(tree, dict):
        new = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    return next(leaves)


def _host_array(key: str, leaf) -> np.ndarray:
    """A host copy of one leaf: never a view of a tensor that a later
    in-place step could rewrite (a CPU tensor's ``.numpy()`` shares its
    storage)."""
    if isinstance(leaf, bool) or not isinstance(leaf, (int, torch.Tensor)):
        raise TypeError(f"{key}: a checkpoint holds tensors and ints, "
                        f"not {type(leaf).__name__}")
    if isinstance(leaf, int):
        if not -(1 << 31) <= leaf < (1 << 31):
            raise OverflowError(f"{key}: {leaf} does not fit the int32 the "
                                "layout stores")
        return np.asarray(leaf, np.int32)
    try:
        return leaf.detach().to("cpu", copy=True).numpy()
    except TypeError as e:
        raise TypeError(f"{key}: numpy cannot hold a {leaf.dtype} leaf "
                        "(cast the tree to a dtype it holds first)") from e


def _flatten_with_paths(tree) -> Dict[str, np.ndarray]:
    return {k: _host_array(k, leaf) for k, leaf in _paths(tree)}


def _checksum(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save_checkpoint(directory: str, step: int, tree: Any,
                    metadata: Optional[Dict] = None) -> str:
    """Snapshot ``tree`` to the host and commit it as ``step``; returns
    the committed folder."""
    return _write_snapshot(directory, step, _flatten_with_paths(tree), metadata or {})


def latest_step(directory: str) -> Optional[int]:
    """The newest committed step in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(name.split("_")[1]) for name in os.listdir(directory)
             if name.startswith("step_") and not name.endswith(".tmp")
             and os.path.exists(os.path.join(directory, name, MANIFEST))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, tree_like: Any,
                       step: Optional[int] = None) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``tree_like`` (shapes must match):
    returns (tree, step, metadata).  A checksum mismatch raises
    ``IOError``, a shape mismatch ``ValueError``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = _step_dir(directory, step)
    with open(os.path.join(path, MANIFEST), "rb") as f:
        manifest = codec.unpackb(f.read())
    with np.load(os.path.join(path, ARRAYS)) as data:
        flat = {k.replace("__", "/"): data[k] for k in data.files}
    for k, info in manifest["arrays"].items():
        if _checksum(flat[k]) != info["checksum"]:
            raise IOError(f"checksum mismatch for {k} in {path}")
    leaves = []
    for key, leaf in _paths(tree_like):
        arr = flat[key]
        want = () if isinstance(leaf, int) else tuple(leaf.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != expected {want}")
        if isinstance(leaf, int):
            leaves.append(int(arr))
        else:
            leaves.append(torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype))
    return _unflatten(tree_like, iter(leaves)), manifest["step"], manifest["metadata"]


def prune_old(directory: str, keep: int = 3) -> None:
    """Remove all but the newest ``keep`` committed steps."""
    if not os.path.isdir(directory):
        return
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(directory)
                   if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)


# ---------------------------------------------------------------------------
# Async writer: snapshot on the caller thread, serialize + commit off-thread
# ---------------------------------------------------------------------------

class AsyncCheckpointer:
    """Checkpoints that cost the training loop only the device-to-host
    snapshot: npz serialization and the atomic rename run on a background
    thread.

    The queue holds one snapshot: a save that arrives while one is still
    waiting blocks until the writer takes it (bounded host memory, steps
    committed in order).  ``wait()`` drains the queue; an error on the
    writer thread is raised again by the next ``save`` or ``wait``.  The
    snapshot is a copy, so the in-place optimizer step that follows a
    save cannot change what is written.  ``last_write_s`` is the newest
    write's serialize-and-commit seconds."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self.last_write_s: Optional[float] = None
        self._q: "_queue.Queue" = _queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._thread = _threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def save(self, step: int, tree: Any, metadata: Optional[Dict] = None):
        self._raise_pending()
        self._q.put((step, _flatten_with_paths(tree), metadata or {}))

    def wait(self):
        self._q.join()
        self._raise_pending()

    def close(self):
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=60)

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, flat, metadata = item
            try:
                t0 = time.perf_counter()
                _write_snapshot(self.directory, step, flat, metadata)
                prune_old(self.directory, self.keep)
                self.last_write_s = time.perf_counter() - t0
            except BaseException as e:  # surfaced on the next save()/wait()
                self._err = e
            finally:
                self._q.task_done()


def _write_snapshot(directory: str, step: int, flat: Dict[str, np.ndarray],
                    metadata: Dict) -> str:
    """Serialize a host snapshot into ``step_<N>.tmp`` and commit it by
    renaming it to ``step_<N>``."""
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "metadata": metadata, "arrays": {}}
    np.savez(os.path.join(tmp, ARRAYS), **{k.replace("/", "__"): v for k, v in flat.items()})
    for k, v in flat.items():
        manifest["arrays"][k] = {"shape": list(v.shape), "dtype": str(v.dtype),
                                 "checksum": _checksum(v)}
    with open(os.path.join(tmp, MANIFEST), "wb") as f:
        f.write(codec.packb(manifest))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final
