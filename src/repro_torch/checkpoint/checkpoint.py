"""Fault-tolerant checkpointing: atomic, async, retention-managed.

PyTorch counterpart of ``repro.checkpoint.checkpoint``, with the same
on-disk layout (one directory per step):

  <dir>/step_00000123.tmp/...   (written)
  <dir>/step_00000123/          (atomic rename on completion)
      manifest.json             step, num_arrays, keypaths, process_index, extra
      arr_00000.npy ...         flattened leaves

Atomicity: a checkpoint is valid iff the final directory exists (rename is
atomic on POSIX); partially written .tmp dirs are ignored and purged.  The
async writer moves serialization off the caller's thread: each leaf is
copied to the host synchronously (a consistent snapshot, even of buffers
that are later written in place), and the file IO overlaps.

Trees are nested dicts (keys in sorted order), lists, tuples and
NamedTuples; ``None`` holds no leaf.  Leaves are tensors, numpy arrays,
scalars and ``torch.Generator``\\ s.  Key paths are spelled as
``jax.tree_util.keystr`` spells them (``['sched'].gibbs.mu``), so a
checkpoint of one package restores by name into the other's states:

  * a generator is saved as the uint8 tensor ``get_state()`` returns, under
    its own field name (``['sched'].generator``, where the JAX states carry
    ``key`` leaves), and restored by ``set_state`` on a new generator on the
    template generator's device;
  * a bfloat16 tensor is saved as its 2-byte bits in a ``|V2`` array, the
    layout numpy gives a JAX bfloat16 array; a bfloat16 template leaf takes
    any array of 2-byte bits back;
  * ``restore`` puts each leaf on the device and dtype of the template's;
  * a DTensor leaf (a sharded trainer's) is saved whole and restored into
    the template's mesh and placements, so a checkpoint moves between a
    sharded run and an unsharded one.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import is_dtensor

MANIFEST = "manifest.json"
_BITS16 = np.dtype("V2")  # numpy's spelling of a bfloat16 array on disk


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _flatten_with_paths(tree: Any, prefix: str = "") -> Tuple[List[str], List[Any]]:
    """Leaves and their key paths, in ``jax.tree_util.tree_flatten`` order."""
    if tree is None:
        return [], []
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f".{name}", getattr(tree, name)) for name in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", x) for i, x in enumerate(tree)]
    else:
        return [prefix], [tree]
    paths, leaves = [], []
    for key, child in items:
        p, l = _flatten_with_paths(child, prefix + key)
        paths += p
        leaves += l
    return paths, leaves


def _unflatten(tree: Any, leaves) -> Any:
    """``tree`` with its leaves replaced, in flatten order, from the iterator
    ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(x, leaves) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(x, leaves) for x in tree)
    return next(leaves)


def _snapshot(leaf: Any) -> np.ndarray:
    """A host copy of one leaf, taken now; a DTensor's whole (a collective:
    every rank of its mesh saves)."""
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        host = leaf.detach().to("cpu", copy=True)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(_BITS16)
        return host.numpy()
    return np.array(leaf)


def _spec(leaf: Any) -> Tuple[Tuple[int, ...], Optional[np.dtype]]:
    """The shape and numpy dtype a saved array must have to fill ``leaf``
    (dtype None: any); a bfloat16 tensor's dtype is ``|V2``."""
    if isinstance(leaf, torch.Generator):
        state = leaf.get_state()
        return tuple(state.shape), np.dtype(np.uint8)
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return tuple(leaf.shape), _BITS16
        return tuple(leaf.shape), torch.empty((), dtype=leaf.dtype).numpy().dtype
    dtype = getattr(leaf, "dtype", None)
    return tuple(getattr(leaf, "shape", ())), None if dtype is None else np.dtype(dtype)


def _bf16_bits(arr: np.ndarray) -> bool:
    """2-byte values that are bfloat16 bits: a ``|V2`` array, 16-bit
    integers, or an ml_dtypes bfloat16 array (float16 values are not)."""
    return arr.dtype.itemsize == 2 and arr.dtype.kind in "Viu"


def _dtype_matches(arr: np.ndarray, leaf: Any, want: Optional[np.dtype]) -> bool:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return _bf16_bits(arr)
    return want is None or arr.dtype == want


def _place(arr: np.ndarray, leaf: Any) -> Any:
    """The saved ``arr`` in the template leaf's kind: a tensor on its device
    and in its dtype (a DTensor on its mesh, in its placements), a new
    generator on its device, else the array."""
    if isinstance(leaf, torch.Generator):
        gen = torch.Generator(device=leaf.device)
        gen.set_state(torch.from_numpy(np.asarray(arr, np.uint8, order="C")))
        return gen
    if not isinstance(leaf, torch.Tensor):
        return arr
    if leaf.dtype == torch.bfloat16 and _bf16_bits(arr):
        host = torch.from_numpy(np.asarray(arr, order="C").view(np.int16)).view(torch.bfloat16)
    else:
        host = torch.from_numpy(np.asarray(arr, order="C"))
    if is_dtensor(leaf):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(host.to(device=leaf.device, dtype=leaf.dtype), leaf.device_mesh,
                                 leaf.placements, src_data_rank=None)
    return host.to(device=leaf.device, dtype=leaf.dtype)


def _process_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, async_write: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._purge_tmp()

    # -- write ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        """Snapshot (sync device->host copy) then write (async unless disabled).

        The manifest records each leaf's key path so ``restore_by_name`` can
        later match leaves by NAME: a checkpoint whose scheduler or ring
        leaves drifted in shape still gives back its valid model params.
        """
        keypaths, raw_leaves = _flatten_with_paths(tree)
        leaves = [_snapshot(l) for l in raw_leaves]  # consistent snapshot
        extra = dict(extra or {})
        process_index = _process_index()
        self.wait()  # one outstanding write at a time

        def write():
            tmp = self.dir / f"step_{step:08d}.tmp"
            final = self.dir / f"step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for i, arr in enumerate(leaves):
                np.save(tmp / f"arr_{i:05d}.npy", arr)
            manifest = {
                "step": step,
                "num_arrays": len(leaves),
                "keypaths": keypaths,
                "process_index": process_index,
                "extra": extra,
            }
            (tmp / MANIFEST).write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)  # atomic commit
            self._retain()

        if self.async_write:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- read ----------------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp"):
                if (p / MANIFEST).exists():
                    out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _open(self, step: Optional[int]) -> Tuple[pathlib.Path, Dict, Callable[[int], np.ndarray]]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"step_{step:08d}"
        manifest = json.loads((path / MANIFEST).read_text())
        return path, manifest, lambda i: np.load(path / f"arr_{i:05d}.npy")

    def restore(self, tree_like: Any, step: Optional[int] = None) -> Tuple[Any, Dict]:
        """Restore into the structure of ``tree_like``; returns (tree, extra).

        Raises ``ValueError`` on a leaf-count or shape drift (a generator's
        shape is that of its state, which differs between devices).
        """
        _, manifest, load = self._open(step)
        _, leaves = _flatten_with_paths(tree_like)
        arrs = [load(i) for i in range(manifest["num_arrays"])]
        if len(arrs) != len(leaves):
            raise ValueError(
                f"checkpoint has {len(arrs)} leaves, structure needs {len(leaves)}"
            )
        # Shape drift must fail HERE (callers keep a legacy fallback), not
        # surface later as a runtime crash: leaf count alone let e.g. an old
        # scalar ewma_count restore into today's per-worker (K,) slot.
        for i, (arr, leaf) in enumerate(zip(arrs, leaves)):
            shape, _ = _spec(leaf)
            if (hasattr(leaf, "shape") or isinstance(leaf, torch.Generator)) and (
                    tuple(arr.shape) != shape):
                raise ValueError(
                    f"checkpoint leaf {i} has shape {tuple(arr.shape)}, "
                    f"structure needs {shape}"
                )
        placed = [_place(arr, leaf) for arr, leaf in zip(arrs, leaves)]
        return _unflatten(tree_like, iter(placed)), manifest["extra"]

    def restore_by_name(
        self, tree_like: Any, step: Optional[int] = None
    ) -> Tuple[Any, Dict, Dict[str, List[str]]]:
        """Subset restore: match checkpoint leaves to ``tree_like`` by NAME.

        Each leaf of ``tree_like`` whose key path exists in the checkpoint
        with the same shape and dtype (any 2-byte bits for a bfloat16 leaf)
        gets the saved array; every other leaf keeps its template value.

        Returns ``(tree, extra, report)`` where ``report`` lists the
        ``restored`` and ``skipped`` key paths of ``tree_like``.  Raises
        ``ValueError`` for pre-keypath checkpoints (restore those
        positionally via ``restore``).
        """
        _, manifest, load = self._open(step)
        if "keypaths" not in manifest:
            raise ValueError(
                "checkpoint predates key-path manifests; use restore()"
            )
        index = {kp: i for i, kp in enumerate(manifest["keypaths"])}
        paths, leaves = _flatten_with_paths(tree_like)
        out, restored, skipped = [], [], []
        for kp, leaf in zip(paths, leaves):
            i = index.get(kp)
            arr = load(i) if i is not None else None
            want_shape, want_dtype = _spec(leaf)
            if (
                arr is not None
                and tuple(arr.shape) == want_shape
                and _dtype_matches(arr, leaf, want_dtype)
            ):
                out.append(_place(arr, leaf))
                restored.append(kp)
            else:
                out.append(leaf)
                skipped.append(kp)
        tree = _unflatten(tree_like, iter(out))
        return tree, manifest["extra"], {"restored": restored, "skipped": skipped}

    # -- hygiene ---------------------------------------------------------------
    def _retain(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def _purge_tmp(self) -> None:
        for p in self.dir.glob("step_*.tmp"):
            shutil.rmtree(p, ignore_errors=True)
