"""Checkpoint + model-artifact store: durable trees with versioned upgrades.

Ports ``gofr_tpu/checkpoint.py`` whole: ``CheckpointManager`` (``save``,
``restore(like=)``, ``steps``, ``latest_step``, ``manifest``, the crash
recovery of ``_recover`` and the gc of ``_gc``) and ``ArtifactStore``
(``publish``, ``load``, ``versions``, ``apply_upgrades``), on the
reference's on-disk format byte for byte: one directory per checkpoint,
``arrays.npz`` (leaf ``i`` as ``leaf_i``) + ``manifest.json`` (tree paths,
shapes, dtypes, step, metadata), written to a tmp dir, fsynced, then swung
in with ``os.replace`` around a ``.old`` copy. So a tree that either
package writes restores in the other.

The tree paths come from ``gofr_tpu_torch/tree.py`` (dicts in sorted key
order, named tuples by field, lists and tuples by index, as JAX flattens
them). A tensor leaf is saved from the host (``.cpu()``); a bf16 leaf, which
npz cannot hold, travels as its raw bytes under the manifest dtype
``"bfloat16"``, as the reference's ml_dtypes leaves do, and is read back as
uint16 patterns viewed as ``torch.bfloat16`` (no ml_dtypes). Restored
leaves are CPU tensors, or sit on the device and dtype of the matching
``like=`` leaf when that is a tensor: placement stays the caller's.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import tree as tree_util


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array npz stores, the manifest dtype) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            raw = t.view(torch.int16).numpy().tobytes()
            return np.frombuffer(raw, dtype=np.uint8), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    if arr.dtype.isbuiltin:
        return arr, str(arr.dtype)
    # an ml_dtypes leaf handed in as numpy: its bytes, as the reference
    return (np.frombuffer(np.ascontiguousarray(arr).tobytes(),
                          dtype=np.uint8), str(arr.dtype))


def _from_saved(arr: np.ndarray, dtype_name: str, shape) -> torch.Tensor:
    if dtype_name == "bfloat16":
        bits = np.frombuffer(arr.tobytes(), dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    dtype = np.dtype(dtype_name)
    if arr.dtype != dtype:
        arr = np.frombuffer(arr.tobytes(), dtype=dtype).reshape(shape)
    return torch.from_numpy(np.array(arr))


def _rebuildable(paths: List[List[Dict[str, Any]]]) -> bool:
    return all(step["t"] in ("dict", "seq") for path in paths for step in path)


def _rebuild(paths: List[List[Dict[str, Any]]], leaves: List[Any]):
    """Reconstruct a nested dict/list tree from paths (like-free restore).

    Sequence steps build lists; dict steps build dicts, including int-KEYED
    dicts (flagged "ki"), which must not be confused with list indices.
    """
    root: Dict[Any, Any] = {}
    seq_nodes = set()  # id()s of intermediate nodes holding sequence indices
    for path, leaf in zip(paths, leaves):
        if not path:
            return leaf  # scalar tree
        node = root
        for i, step in enumerate(path):
            if step["t"] == "dict":
                key = int(step["k"]) if step.get("ki") else step["k"]
            else:
                key = step["i"]
                seq_nodes.add(id(node))
            if i == len(path) - 1:
                node[key] = leaf
            else:
                node = node.setdefault(key, {})

    def finalize(node):
        if isinstance(node, dict):
            items = {k: finalize(v) for k, v in node.items()}
            if id(node) in seq_nodes:
                return [items[i] for i in range(len(items))]
            return items
        return node

    return finalize(root)


class CheckpointManager:
    """Step-versioned training checkpoints under `root`, atomic + GC'd."""

    def __init__(self, root: str, max_to_keep: int = 3):
        self.root = root
        self.max_to_keep = max_to_keep
        os.makedirs(root, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"ckpt_{step:010d}")

    def steps(self) -> List[int]:
        self._recover()
        out = []
        for name in os.listdir(self.root):
            if name.startswith("ckpt_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[len("ckpt_"):]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any,
             metadata: Optional[Dict[str, Any]] = None) -> str:
        paths, leaves = tree_util.flatten_with_paths(tree)
        saved = [_to_numpy(leaf) for leaf in leaves]
        final = self._dir(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": arr for i, (arr, _) in enumerate(saved)})
        manifest = {
            "step": step,
            "saved_at": time.time(),
            "n_leaves": len(leaves),
            "paths": paths,
            "shapes": [list(leaf.shape) if isinstance(leaf, torch.Tensor)
                       else list(np.shape(leaf)) for leaf in leaves],
            "dtypes": [dtype for _, dtype in saved],
            "rebuildable": _rebuildable(paths),
            "metadata": metadata or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as fp:
            json.dump(manifest, fp)
            fp.flush()
            os.fsync(fp.fileno())
        # fsync file contents + the tmp directory entry BEFORE the rename:
        # os.replace is only atomic for what has reached disk
        with open(os.path.join(tmp, "arrays.npz"), "rb+") as fp:
            os.fsync(fp.fileno())
        dirfd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
        # never a moment without a complete copy on disk: move the old
        # checkpoint aside, swing tmp in, then drop the old one; _recover()
        # handles a crash in the window between the two renames
        old = final + ".old"
        shutil.rmtree(old, ignore_errors=True)
        if os.path.exists(final):
            os.replace(final, old)
        os.replace(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
        self._gc()
        return final

    def _recover(self) -> None:
        """Heal a crash between save()'s two renames: a `.old` without its
        base directory is the only surviving copy; restore it."""
        for name in os.listdir(self.root):
            if name.endswith(".old"):
                base = os.path.join(self.root, name[:-len(".old")])
                if os.path.exists(base):
                    shutil.rmtree(os.path.join(self.root, name),
                                  ignore_errors=True)
                else:
                    os.replace(os.path.join(self.root, name), base)

    def _gc(self) -> None:
        steps = self.steps()
        for step in steps[:-self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(self._dir(step), ignore_errors=True)

    def manifest(self, step: Optional[int] = None) -> Dict[str, Any]:
        self._recover()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        with open(os.path.join(self._dir(step), "manifest.json")) as fp:
            return json.load(fp)

    def restore(self, step: Optional[int] = None, like: Any = None) -> Any:
        """Load a checkpoint. `like=` supplies the target structure (required
        for named-tuple trees, e.g. an optimizer state); a tensor leaf of it
        also gives its restored leaf's device and dtype."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        manifest = self.manifest(step)
        with np.load(os.path.join(self._dir(step), "arrays.npz")) as data:
            leaves = [_from_saved(data[f"leaf_{i}"], manifest["dtypes"][i],
                                  manifest["shapes"][i])
                      for i in range(manifest["n_leaves"])]
        if like is not None:
            like_paths, like_leaves = tree_util.flatten_with_paths(like)
            if like_paths != manifest["paths"]:
                raise ValueError(
                    f"checkpoint structure mismatch: saved {len(manifest['paths'])} "
                    f"leaves, target has {len(like_paths)} (or differing paths)")
            placed = [leaf.to(device=ref.device, dtype=ref.dtype)
                      if isinstance(ref, torch.Tensor) else leaf
                      for leaf, ref in zip(leaves, like_leaves)]
            return tree_util.unflatten(like, placed)
        if not manifest["rebuildable"]:
            raise ValueError("tree contains non-dict/list nodes; pass like=")
        return _rebuild(manifest["paths"], leaves)


class ArtifactStore:
    """Versioned model artifacts for serving: weights + config manifests.

    publish() auto-increments `name/vN`; `latest` resolves at load; ordered
    param upgrades run migration-style against a persisted watermark so an
    artifact is never half-upgraded.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _model_dir(self, name: str) -> str:
        if not name or "/" in name:
            raise ValueError(f"invalid model name {name!r}")
        return os.path.join(self.root, name)

    def versions(self, name: str) -> List[int]:
        mdir = self._model_dir(name)
        if not os.path.isdir(mdir):
            return []
        out = []
        for entry in os.listdir(mdir):
            if entry.startswith("v") and not entry.endswith(".tmp"):
                try:
                    out.append(int(entry[1:]))
                except ValueError:
                    continue
        return sorted(out)

    def publish(self, name: str, params: Any, config: Dict[str, Any],
                version: Optional[int] = None) -> int:
        existing = self.versions(name)
        if version is None:
            version = (existing[-1] + 1) if existing else 1
        elif version in existing:
            raise ValueError(f"{name} v{version} already published")
        vdir = os.path.join(self._model_dir(name), f"v{version}")
        mgr = CheckpointManager(vdir + ".tmp", max_to_keep=0)
        mgr.save(0, params, metadata={"config": config, "name": name,
                                      "version": version, "upgrades_applied": []})
        shutil.rmtree(vdir, ignore_errors=True)
        os.replace(vdir + ".tmp", vdir)
        return version

    def _resolve(self, name: str, version: Optional[int]) -> int:
        versions = self.versions(name)
        if not versions:
            raise FileNotFoundError(f"no artifact {name!r} under {self.root}")
        if version is None:
            return versions[-1]
        if version not in versions:  # before CheckpointManager mkdirs a
            # phantom vN directory that would poison latest-resolution
            raise FileNotFoundError(f"{name!r} has no version {version} "
                                    f"(published: {versions})")
        return version

    def load(self, name: str, version: Optional[int] = None,
             like: Any = None) -> Tuple[Any, Dict[str, Any]]:
        version = self._resolve(name, version)
        mgr = CheckpointManager(os.path.join(self._model_dir(name), f"v{version}"),
                                max_to_keep=0)
        params = mgr.restore(0, like=like)
        meta = mgr.manifest(0)["metadata"]
        return params, meta

    def apply_upgrades(self, name: str,
                       upgrades: Dict[int, Callable[[Any, Dict[str, Any]], Any]],
                       version: Optional[int] = None) -> List[int]:
        """Run pending param upgrades in order against the stored artifact.

        Each upgrade fn maps (params, config) -> params. Applied ids persist
        in the manifest watermark; a rerun is a no-op, a failure applies
        nothing (the rewrite is atomic via CheckpointManager.save).
        """
        version = self._resolve(name, version)
        vdir = os.path.join(self._model_dir(name), f"v{version}")
        mgr = CheckpointManager(vdir, max_to_keep=0)
        params = mgr.restore(0)
        meta = mgr.manifest(0)["metadata"]
        applied = set(meta.get("upgrades_applied", []))
        pending = sorted(k for k in upgrades if k not in applied)
        if not pending:
            return []
        for key in pending:
            params = upgrades[key](params, meta.get("config", {}))
        meta["upgrades_applied"] = sorted(applied | set(pending))
        mgr.save(0, params, metadata=meta)
        return pending
