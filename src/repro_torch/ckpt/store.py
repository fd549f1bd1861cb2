"""Sharded checkpointing with manifest + async writer (port of
``repro.ckpt.store``; the same layout and manifest).

Layout::

    <dir>/step_000042/
        manifest.json      # step, arch, key-map digest, leaf index
        leaf_00000.npy ... # one array per param/opt leaf (flattened path)

Leaf paths are the reference's strings, ``jax.tree_util``'s key-path form
over sorted dict keys (``['params']/['embed']/['table']``), so a checkpoint
written by either package restores in the other.  Tensors go to the host
at ``save`` (bfloat16 leaves as float32: numpy has no bfloat16; restore
casts back exactly); ``restore`` returns tensors on the template's device
and dtype.  The manifest records the HAM key-map digest; saves are
double-buffered onto a background thread; restores are exact.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch


def _flatten_with_paths(tree, prefix=()):
    """(paths, leaves) in ``jax.tree_util`` order and key-path spelling."""
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(f"[{i}]", t) for i, t in enumerate(tree)]
    else:
        return ["/".join(prefix)], [tree]
    paths, leaves = [], []
    for key, sub in items:
        p, lv = _flatten_with_paths(sub, prefix + (key,))
        paths += p
        leaves += lv
    return paths, leaves


def _unflatten(template, leaves):
    """A tree shaped like ``template`` holding ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(template)


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf``: never a view, since the optimizer updates
    params and moments in place while an async save is still writing."""
    if isinstance(leaf, torch.Tensor):
        dtype = torch.float32 if leaf.dtype == torch.bfloat16 else leaf.dtype
        return leaf.detach().to(device="cpu", dtype=dtype, copy=True).numpy()
    return np.array(leaf, copy=True)


class CheckpointStore:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree, *, meta: dict | None = None,
             blocking: bool = False) -> None:
        self.wait()  # one in-flight save at a time (double buffer)
        paths, leaves = _flatten_with_paths(tree)
        host_leaves = [_to_host(leaf) for leaf in leaves]  # device -> host now

        def write():
            try:
                tmp = os.path.join(self.dir, f".tmp_step_{step:09d}")
                final = os.path.join(self.dir, f"step_{step:09d}")
                os.makedirs(tmp, exist_ok=True)
                index = []
                for i, (p, arr) in enumerate(zip(paths, host_leaves)):
                    fname = f"leaf_{i:05d}.npy"
                    np.save(os.path.join(tmp, fname), arr)
                    index.append({"path": p, "file": fname,
                                  "shape": list(arr.shape),
                                  "dtype": str(arr.dtype)})
                manifest = {"step": step, "leaves": index}
                manifest.update(meta or {})
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)  # atomic publish
                self._gc()
            except BaseException as e:  # noqa: BLE001 — surfaced via wait()
                self._error = e

        if blocking:
            write()
            if self._error:
                err, self._error = self._error, None
                raise err
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.list_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def list_steps(self) -> list[int]:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_"))

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step:09d}", "manifest.json")) as f:
            return json.load(f)

    def restore(self, step: int, template):
        """Restore into the structure of ``template``: each tensor leaf on
        the template leaf's device and in its dtype; a numpy leaf as numpy."""
        d = os.path.join(self.dir, f"step_{step:09d}")
        by_path = {e["path"]: e for e in self.manifest(step)["leaves"]}
        paths, leaves = _flatten_with_paths(template)
        out = []
        for p, leaf in zip(paths, leaves):
            e = by_path.get(p)
            if e is None:
                raise KeyError(f"checkpoint missing leaf {p!r}")
            arr = np.load(os.path.join(d, e["file"]))
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"leaf {p!r}: checkpoint shape {arr.shape} != template "
                    f"{tuple(leaf.shape)} (elastic reshard not yet applied)"
                )
            if isinstance(leaf, torch.Tensor):
                arr = torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
            out.append(arr)
        return _unflatten(template, out)
