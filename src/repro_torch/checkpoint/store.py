"""Atomic checkpoints, in the reference's on-disk layout.

A port of the reference's ``checkpoint/store.py``:

    <dir>/step_<N>/
        manifest.json   step, leaf names, shapes, dtypes, ``extra``
        arrays.npz      the leaves as ``leaf_<i>``, in the manifest's order

Writes go to ``<dir>/.tmp_step_<N>`` and are renamed into place at the
end, so a crash mid-write never corrupts the latest checkpoint; ``keep``
bounds how many steps stay.  A tree is a flat ``{name: tensor}`` dict in
the caller's own order (the reference's ``treedef`` has no torch
meaning).  bf16 leaves are stored as their 16-bit patterns (numpy has no
bf16) and the manifest names their dtype.  :func:`restore` places the
leaves on ``device`` (default: each template leaf's device), which takes
the place of the reference's re-shard onto a new mesh.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    return np.asarray(t)


def _dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).removeprefix("torch.")
    return str(np.asarray(t).dtype)


def save(ckpt_dir: str, step: int, tree: dict, extra: dict | None = None,
         keep: int = 3) -> str:
    """Write ``tree`` (``{name: tensor or array}``) as ``step_<step>``;
    returns its path."""
    names = list(tree)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": _to_numpy(tree[n]) for i, n in enumerate(names)})
    manifest = {
        "step": step,
        "names": names,
        "n_leaves": len(names),
        "shapes": [list(tree[n].shape) for n in names],
        "dtypes": [_dtype_name(tree[n]) for n in names],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)              # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_"):
            try:
                out.append(int(d.split("_", 1)[1]))
            except ValueError:
                pass
    return out


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: dict, device=None):
    """Load ``step`` as ``{name: tensor}`` in the names, shapes and dtypes
    of ``like`` (a tree of tensors), on ``device`` or else on each
    ``like`` leaf's device.  Returns ``(tree, extra)``; raises if the
    checkpoint holds other names or shapes."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["names"] != list(like):
        raise ValueError(f"checkpoint structure mismatch at {path}: "
                         f"{len(manifest['names'])} leaves saved, "
                         f"{len(like)} asked for, or another order")
    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (name, ref) in enumerate(like.items()):
            arr = data[f"leaf_{i}"]
            if list(arr.shape) != list(ref.shape):
                raise ValueError(f"{name}: saved shape {list(arr.shape)}, "
                                 f"expected {list(ref.shape)}")
            t = torch.from_numpy(arr)
            if manifest["dtypes"][i] == "bfloat16":
                t = t.view(torch.bfloat16)
            dev = ref.device if device is None else torch.device(device)
            out[name] = t.to(device=dev, dtype=ref.dtype)
    return out, manifest["extra"]
