"""Checkpoints in the JAX package's on-disk format, with async save.

A port of ``repro/checkpoint/checkpoint.py``. Format: ``<dir>/step_<n>/``
holding one ``.npy`` per tree leaf, named by a hash of its flattened key
path (``"0/layers/wq"``, ``"1/m/embed"``, ``"1/count"``:
:mod:`repro_torch.pytree`'s JAX order and keys), and ``manifest.json``
(step, extra, each leaf's file, shape, dtype and bytes). Writes go to
``step_<n>.tmp`` and are renamed atomically, so a crash mid-save never
corrupts the latest checkpoint. A checkpoint written by either package
restores in the other. numpy has no bfloat16, so a bfloat16 leaf is
written as float32 (exactly) and cast back to the template's type on
restore, as any leaf is.

``restore_checkpoint`` puts each leaf on a named device in the type of the
template tree's leaf; a template leaf that is an ``nn.Parameter`` comes
back as one. ``CheckpointManager(..., async_save=True)`` copies the tree
to host memory synchronously and writes in a background thread.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ..pytree import flatten, unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)$")

PathLike = Union[str, Path]


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _host(leaf) -> np.ndarray:
    """A host copy of a leaf (bfloat16 widened to float32)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def save_checkpoint(ckpt_dir: PathLike, step: int, tree,
                    extra: Optional[dict] = None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step}"
    tmp = ckpt_dir / f"step_{step}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for path, leaf in flatten(tree):
        key = _key(path)
        arr = leaf if isinstance(leaf, np.ndarray) else _host(leaf)
        fname = hashlib.md5(key.encode()).hexdigest()[:16] + ".npy"
        np.save(tmp / fname, arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype),
            "bytes": int(arr.nbytes),
        }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    return final


def latest_step(ckpt_dir: PathLike) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(m.group(1)) for d in ckpt_dir.iterdir()
             if (m := _STEP_RE.match(d.name)) and (d / "manifest.json").exists()]
    return max(steps) if steps else None


def _torch_dtype(leaf) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return torch.from_numpy(np.zeros((), dtype=np.asarray(leaf).dtype)).dtype


def restore_checkpoint(ckpt_dir: PathLike, template, device=None,
                       step: Optional[int] = None):
    """Restore into the structure of ``template`` (a tree whose leaves give
    each shape and type: tensors or numpy arrays), each leaf on
    ``device`` (default: the template leaf's device, else the CPU).
    Returns ``(tree, step, extra)``. A leaf missing from the checkpoint
    raises ``KeyError``, a shape that differs ``ValueError``."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    out = []
    for path, spec in flatten(template):
        key = _key(path)
        ent = manifest["leaves"].get(key)
        if ent is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(d / ent["file"])
        shape = tuple(spec.shape)
        if tuple(arr.shape) != shape:
            raise ValueError(f"{key}: shape {arr.shape} != {shape}")
        dev = device if device is not None else (
            spec.device if isinstance(spec, torch.Tensor) else "cpu")
        t = torch.from_numpy(np.require(arr, requirements="C")).to(
            device=dev, dtype=_torch_dtype(spec))
        if isinstance(spec, torch.nn.Parameter):
            t = torch.nn.Parameter(t, requires_grad=spec.requires_grad)
        out.append(t)
    return unflatten(template, out), step, manifest.get("extra", {})


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; optional async background
    writes."""

    def __init__(self, ckpt_dir: PathLike, keep: int = 3,
                 async_save: bool = False):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree, extra: Optional[dict] = None) -> None:
        self.wait()
        if self._error:
            raise self._error
        # snapshot to the host now: the tensors change at the next step
        host = unflatten(tree, [_host(x) for _, x in flatten(tree)])
        if self.async_save:
            def work():
                try:
                    save_checkpoint(self.dir, step, host, extra)
                    self._gc()
                except BaseException as e:  # noqa: BLE001 (raised by save)
                    self._error = e
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            save_checkpoint(self.dir, step, host, extra)
            self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, template, device=None, step=None):
        return restore_checkpoint(self.dir, template, device, step)

    def latest_step(self):
        return latest_step(self.dir)

    def _gc(self) -> None:
        steps = sorted(int(_STEP_RE.match(d.name).group(1))
                       for d in self.dir.iterdir()
                       if _STEP_RE.match(d.name) and d.is_dir())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
