"""Fault-tolerant checkpointing of a tree of tensors (the port of
``repro/training/checkpoint.py:38-135``).

* **Atomic**: state is written into ``step_<N>.tmp/`` and renamed; a
  ``MANIFEST.json`` is written last, so a crash mid-save never corrupts the
  latest restorable checkpoint (restore trusts manifested steps only).
* **Per leaf**: each leaf is its own ``.npy``, addressed by its flattened
  tree path (``"params/layers.0.attn.wq"``). A bf16 leaf is stored bitwise
  as its ``int16`` view (numpy has no bf16 without ``ml_dtypes``); the
  index keeps its true dtype.
* **Async**: ``save_async`` copies the state to host memory now (a real
  copy: on the CPU ``.cpu()`` would alias the live tensors, which the next
  optimizer step overwrites) and writes it on a background thread.
* **Restore** places the leaves on the caller's device (``None`` =
  ``"cuda"``, which raises without a card).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Leaves of a nested dict by "/"-joined key path, keys sorted."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for key in sorted(tree):
        flat.update(_flatten(tree[key], f"{prefix}/{key}" if prefix
                             else str(key)))
    return flat


def _unflatten(template, flat: Dict[str, Any], prefix: str = ""):
    if not isinstance(template, dict):
        return flat[prefix]
    return {key: _unflatten(sub, flat, f"{prefix}/{key}" if prefix
                            else str(key))
            for key, sub in template.items()}


def _structure(tree):
    return ({key: _structure(sub) for key, sub in sorted(tree.items())}
            if isinstance(tree, dict) else None)


def _snapshot(tree):
    """A host copy of every tensor leaf (numpy leaves are copied too)."""
    if isinstance(tree, dict):
        return {key: _snapshot(sub) for key, sub in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(tree))


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        #: seconds and bytes of the last finished write (``_write``)
        self.last_write_s: Optional[float] = None
        self.last_write_bytes = 0

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Dict[str, Any],
             extra: Optional[Dict[str, Any]] = None) -> Path:
        """Synchronous atomic save of a tree of tensors."""
        return self._write(step, _snapshot(state), extra or {})

    def save_async(self, step: int, state: Dict[str, Any],
                   extra: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot to host memory now; write to disk in the background."""
        self.wait()
        host_state = _snapshot(state)

        def work():
            try:
                self._write(step, host_state, extra or {})
            except BaseException as exc:     # re-raised by wait()
                self._error = exc

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the background write; a failed write raises here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host_state, extra) -> Path:
        t0 = time.perf_counter()
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f"step_{step:010d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        index = {}
        nbytes = 0
        for key, leaf in _flatten(host_state).items():
            fname = f"{abs(hash(key)):x}_{len(index)}.npy"
            arr, dtype = _to_numpy(leaf)
            np.save(tmp / fname, arr)
            nbytes += arr.nbytes
            index[key] = {"file": fname, "shape": list(leaf.shape),
                          "dtype": dtype}
        manifest = {"step": step, "time": time.time(), "index": index,
                    "treedef": json.dumps(_structure(host_state)),
                    "extra": extra}
        (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        self.last_write_s = time.perf_counter() - t0
        self.last_write_bytes = nbytes
        return final

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "MANIFEST.json").exists():
                continue  # un-manifested = crashed mid-save; ignore
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None,
                device=None) -> Tuple[Any, int, Dict]:
        """Restore into the structure of ``template`` (a nested dict whose
        leaves name the keys to read), each leaf in its saved dtype on
        ``device``. Returns (state, step, extra)."""
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "MANIFEST.json").read_text())
        index = manifest["index"]
        keys = list(_flatten(template))
        missing = set(keys) - set(index)
        if missing:
            raise ValueError(f"checkpoint lacks keys: {sorted(missing)[:5]}")
        loaded = {k: _from_numpy(np.load(d / index[k]["file"]),
                                 index[k]["dtype"]).to(dev)
                  for k in keys}
        return _unflatten(template, loaded), step, manifest.get("extra", {})
