"""Atomic, async checkpoints in the JAX package's layout.

One directory per step::

    <dir>/step_00000100/
        manifest.json      # step, time, leaf index, each leaf's dtype, meta
        arrays.npz         # flattened path -> full array

* **atomic** — written to ``step_X.tmp`` then renamed, so a crashed save
  is never mistaken for a valid checkpoint;
* **async** — ``save_async`` copies every tensor to the host before it
  returns (the train step updates its tensors in place) and writes the
  files on a background thread;
* **self-describing** — the manifest refuses a mismatched config
  (``expect_meta``) instead of silently mis-restoring;
* **across packages** — the layout, the leaf paths and ``config_hash`` are
  the JAX package's, so a checkpoint written by one restores in the other.

numpy has no bfloat16: ``np.savez`` stores such a leaf as raw 2-byte
records (``|V2``), and ``np.load`` gives them back untyped.  The JAX
package's own restore then loses the leaf's type (ROADMAP §3).  The port
writes the same raw bits, records every leaf's dtype in the manifest
(``dtypes``), and rebuilds a bfloat16 tensor from the bits on restore; a
``|V2`` leaf of a checkpoint without ``dtypes`` (one the JAX package
wrote) can only be bfloat16, its one 2-byte type numpy does not know.

A DTensor leaf is saved whole (``full_tensor()``, a collective every rank
of its mesh takes part in).  Where several ranks save the same state, one
of them writes (``writer``) and the others' ``wait`` waits for its file.
``restore(shardings=...)`` places each leaf onto the given ``(mesh,
placements)``: every rank reads the whole leaf and keeps its own shard,
so a checkpoint restores onto any mesh (the elastic re-mesh).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels._shard import place, whole

RAW_BF16 = np.dtype("V2")
WRITER_WAIT_S = 600.0  # how long a non-writer waits for the writer's file


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _unflatten(flat: dict[str, Any]) -> Any:
    root: dict = {}
    for path, v in flat.items():
        parts = [p for p in path.split("/") if p]
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def config_hash(cfg) -> str:
    payload = repr(cfg).encode()
    return hashlib.sha256(payload).hexdigest()[:16]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_host(t: Any, copy: bool) -> np.ndarray:
    """A leaf as a numpy array: bfloat16 as its raw bits (``|V2``).  With
    ``copy``, never a view of the tensor's memory."""
    t = torch.as_tensor(t).detach()
    shares = t.device.type == "cpu"
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        arr = t.contiguous().view(torch.int16).numpy().view(RAW_BF16)
    else:
        arr = t.numpy()
    return arr.copy() if copy and shares else arr


def _from_host(arr: np.ndarray, dtype: str | None) -> torch.Tensor:
    arr = np.require(arr, requirements="C")  # keeps a 0-d leaf 0-d
    if dtype == "bfloat16" or (dtype is None and arr.dtype == RAW_BF16):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    # whether this process writes; a rank that does not waits for the
    # writer's file of each step it saved (``wait``)
    writer: bool = True

    def __post_init__(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        self._pending: threading.Thread | None = None
        self._last_error: Exception | None = None
        self._expected: int | None = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: dict, meta: dict | None = None) -> str:
        """Blocking save of a tree of tensors (or arrays) ``state``."""
        flat = {k: whole(v) for k, v in _flatten(state).items()}
        dtypes = {k: _dtype_name(torch.as_tensor(v)) for k, v in flat.items()}
        host_flat = {k: _to_host(v, copy=False) for k, v in flat.items()}
        if not self.writer:
            self._expected = step
            self.wait()
            return os.path.join(self.directory, f"step_{step:08d}")
        return self._write(step, host_flat, dtypes, meta or {})

    def save_async(self, step: int, state: dict, meta: dict | None = None) -> None:
        """Non-blocking save: the copy to the host now, file IO in the
        background."""
        self.wait()  # one in-flight save at a time (bounded memory)
        flat = {k: whole(v) for k, v in _flatten(state).items()}
        dtypes = {k: _dtype_name(torch.as_tensor(v)) for k, v in flat.items()}
        host_flat = {k: _to_host(v, copy=True) for k, v in flat.items()}
        meta = dict(meta or {})
        if not self.writer:
            self._expected = step
            return

        def work() -> None:
            try:
                self._write(step, host_flat, dtypes, meta)
            except Exception as e:  # pragma: no cover - surfaced via wait()
                self._last_error = e

        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()

    def wait(self) -> None:
        """Wait for the save in flight (a non-writer: for the writer's
        file of the last step it saved)."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._expected is not None:
            manifest = os.path.join(self.directory, f"step_{self._expected:08d}",
                                    "manifest.json")
            deadline = time.monotonic() + WRITER_WAIT_S
            while not os.path.exists(manifest):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"no checkpoint {manifest} from the writer")
                time.sleep(0.01)
            self._expected = None
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    def _write(self, step: int, host_flat: dict, dtypes: dict, meta: dict) -> str:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **host_flat)
        manifest = {
            "step": step,
            "time": time.time(),
            "leaves": sorted(host_flat),
            "dtypes": dtypes,
            **meta,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as fh:
            json.dump(manifest, fh, indent=2)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(
        self,
        step: int | None = None,
        device=None,
        expect_meta: dict | None = None,
        shardings: Any = None,
    ) -> tuple[int, dict, dict]:
        """Load (step, state, manifest), the state's tensors on ``device``
        (default: the card), each in the dtype it was saved in.
        ``shardings``: a tree like the state's with ``(mesh, placements)``
        (or None) leaves; each such leaf comes back a DTensor so placed."""
        dev = resolve_device(device)
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as fh:
            manifest = json.load(fh)
        for key, expected in (expect_meta or {}).items():
            if manifest.get(key) != expected:
                raise ValueError(
                    f"checkpoint meta mismatch for {key!r}: "
                    f"saved {manifest.get(key)!r} != expected {expected!r}"
                )
        dtypes = manifest.get("dtypes", {})
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: _from_host(z[k], dtypes.get(k)).to(dev) for k in z.files}
        if shardings is not None:
            placed = _flatten(shardings)
            flat = {k: v if placed.get(k) is None else place(v, *placed[k])
                    for k, v in flat.items()}
        return step, _unflatten(flat), manifest
