"""Simulation-state checkpointing.

The format of `nbody_tpu.utils.checkpoint`: one .npz holding `q`, `v`, any
`extra_<key>` arrays and a JSON-encoded `_meta` entry (versioned). A
checkpoint written by either package loads in the other. numpy only: pass
host arrays (`simulate`'s `on_chunk` hands over host float64 arrays).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

FORMAT_VERSION = 1


def save_checkpoint(path: str, *, step: int, q, v, extra: dict | None = None,
                    meta: dict | None = None) -> None:
    """Persist simulation state at a global step index."""
    payload = {
        "q": np.asarray(q),
        "v": np.asarray(v),
        "_meta": np.frombuffer(json.dumps({
            "version": FORMAT_VERSION,
            "step": int(step),
            "meta": meta or {},
            "extra_keys": sorted((extra or {}).keys()),
        }).encode(), dtype=np.uint8),
    }
    for k, arr in (extra or {}).items():
        payload[f"extra_{k}"] = np.asarray(arr)
    with open(path, "wb") as f:
        np.savez(f, **payload)


def load_checkpoint(path: str):
    """Returns (step, q, v, extra_dict, meta_dict)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["_meta"]).decode())
        if meta["version"] != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {meta['version']}")
        q = z["q"]
        v = z["v"]
        extra = {k: z[f"extra_{k}"] for k in meta["extra_keys"]}
    return meta["step"], q, v, extra, meta["meta"]


@dataclasses.dataclass
class CheckpointPolicy:
    """Periodic checkpointing during chunked simulation loops."""
    path_template: str          # e.g. "ckpt_step{step}.npz"
    every_steps: int = 20000

    def maybe_save(self, step: int, q, v, **kw) -> str | None:
        if step % self.every_steps == 0 and step > 0:
            path = self.path_template.format(step=step)
            save_checkpoint(path, step=step, q=q, v=v, **kw)
            return path
        return None
