"""Dict-of-ndarray <-> bytes container used for segment components.

Thin wrapper over the npz (zip of .npy) format so every segment component is
a single Directory file. Keys are namespaced `"{field_id}/{name}"`.
"""

from __future__ import annotations

import io

import numpy as np


def save_arrays(arrays: dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def load_arrays(data: bytes) -> dict[str, np.ndarray]:
    buf = io.BytesIO(data)
    with np.load(buf, allow_pickle=False) as npz:
        return {k: npz[k] for k in npz.files}


def field_arrays(arrays: dict[str, np.ndarray], field_id: int) -> dict[str, np.ndarray]:
    prefix = f"{field_id}/"
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def with_prefix(arrays: dict[str, np.ndarray], field_id: int) -> dict[str, np.ndarray]:
    return {f"{field_id}/{k}": v for k, v in arrays.items()}
