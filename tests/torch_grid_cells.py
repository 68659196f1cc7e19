"""Grid cells for ``tests/test_torch_grid.py`` and
``tests/test_torch_globe_shard.py``: what a cold worker has loaded.
Importable by a worker whose ``PYTHONPATH`` holds this folder; they
import nothing themselves."""

import os
import sys


def loaded(**_) -> dict:
    return {"torch": "torch" in sys.modules,
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}


def segments_attached(**_) -> bool:
    """Whether the worker has attached the pool's shared-memory segments
    (it imports ``multiprocessing.shared_memory`` only to attach them)."""
    return "multiprocessing.shared_memory" in sys.modules
