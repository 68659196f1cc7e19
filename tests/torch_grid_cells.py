"""A grid cell for ``tests/test_torch_grid.py``: what a cold worker has
loaded. Importable by a worker whose ``PYTHONPATH`` holds this folder;
it imports nothing itself."""

import os
import sys


def loaded(**_) -> dict:
    return {"torch": "torch" in sys.modules,
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}
