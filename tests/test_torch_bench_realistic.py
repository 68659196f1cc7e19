"""The port's bench: its realistic serving entry (``run_realistic``) on
the CPU, at a cut stream on a tiny model, against the reference's keys.
A file of its own beside ``test_torch_bench.py`` (whose helpers it
uses), so that its minute and that file's live reference run go to
different workers."""

import numpy as np
import pytest

from kind_tpu_sim_torch import bench as pbench

from test_torch_bench import (
    CFG,
    _reference_measure_engine,
    _reference_realistic_keys,
    _serving_params,
)
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def test_realistic_entry_on_the_cpu():
    """The realistic entry at a cut stream on a tiny model: the
    reference's keys on top of measure_engine's, counters reset after
    the warm-up, every block back once the prefix cache lets go."""
    sp = _serving_params(CFG)
    tokens_h = np.random.RandomState(4).randint(0, CFG.vocab_size, (2, 64))
    result = {}
    entry = pbench.run_realistic(
        result, "serving_realistic", sp, CFG, tokens_h, 1e-6, True,
        sizes={"independents": 2, "families": 1, "max_new": 3},
        pool_blocks=120)
    assert result["serving_realistic"] is entry
    ref_keys, _ = _reference_measure_engine()
    assert _reference_realistic_keys() <= set(entry)
    assert set(entry) - _reference_realistic_keys() <= ref_keys
    assert entry["requests"] == 5 and entry["generated_tokens"] == 15
    assert entry["pool_blocks"] == 120 and entry["block_size"] == 64
    assert entry["prefix_cache"]["hits"] == 2
    assert entry["prefix_prefill_tokens_skipped"] == 2 * 1024
    assert 0 < entry["peak_blocks_in_use"] <= 119
