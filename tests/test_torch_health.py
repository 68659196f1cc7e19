"""PyTorch port parity: the gray-failure detector.

The port's ``kind_tpu_sim_torch/health.py`` against the JAX package's
``kind_tpu_sim/health.py``: ``DetectorConfig``'s fields and defaults
(the port reads no environment knob, so its defaults must be the
knobs'), then ``FailureDetector`` fed the same seeded latency streams
(a fleet of components, stragglers that turn slow and recover, probes
and integrity verdicts) with every returned transition, every state,
``relative_latency`` and ``phi`` equal after each sample, and the
reports and health-board counts equal at the end. Then the detector in
the engine fleet (``torch_parity.fleet_layers_run``): a replica slowed x4
for a while is suspected, quarantined and probed, and the whole report
equals the reference's engine fleet's with the same weights. Exact
equality.
"""

import dataclasses
import random

import pytest

from kind_tpu_sim import health as jhealth
from kind_tpu_sim import metrics as jmetrics
from kind_tpu_sim_torch import health as phealth
from kind_tpu_sim_torch import metrics as pmetrics

from torch_parity import FLEET_CFG, fleet_layers_pair, make_params, one_thread

SEEDS = (0, 7, 12345)


def test_config_fields_and_defaults_match_the_reference(monkeypatch):
    fields = [(f.name, f.default)
              for f in dataclasses.fields(jhealth.DetectorConfig)]
    assert [(f.name, f.default)
            for f in dataclasses.fields(phealth.DetectorConfig)] == fields
    for name in ("ALPHA", "SUSPECT_PHI", "QUARANTINE_PHI",
                 "QUARANTINE_EVALS", "PROBE_OK", "PROBE_INTERVAL_S",
                 "MIN_SAMPLES", "SIGMA_FRAC", "SIGMA_ABS",
                 "PROBE_TIMEOUT_S", "SPEC_RATIO"):
        monkeypatch.delenv(f"KIND_TPU_SIM_HEALTH_{name}", raising=False)
    assert (phealth.DetectorConfig().as_dict()
            == jhealth.DetectorConfig.from_env().as_dict())
    assert (phealth.FailureDetector().cfg.as_dict()
            == jhealth.FailureDetector().cfg.as_dict())
    assert (phealth.HEALTHY, phealth.SUSPECT, phealth.QUARANTINED,
            phealth.PHI_CAP) == (jhealth.HEALTHY, jhealth.SUSPECT,
                                 jhealth.QUARANTINED, jhealth.PHI_CAP)


def _stream(seed, components=4, samples=240):
    """(op, component, value, now) events: a noisy baseline, one
    straggler slow in the middle third (a hard spike among its slow
    samples), probes of quarantined components, and one integrity
    verdict and restore."""
    rng = random.Random(seed)
    slow = f"replica-{rng.randrange(components)}"
    factor = rng.uniform(2.5, 6.0)
    lo, hi = samples // 3, 2 * samples // 3
    for i in range(samples):
        comp = f"replica-{i % components}"
        value = 0.01 * rng.uniform(0.85, 1.15)
        if comp == slow and lo <= i < hi:
            value *= factor * (8.0 if i == lo + 40 else 1.0)
        now = round(i * 0.01, 6)
        yield "observe", comp, value, now
        if i % 7 == 0:
            yield "probe", comp, rng.random() < 0.9, now
        if i == samples - 30:
            yield "integrity", f"replica-{(rng.randrange(components))}", \
                None, now
        if i == samples - 10:
            yield "restore", slow, None, now


def _drive(det, seed):
    out = []
    for op, comp, value, now in _stream(seed):
        if op == "observe":
            out.append((det.phi(value), det.relative_latency(comp)))
            out.append(det.observe(comp, value, now))
        elif op == "probe":
            if det.quarantined(comp):
                out.append(det.record_probe(comp, value, now))
        elif op == "integrity":
            out.append(det.record_integrity(comp, now, cause="audit"))
        else:
            out.append(det.restore(comp, now, reason="rebound"))
        out.append(tuple(det.state(f"replica-{k}") for k in range(4)))
    return out, det.report()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cfg", [dict(), dict(quarantine_evals=2,
                                             probe_ok_required=3,
                                             ewma_alpha=0.4)])
def test_detector_matches_the_reference(seed, cfg):
    jb, pb = jmetrics.health_board().counts(), pmetrics.health_board().counts()
    want = _drive(jhealth.FailureDetector(jhealth.DetectorConfig(**cfg)),
                  seed)
    got = _drive(phealth.FailureDetector(phealth.DetectorConfig(**cfg)),
                 seed)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert (pmetrics.health_board().snapshot_since(pb)
            == jmetrics.health_board().snapshot_since(jb))
    transitions = want[1]["transition_counts"]
    assert transitions.get("quarantined", 0) >= 1
    assert transitions.get("restored", 0) >= 1


def test_a_cold_baseline_raises_no_suspicion():
    det = phealth.FailureDetector()
    assert det.phi(10.0) == 0.0
    for i in range(3):
        assert det.observe("replica-0", 0.01, i * 0.1) is None
    assert det.relative_latency("replica-0") == 1.0
    assert det.state("replica-9") == phealth.HEALTHY


def test_engine_fleet_detector_matches_the_reference():
    with one_thread():
        got = fleet_layers_pair(
            make_params(FLEET_CFG),
            dict(process="poisson", rps=150.0, n_requests=80,
                 max_new=(12, 24)), health=True,
            events=[dict(at_s=0.05, action="slow", target=1, param=4.0),
                    dict(at_s=0.3, action="unslow", target=1)])
    counters = got["health"]["counters"]
    assert counters["quarantines"] and counters["probe_dispatches"]
    assert counters["probes_ok"]
    assert "replica-1" in got["health"]["detector"]["components"]
