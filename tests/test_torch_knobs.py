"""PyTorch port parity: the control layers' environment knobs (ROADMAP
C-18).

The overload, tenancy and health layers resolve an unset field from a
``KIND_TPU_SIM_*`` knob as the reference's do: explicit value, then the
knob, then the default, parsed as the reference's ``Knob.parse`` parses
(an unset or unparseable value is the default; a bool reads ``""``,
``"0"``, ``"false"`` and ``"no"`` as off). Each of the 17 knobs is set on
both sides with ``monkeypatch.setenv`` and the port's ``fleet run
--engine sim`` report, with the flag that turns its layer on, must equal
the reference's byte for byte and differ from the port's report without
the knob. Nothing here touches a device.
"""

import dataclasses
import json

import pytest

from kind_tpu_sim import cli as jcli
from kind_tpu_sim import health as jhealth
from kind_tpu_sim.analysis import knobs as jknobs
from kind_tpu_sim.fleet import overload as jov
from kind_tpu_sim.fleet import tenancy as jten
from kind_tpu_sim_torch import cli as pcli
from kind_tpu_sim_torch import health as phealth
from kind_tpu_sim_torch.fleet import knobs as pknobs
from kind_tpu_sim_torch.fleet import overload as pov
from kind_tpu_sim_torch.fleet import tenancy as pten

from torch_parity import H100_CALIBRATION

# knob -> (a value that changes the run, the fleet run flag of its layer)
CASES = {
    "KIND_TPU_SIM_HEALTH_ALPHA": ("0.6", "--health"),
    "KIND_TPU_SIM_HEALTH_SUSPECT_PHI": ("0.5", "--health"),
    "KIND_TPU_SIM_HEALTH_QUARANTINE_PHI": ("1", "--health"),
    "KIND_TPU_SIM_HEALTH_QUARANTINE_EVALS": ("1", "--health"),
    "KIND_TPU_SIM_HEALTH_PROBE_OK": ("5", "--health"),
    "KIND_TPU_SIM_HEALTH_PROBE_INTERVAL_S": ("0.05", "--health"),
    "KIND_TPU_SIM_HEALTH_MIN_SAMPLES": ("2", "--health"),
    "KIND_TPU_SIM_HEALTH_SIGMA_FRAC": ("0.01", "--health"),
    "KIND_TPU_SIM_HEALTH_SIGMA_ABS": ("0.00001", "--health"),
    "KIND_TPU_SIM_HEALTH_PROBE_TIMEOUT_S": ("0.5", "--health"),
    "KIND_TPU_SIM_HEALTH_SPEC_RATIO": ("2", "--health"),
    "KIND_TPU_SIM_OVERLOAD_RETRY_BUDGET": ("0.9", "--overload"),
    "KIND_TPU_SIM_OVERLOAD_HEDGE_QUANTILE": ("0.5", "--overload"),
    "KIND_TPU_SIM_OVERLOAD_BREAKER_WINDOW": ("4", "--overload"),
    "KIND_TPU_SIM_OVERLOAD_BROWNOUT": ("0", "--overload"),
    "KIND_TPU_SIM_TENANT_ISOLATION": ("no", "--tenancy"),
    "KIND_TPU_SIM_TENANT_DRR_QUANTUM": ("1", "--tenancy"),
}
KNOBS = sorted(CASES)
# raw strings every knob is parsed from, as both registries parse them
RAWS = ["", "0", "1", "3", "3.0", "-1", "0.5", "1e-3", "no", "False",
        "true", "abc"]


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("KIND_TPU_SIM_CALIBRATION", H100_CALIBRATION)


def _fleet_run(cli, flag, capsys):
    argv = ["fleet", "run", "--engine", "sim", "--requests", "200", "--rps",
            "300", flag, "--json"]
    assert cli.main(argv) == 0
    return capsys.readouterr().out


def test_the_cases_cover_every_layer_knob():
    layers = {k.name for k in jknobs.REGISTRY.values()
              if k.layer in ("health", "overload", "tenant")}
    assert set(KNOBS) == layers and len(KNOBS) == 17


@pytest.mark.parametrize("name", KNOBS)
def test_the_knob_is_the_reference_registrys(name):
    ref = jknobs.REGISTRY[name]
    assert pknobs.KNOBS[name] == (ref.default, ref.kind)
    assert type(pknobs.KNOBS[name][0]) is type(ref.default)


@pytest.mark.parametrize("name", KNOBS)
def test_the_knob_parses_as_the_reference_parses(name, monkeypatch):
    assert pknobs.get(name) == jknobs.get(name)
    for raw in RAWS:
        monkeypatch.setenv(name, raw)
        got, want = pknobs.get(name), jknobs.get(name)
        assert (got, type(got)) == (want, type(want)), raw
    # an int knob reads "3.0" as its default, not as 3
    if jknobs.REGISTRY[name].kind == "int":
        monkeypatch.setenv(name, "3.0")
        assert pknobs.get(name) == jknobs.REGISTRY[name].default


@pytest.mark.parametrize("name", KNOBS)
def test_fleet_run_under_the_knob_matches_the_reference(name, monkeypatch,
                                                        capsys):
    value, flag = CASES[name]
    default = _fleet_run(pcli, flag, capsys)
    monkeypatch.setenv(name, value)
    want = _fleet_run(jcli, flag, capsys)
    got = _fleet_run(pcli, flag, capsys)
    assert got == want
    assert got != default
    assert json.loads(got)["ok"] is not None


def test_the_detector_config_resolves_from_the_environment(monkeypatch):
    assert phealth.DetectorConfig.from_env() == phealth.DetectorConfig()
    assert (phealth.DetectorConfig.from_env().as_dict()
            == jhealth.DetectorConfig.from_env().as_dict())
    assert phealth.FailureDetector().cfg == phealth.DetectorConfig()
    monkeypatch.setenv("KIND_TPU_SIM_HEALTH_QUARANTINE_EVALS", "1")
    monkeypatch.setenv("KIND_TPU_SIM_HEALTH_SUSPECT_PHI", "0.5")
    want = jhealth.DetectorConfig.from_env().as_dict()
    assert phealth.DetectorConfig.from_env().as_dict() == want
    assert phealth.FailureDetector().cfg.as_dict() == want
    # an explicit config wins over the environment
    explicit = phealth.DetectorConfig(quarantine_evals=5)
    assert phealth.FailureDetector(explicit).cfg.quarantine_evals == 5
    assert dataclasses.asdict(phealth.DetectorConfig.from_env())[
        "quarantine_evals"] == 1


@pytest.mark.parametrize("fn,name,value", [
    ("resolve_retry_budget", "KIND_TPU_SIM_OVERLOAD_RETRY_BUDGET", "0.4"),
    ("resolve_hedge_quantile", "KIND_TPU_SIM_OVERLOAD_HEDGE_QUANTILE",
     "0.8"),
    ("resolve_breaker_window", "KIND_TPU_SIM_OVERLOAD_BREAKER_WINDOW", "7"),
    ("resolve_brownout", "KIND_TPU_SIM_OVERLOAD_BROWNOUT", "false"),
    ("resolve_isolation", "KIND_TPU_SIM_TENANT_ISOLATION", "0"),
    ("resolve_drr_quantum", "KIND_TPU_SIM_TENANT_DRR_QUANTUM", "2.5"),
])
def test_a_resolver_takes_value_then_knob_then_default(fn, name, value,
                                                       monkeypatch):
    port = getattr(pov, fn, None) or getattr(pten, fn)
    ref = getattr(jov, fn, None) or getattr(jten, fn)
    assert port() == ref()
    monkeypatch.setenv(name, value)
    assert port() == ref() != pknobs.KNOBS[name][0]
    assert port(3) == ref(3)
    monkeypatch.setenv(name, "not a number")
    assert port() == ref()
