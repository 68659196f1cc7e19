"""PyTorch port parity: the replay checker.

The port's ``analysis/replaycheck.py`` and ``analysis replay`` against the
JAX package's, on the CPU host, both sides on the H100's calibration and
generation registry (``torch_parity.h100_registry``):

* the event stream, the per-event and prefix digests and the bisector
  equal the reference's on canned streams and on a real report;
* the targets are the reference's without ``tune`` (ROADMAP Queue A item
  5) and the three scenarios of the cluster layer (item 7), and the
  scenario targets are the registry's replayable names;
* ``replay`` reports the reference's ``events`` and ``stream_digest`` for
  ``fleet-run``, ``sched-run``, ``globe-run``, ``globe-sharded`` and four
  scenario targets, and with the entropy bug injected diverges at the
  reference's event;
* the command prints what the reference's prints, and refuses ``lint``,
  ``contract``, ``knobs`` and the ``tune`` target, naming their items.
"""

import json

import pytest

from kind_tpu_sim import cli as jcli
from kind_tpu_sim.analysis import replaycheck as jrc
from kind_tpu_sim.scenarios import registry as jreg
from kind_tpu_sim_torch import analysis as panalysis
from kind_tpu_sim_torch import cli as pcli
from kind_tpu_sim_torch.analysis import replaycheck as prc
from kind_tpu_sim_torch.scenarios import registry as preg
from torch_parity import (  # noqa: F401
    h100_registry,
    shared_registry,
    torch_one_thread,
)

pytestmark = pytest.mark.usefixtures("torch_one_thread", "h100_registry")

ITEM_7 = ("device-flap", "flaky-exec", "node-flap")


def _events(n, start=0):
    return [{"stream": "completions", "index": i,
             "event": {"id": i, "v": i * i}}
            for i in range(start, start + n)]


def _div(mod, a, b):
    div = mod.first_divergence(a, b)
    return None if div is None else div.as_dict()


def test_the_lazy_package_loads_the_checker():
    assert panalysis.replaycheck is prc
    assert "replaycheck" in dir(panalysis)
    with pytest.raises(AttributeError):
        panalysis.detlint  # noqa: B018


@pytest.mark.parametrize("case", ["identical", "one event", "lengths",
                                  "empty"])
def test_the_bisector_equals_the_reference(case):
    a, b = _events(50), _events(50)
    if case == "one event":
        b[17] = dict(b[17], event={"id": 17, "v": -1})
        b[40] = dict(b[40], event={"id": 40, "v": -1})  # later noise
    elif case == "lengths":
        b = _events(45)
    elif case == "empty":
        a, b = [], _events(3)
    got = _div(prc, a, b)
    assert got == _div(jrc, a, b)
    assert prc.prefix_digests(b) == jrc.prefix_digests(b)
    if case == "identical":
        assert got is None
    elif case == "one event":
        assert got["index"] == 17
        assert [c["index"] for c in got["context"]] == [15, 16]
    else:
        assert got["index"] == (45 if case == "lengths" else 0)


def test_the_event_stream_equals_the_reference():
    report = {"completions": [{"id": 1}, {"id": 2}],
              "policies": {"ici": {"events": [{"t": 0}]}},
              "runs": [{"chaos": [{"at": 1}], "ok": True}], "ok": True}
    events = prc.event_stream(report)
    assert events == jrc.event_stream(report)
    assert [prc.event_digest(e) for e in events] == [
        jrc.event_digest(e) for e in events]
    assert [e["stream"] for e in events] == [
        "completions", "completions", "policies.ici.events", "runs",
        "report"]
    assert events[-1]["event"]["completions"] == "<stream: 2 events>"


def test_the_targets_are_the_reference_s_but_tune_and_item_7():
    leave_out = ITEM_7 + ("tune",)
    assert prc.list_targets() == [t for t in jrc.list_targets()
                                  if t["name"] not in leave_out]
    scenario_targets = sorted(n for n in prc.REPLAY_TARGETS
                              if n not in prc.DRIVER_TARGETS)
    assert scenario_targets == preg.replayable_names()
    assert prc.DRIVER_TARGETS == tuple(n for n in jrc.DRIVER_TARGETS
                                       if n != "tune")
    for name in prc.DRIVER_TARGETS:
        assert name in prc.REPLAY_TARGETS and name not in preg.names()
    assert sorted(set(jreg.replayable_names()) - set(scenario_targets)) == \
        sorted(ITEM_7)


TARGETS = [("fleet-run", 11), ("sched-run", 1), ("globe-run", 3),
           ("globe-sharded", 7), ("globe-zone-loss", 5),
           ("overload-surge", 0), ("sdc-serving-audit", 2),
           ("train-preempt-economics", 1)]


@pytest.mark.parametrize("target,seed", TARGETS,
                         ids=[t for t, _ in TARGETS])
def test_replay_equals_the_reference(target, seed):
    got = prc.replay(target, seed=seed)
    assert got["ok"] and got["events"] > 1
    assert got == jrc.replay(target, seed=seed)


@pytest.mark.parametrize("target", ["fleet-run", "globe-run",
                                    "globe-sharded"])
def test_an_injected_entropy_bug_diverges_where_the_reference_does(target):
    got = prc.replay(target, seed=7, inject=True)
    assert not got["ok"] and got["injected"]
    want = jrc.replay(target, seed=7, inject=True)
    assert got == want
    div = got["divergence"]
    assert div["stream"] == "completions"
    assert div["a"]["event"]["request_id"] == div["b"]["event"]["request_id"]
    assert div["a"]["event"] != div["b"]["event"]


def test_unknown_and_uninjectable_targets_raise():
    with pytest.raises(ValueError, match="unknown replay target"):
        prc.replay("not-a-target")
    with pytest.raises(ValueError, match="unknown replay target"):
        prc.replay("tune")
    with pytest.raises(ValueError, match="injection"):
        prc.replay("sched-run", seed=1, inject=True)
    with pytest.raises(ValueError, match="injection"):
        prc.replay("globe-zone-loss", seed=1, inject=True)
    with pytest.raises(ValueError, match="runs >= 2"):
        prc.replay("fleet-run", runs=1)


# -- the command ---------------------------------------------------------


def _both(argv, capsys):
    rc = pcli.main(list(argv))
    ours = capsys.readouterr().out
    want_rc = jcli.main(list(argv))
    theirs = capsys.readouterr().out
    assert (rc, ours) == (want_rc, theirs)
    return rc, ours


@pytest.mark.parametrize("argv,rc", [
    (("analysis", "replay", "--scenario", "fleet-run", "--seed", "3",
      "--json"), 0),
    (("analysis", "replay", "--scenario", "fleet-run", "--seed", "3",
      "--inject-entropy-bug"), 1),
    (("analysis", "replay", "--scenario", "globe-run", "--runs", "3",
      "--inject-entropy-bug", "--json"), 1),
    (("analysis", "replay", "--scenario", "gray-slow-replica"), 0),
], ids=["json", "injected", "three runs", "scenario"])
def test_the_replay_command_prints_what_the_reference_prints(argv, rc,
                                                             capsys):
    assert _both(argv, capsys)[0] == rc


def test_the_replay_command_lists_the_targets(capsys):
    assert pcli.main(["analysis", "replay", "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == {
        "targets": prc.list_targets()}
    assert pcli.main(["analysis", "replay"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "replay targets (analysis replay --scenario NAME):"
    assert len(lines) == 1 + len(prc.REPLAY_TARGETS)
    assert any(line.split()[0] == "globe-sharded"
               and line.endswith("[slow][injectable]") for line in lines[1:])


@pytest.mark.parametrize("action", ["lint", "contract", "knobs"])
def test_the_linters_are_refused_naming_item_6(action):
    with pytest.raises(SystemExit, match="Queue A item 6"):
        pcli.main(["analysis", action])


def test_the_tune_target_is_refused_naming_item_5():
    with pytest.raises(SystemExit, match="Queue A item 5"):
        pcli.main(["analysis", "replay", "--scenario", "tune"])
