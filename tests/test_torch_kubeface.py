"""PyTorch port parity: the scheduler's kube manifest face and the
port's own YAML reader and writer.

``kind_tpu_sim_torch/yamlsubset.py`` reads every manifest in ``pods/``
into the documents ``yaml.safe_load_all`` gives (types included), and
raises, naming the line, on what it does not handle; its writer gives
``yaml.safe_dump(doc, sort_keys=False)``'s bytes. On top of them
``sched/kubeface.py`` must turn every manifest into the reference's
``SliceRequest`` gangs, render requests into the reference's Pod and
StatefulSet manifests byte for byte (and back), render scheduler
decisions into the reference's kubernetes Events, and raise the
reference's errors. ``fleet/training.py``'s manifest round trip rides
on it. Nothing here touches a device; PyYAML is used only by the tests
and the reference.
"""

import random
from pathlib import Path

import pytest
import yaml

from kind_tpu_sim import fleet as jfleet
from kind_tpu_sim import sched as jsched
from kind_tpu_sim_torch import fleet as pfleet
from kind_tpu_sim_torch import sched as psched
from kind_tpu_sim_torch import yamlsubset

ROOT = Path(__file__).resolve().parent.parent
PODS = sorted((ROOT / "pods").glob("*.yaml"))
POD_IDS = [p.name for p in PODS]


def _dicts(reqs):
    return [r.as_dict() for r in reqs]


def _port_request(req):
    return psched.SliceRequest(**{k: getattr(req, k) for k in (
        "name", "accelerator", "topology", "priority", "arrival_s",
        "hold_s", "pool", "zone")})


@pytest.mark.parametrize("path", PODS, ids=POD_IDS)
def test_the_reader_equals_safe_load_all(path):
    text = path.read_text()
    want = list(yaml.safe_load_all(text))
    got = yamlsubset.load_all(text)
    assert got == want
    assert repr(got) == repr(want)  # the same types, key order included


SNIPPETS = {
    "typing": ("a: 2\nb: '4'\nc: \"100\"\nd: true\ne: no\nf: ~\ng: 1.5\n"
               "h: 0x1F\ni: 017\nj: 1_000\nk: -.inf\nl: 4x4\nm: a:b\n"
               "n:\no: -c\np: 1:30\nq: 'it''s'\nr: \"\\t\\u00e9\"\n"),
    "literal": "a: |\n  x\n\n  y\n  # not a comment\nb: 1\n",
    "literal strip and keep": "a: |-\n  x\n\nb: |+\n  y\n\n\nc: 1\n",
    "folded": "a: >\n  x\n  y\n\n  z\n   more\n  w\n",
    "folded with indicator": "a: >2\n    x\n   y\n",
    "sequences": ("a:\n- 1\n- b: 2\n  c: [1, 'x', \"y\", [], {}]\n"
                  "d: {}\ne: []\nf:\n  - - p\n    - q\n  - r\n"),
    "comments and documents": ("# c\n---\na: 1 # c\n---\n---\nb: 'q' # c\n"
                               "---\n"),
    "no final newline": "a: |\n  x\n  y",
}


@pytest.mark.parametrize("text", SNIPPETS.values(), ids=SNIPPETS.keys())
def test_the_reader_equals_safe_load_all_on_constructs(text):
    want = list(yaml.safe_load_all(text))
    got = yamlsubset.load_all(text)
    assert repr(got) == repr(want)


REFUSED = {
    "anchor": ("a: 1\nb: &x 2\n", 2),
    "alias": ("a: *x\n", 1),
    "tag": ("a: 1\nb: !!str 2\n", 2),
    "flow mapping": ("a: {b: 1}\n", 1),
    "complex key": ("? a\n: 1\n", 1),
    "multi-line plain": ("a: b\n  c\n", 2),
    "multi-line quoted": ("a: 'b\n  c'\n", 1),
    "directive": ("%YAML 1.1\n---\na: 1\n", 1),
    "timestamp": ("a: 2020-01-01\n", 1),
    "bad indentation": ("a:\n    b: 1\n  c: 2\n", 3),
}


@pytest.mark.parametrize("text,line", REFUSED.values(), ids=REFUSED.keys())
def test_the_reader_refuses_what_it_does_not_handle(text, line):
    with pytest.raises(ValueError, match=f"line {line}:"):
        yamlsubset.load_all(text)


def test_the_writer_equals_safe_dump_on_random_strings():
    """Strings that must be quoted ('4', 'yes', '- a', ': x', '#c') and
    long ones wrapped past column 80, as values, keys and items."""
    rng = random.Random(0)
    alphabet = "ab-_.:/# '\"?!@`%&*,[]{}|>0123456789xyTtnN~=<"
    fixed = ["4", "-10", "3.5", "true", "no", "", "~", "null", "gang-000",
             "x: y", "#x", "a #b", "- a", "-a", "? x", "?x", ":x", "x:",
             "---x", "...x", "it's", " lead", "trail ", "1:20", "0x10",
             "=", "<<", "public.ecr.aws/docker/library/busybox:stable"]
    for k in range(600):
        if k < len(fixed):
            s = fixed[k]
        elif k % 5 == 0:
            s = " ".join("".join(rng.choice(alphabet)
                                 for _ in range(rng.randint(1, 12)))
                         for _ in range(rng.randint(3, 15)))
        else:
            s = "".join(rng.choice(alphabet)
                        for _ in range(rng.randint(0, 30)))
        doc = {"metadata": {"name": s, "annotations": {"k": s}},
               "spec": {"list": [s, {"key": s, "n": 3}], "n": [],
                        "m": {}, "b": True, "z": None}}
        if 0 < len(s) < 128:  # longer keys are written as complex keys
            doc[s] = 1
        assert yamlsubset.dump(doc) == yaml.safe_dump(doc, sort_keys=False)


def test_the_writer_refuses_what_it_would_double_quote():
    for bad in ({"a": "x\ny"}, {"a": "tab\t"}, {"a": "\u00e9"},
                {"k" * 128: 1}, {"": 1}, {"a": 1.5}):
        with pytest.raises(ValueError):
            yamlsubset.dump(bad)


@pytest.mark.parametrize("path", PODS, ids=POD_IDS)
def test_slice_requests_from_every_manifest(path):
    text = path.read_text()
    want = jsched.slice_requests_from_yaml(text)
    got = psched.slice_requests_from_yaml(text)
    assert _dicts(got) == _dicts(want)


def test_the_tpu_manifests_give_gangs():
    counts = {p.name: len(psched.slice_requests_from_yaml(p.read_text()))
              for p in PODS}
    assert counts["tpu-serving-deployment.yaml"] == 3
    assert counts["tpu-batch-train-job.yaml"] == 1
    assert counts["jax-multihost.yaml"] == 1
    (train,) = psched.slice_requests_from_yaml(
        (ROOT / "pods" / "tpu-batch-train-job.yaml").read_text())
    assert (train.topology, train.priority, train.hold_s) == ("4x4", -10,
                                                              30.0)


def _requests():
    reqs = list(jsched.generate_gangs(jsched.SchedWorkloadSpec(), 0))
    reqs += [
        jsched.SliceRequest(name="pooled", topology="2x4", pool="pool-a"),
        jsched.SliceRequest(name="zoned", topology="2x2",
                            zone="us-east1-b", priority=100),
        jsched.SliceRequest(name="multi-host", topology="4x8",
                            priority=-10, hold_s=12.5),
        jsched.SliceRequest(name="v4", accelerator="tpu-v4-podslice",
                            topology="2x2x4"),
        jsched.SliceRequest(name="v4-sub", accelerator="tpu-v4-podslice",
                            topology="1x1x2", hold_s=3.0),
    ]
    return reqs


@pytest.mark.parametrize("req", _requests(), ids=lambda r: r.name)
def test_to_pod_manifest_matches_the_reference_and_round_trips(req):
    want = jsched.to_pod_manifest(req)
    got = psched.to_pod_manifest(_port_request(req))
    assert got == want
    back = psched.slice_requests_from_yaml(got)
    assert _dicts(back) == _dicts(jsched.slice_requests_from_yaml(want))
    # the manifest carries no arrival time
    assert _dicts(back) == [dict(req.as_dict(), arrival_s=0.0)]


def test_k8s_events_match_the_reference():
    cfg = dict(node_events=((2.0, "node_drain", "tpu-node-0-1"),
                            (6.0, "node_restore", "tpu-node-0-1")))
    want = jsched.run_sched_sim(jsched.SchedSimConfig(**cfg), 0)["events"]
    got = psched.run_sched_sim(psched.SchedSimConfig(**cfg), 0)["events"]
    assert got == want
    types = {e["type"] for e in got}
    assert {"Scheduled", "NodeDrained", "NodeRestored"} <= types
    for namespace in ("default", "batch"):
        assert ([psched.k8s_event(e, namespace) for e in got]
                == [jsched.k8s_event(e, namespace) for e in want])
    # the name keeps the float product: 0.000001 * 1e6 is 0 in hex
    ev = dict(got[0], at_s=2.3e-06)
    assert psched.k8s_event(ev) == jsched.k8s_event(ev)


POD = """\
apiVersion: {api}
kind: {kind}
metadata:
  name: w
spec:
  replicas: {replicas}
  template:
    spec:
      {extra}
      nodeSelector:
{selector}
      containers:
        - name: c
          resources:
            limits:
              google.com/tpu: "{chips}"
"""

ERRORS = {
    "unknown accelerator": dict(
        selector="        cloud.google.com/gke-tpu-accelerator: tpu-v9"),
    "topology against chips": dict(
        selector="        cloud.google.com/gke-tpu-topology: 4x4",
        chips=4),
    "multi-pod gang without a selector": dict(
        kind="StatefulSet", replicas=2, chips=4,
        selector="        hardware-type: tpu"),
    "chips past one host": dict(chips=16,
                                selector="        hardware-type: tpu"),
    "unknown priority class": dict(extra="priorityClassName: urgent",
                                   selector="        hardware-type: tpu"),
}


@pytest.mark.parametrize("fields", ERRORS.values(), ids=ERRORS.keys())
def test_the_reference_errors(fields):
    fields = dict(dict(api="apps/v1", kind="Deployment", replicas=1,
                       extra="", chips=8), **fields)
    text = POD.format(**fields)
    with pytest.raises(ValueError) as want:
        jsched.slice_requests_from_yaml(text)
    with pytest.raises(ValueError) as got:
        psched.slice_requests_from_yaml(text)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["tpu-batch-train-job.yaml",
                                  "tpu-serving-multizone.yaml",
                                  "jax-multihost.yaml"])
def test_training_gangs_from_a_manifest_round_trip(name):
    text = (ROOT / "pods" / name).read_text()
    want = jfleet.gangs_from_manifest(text)
    got = pfleet.gangs_from_manifest(text)
    assert [g.as_dict() for g in got] == [g.as_dict() for g in want]
    for g, w in zip(got, want):
        assert pfleet.to_manifest(g) == jfleet.to_manifest(w)
        (back,) = pfleet.gangs_from_manifest(pfleet.to_manifest(g))
        assert back.as_dict() == g.as_dict()
