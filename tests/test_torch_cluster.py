"""PyTorch port parity: the cluster layer (``config.py``, ``runtime.py``,
``registry.py``, ``fakes.py``, ``cluster.py``, ``plugin.py``,
``manifest_lint.py``, ``utils/shell.py`` and the cluster half of
``manifests.py``).

Every command runs over the fake runtime, whose executor records the
command stream instead of running it: no test runs docker, kind,
kubectl or git. The port's streams (each command with its stdin, so the
applied manifests too), its output and its exit codes must equal the
reference's for the ``tpu``, ``nvidia`` and ``rocm`` vendors; every
cluster manifest must equal the reference's PyYAML output byte for
byte; the lint's verdicts and messages must equal what the reference
gets from ``jsonschema``; and the classified retry must classify and
back off as the reference's does.
"""

import argparse
import json
import os
import pathlib
import random
import tempfile

import pytest
import yaml

from kind_tpu_sim import cli as jcli
from kind_tpu_sim import config as jconfig
from kind_tpu_sim import fakes as jfakes
from kind_tpu_sim import manifest_lint as jlint
from kind_tpu_sim import manifests as jman
from kind_tpu_sim import metrics as jmetrics
from kind_tpu_sim.utils import shell as jshell
from kind_tpu_sim_torch import cli as pcli
from kind_tpu_sim_torch import config as pconfig
from kind_tpu_sim_torch import fakes as pfakes
from kind_tpu_sim_torch import manifest_lint as plint
from kind_tpu_sim_torch import manifests as pman
from kind_tpu_sim_torch import metrics as pmetrics
from kind_tpu_sim_torch import yamlsubset
from kind_tpu_sim_torch.utils import shell as pshell

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIDES = {"port": (pcli, pfakes), "reference": (jcli, jfakes)}

CREATES = {
    "tpu": ["create"],
    "tpu-2-slices": ["create", "tpu", "--num-slices", "2"],
    "tpu-v4": ["create", "tpu", "--accelerator", "tpu-v4-podslice",
               "--topology", "2x2x4"],
    "nvidia": ["create", "nvidia"],
    "nvidia-wide": ["create", "nvidia", "--gpu-workers", "3",
                    "--gpus-per-node", "8", "--registry-port", "5001",
                    "--cluster-name", "gpus"],
    "rocm": ["create", "rocm"],
    "patch": ["create", "--capacity-mode", "patch"],
    "patch-skip-plugin": ["create", "--capacity-mode", "patch",
                          "--skip-plugin"],
}


@pytest.fixture(autouse=True)
def cluster_env(monkeypatch, tmp_path):
    """A working directory of its own (``create`` writes
    ``kind-config.yaml`` there), the retry knobs unset and the podman
    runtime's environment restored afterwards."""
    monkeypatch.chdir(tmp_path)
    for name in ("KIND_TPU_SIM_MAX_RETRIES", "KIND_TPU_SIM_RETRY_BASE_MS",
                 "KIND_TPU_SIM_CMD_TIMEOUT_S", "KIND_TPU_SIM_CHAOS_SEED"):
        monkeypatch.delenv(name, raising=False)
    for name in ("KIND_EXPERIMENTAL_PROVIDER", "DOCKER_HOST"):
        monkeypatch.setenv(name, "unset")
        monkeypatch.delenv(name)


def _args(cli, argv):
    return cli.build_parser().parse_args(argv + ["--runtime", "fake"])


def _simulate(side, argv, executor=None, runtime=None):
    """Run one cluster command on ``side``'s Simulator; its executor's
    calls (argv and stdin), the kind config it wrote and the timer's
    phases."""
    cli, fakes = SIDES[side]
    args = _args(cli, argv)
    cfg = cli.config_from_args(args)
    if runtime is not None:
        cfg.runtime = runtime
    sim = cli.Simulator(cfg, executor=executor(cfg, fakes)
                        if executor else None)
    if args.command == "create":
        sim.create(skip_plugin=args.skip_plugin)
    elif args.command == "delete":
        sim.delete()
    elif args.command == "load":
        sim.load()
    elif args.command == "status":
        sim.status(as_json=args.as_json)
    else:
        sim.chaos(args.action, node=args.node, worker=args.worker,
                  devices=[d for d in args.devices.split(",") if d])
    config = pathlib.Path("kind-config.yaml")
    written = config.read_text() if config.exists() else None
    if written is not None:
        config.unlink()
    return sim.executor.calls, written, sorted(
        p.name for p in sim.timer.phases)


def _stdout(text):
    """Output without the timing lines, whose seconds vary."""
    return [ln for ln in text.splitlines()
            if not ln.startswith("  ") or "s" not in ln[-1:]]


@pytest.mark.parametrize("name", sorted(CREATES))
def test_create_streams_equal_the_reference(name, capsys):
    got = _simulate("port", CREATES[name])
    want = _simulate("reference", CREATES[name])
    assert got == want
    out = capsys.readouterr().out
    assert "kind cluster is ready" in out
    calls, config, phases = got
    assert config == want[1] and config.startswith("kind: Cluster\n")
    if name.startswith("nvidia"):
        workers = 3 if name == "nvidia-wide" else 2
        patched = [argv for argv, _ in calls
                   if argv[:3] == ["kubectl", "patch", "node"]]
        assert len(patched) == workers
        gpus = "8" if name == "nvidia-wide" else "2"
        assert all(argv[4:] == [
            "--type=json", '-p=[{"op": "add", "path": '
            f'"/status/capacity/nvidia.com~1gpu", "value": "{gpus}"}}]',
            "--subresource=status"] for argv in patched)
        labels = {tuple(argv[3:5]) for argv, _ in calls
                  if argv[:3] == ["kubectl", "label", "node"]}
        assert ("gpus-worker" if workers == 3 else "kind-tpu-sim-worker",
                "hardware-type=gpu") in labels
    clones = [argv for argv, _ in calls if argv[:2] == ["git", "clone"]]
    assert len(clones) == (name.startswith(("nvidia", "rocm")))
    assert phases == sorted(
        ["registry", "cluster-create"]
        + ([] if name == "patch-skip-plugin"
           else ["plugin-build", "plugin-deploy"]))


def _podman(cfg, fakes):
    ex = fakes.dry_run_executor(cfg)
    ex.binaries = {"podman", "kind", "kubectl"}
    return ex


@pytest.mark.parametrize("argv", [["create"], ["create", "nvidia"],
                                  ["load", "--image-name", "foo:1"]],
                         ids=["tpu", "nvidia", "load"])
def test_podman_delivery_equals_the_reference(argv, capsys, monkeypatch,
                                              tmp_path):
    """The same stream as the reference's, whose archive sits at a fixed
    name in /tmp: the port's lies in a directory of its own under the
    temporary root, removed once the archive is loaded."""
    root = tmp_path / "tmproot"
    root.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(root))
    calls, *rest = _simulate("port", argv, executor=_podman,
                             runtime="podman")
    environ = (os.environ.get("KIND_EXPERIMENTAL_PROVIDER"),
               os.environ.get("DOCKER_HOST"))
    tars = {a for cmd, _ in calls for a in cmd if a.endswith(".tar")}
    assert tars and all(pathlib.Path(t).parent.parent == root for t in tars)
    assert not any(root.iterdir())
    got = ([([f"/tmp/{pathlib.Path(a).name}" if a in tars else a
              for a in cmd], stdin) for cmd, stdin in calls], *rest)
    assert got == _simulate("reference", argv, executor=_podman,
                            runtime="podman")
    assert environ[0] == "podman" and environ[1].endswith("podman.sock")
    cmds = [" ".join(a) for a, _ in got[0]]
    assert any(c.startswith("kind load image-archive /tmp/") for c in cmds)
    assert not any(c.startswith("podman push") for c in cmds)


def _cli(cli, argv, capsys):
    rc = cli.main(argv)
    captured = capsys.readouterr()
    stream = captured.err.split("-- fake runtime command stream --\n")
    return rc, _stdout(captured.out), (stream[1] if len(stream) > 1
                                       else None)


@pytest.mark.parametrize("argv", [
    ["create", "nvidia"], ["create", "tpu", "--num-slices", "2"],
    ["delete"], ["load", "--image-name", "foo:1"], ["status", "--json"],
    ["status"], ["chaos", "fail", "--worker", "1"],
    ["chaos", "fail", "--node", "kind-tpu-sim-worker", "--devices", "a,b"],
    ["chaos", "heal", "--node", "kind-tpu-sim-worker2"],
    ["chaos", "kill-node", "--worker", "0"],
    ["chaos", "start-node", "--worker", "0"],
    ["chaos", "fail", "--worker", "3", "--num-slices", "2"],
    ["chaos", "fail", "--worker", "2"], ["chaos", "heal"],
    ["create", "--skip-plugin"],
], ids=lambda a: "-".join(a))
def test_cluster_command_equals_the_reference(argv, capsys):
    full = argv + ["--runtime", "fake", "-v"]
    got = _cli(pcli, full, capsys)
    want = _cli(jcli, full, capsys)
    assert got == want
    rc, out, stream = got
    if argv in (["chaos", "heal"], ["create", "--skip-plugin"],
                ["chaos", "fail", "--worker", "2"]):
        assert rc == 1 and stream is None
    else:
        assert rc == 0 and stream
    if argv == ["status", "--json"]:
        report = json.loads("\n".join(out))
        assert [n["name"] for n in report["nodes"]] == pfakes.node_names(
            pconfig.SimConfig())


def test_create_timing_json(capsys):
    assert pcli.main(["create", "nvidia", "--runtime", "fake",
                      "--timing-json", "t.json"]) == 0
    timing = json.loads(pathlib.Path("t.json").read_text())
    assert sorted(timing) == sorted(["registry", "cluster-create",
                                     "plugin-build", "plugin-deploy",
                                     "total"])
    assert "Simulated nvidia kind cluster is ready ('kind-tpu-sim')" in (
        capsys.readouterr().out)


def test_without_the_fake_runtime_a_missing_binary_fails(monkeypatch,
                                                         capsys):
    """No ``kind`` on the PATH: exit 1 naming it, as the reference does,
    and no fallback to the fake runtime."""
    monkeypatch.setenv("PATH", str(pathlib.Path.cwd()))
    for cli in (pcli, jcli):
        assert cli.main(["create", "nvidia"]) == 1
        assert cli.main(["status"]) == 1
    with pytest.raises(RuntimeError, match="required binary 'kind'"):
        pcli.Simulator(pconfig.SimConfig(runtime="docker"))
    with pytest.raises(RuntimeError, match="requested runtime 'podman'"):
        pcli.Simulator(pconfig.SimConfig(runtime="podman"),
                       executor=pshell.FakeExecutor(
                           binaries=["kind", "kubectl"]))


def test_the_config_refuses_what_the_reference_refuses():
    for kw in ({"vendor": "cuda"}, {"capacity_mode": "x"},
               {"runtime": "x"}, {"registry_port": 0},
               {"gpus_per_node": 0}, {"num_slices": 0}):
        with pytest.raises(ValueError) as ours:
            pconfig.SimConfig(**kw)
        with pytest.raises(ValueError) as theirs:
            jconfig.SimConfig(**kw)
        assert str(ours.value) == str(theirs.value)
    assert pconfig.VENDORS == ("tpu", "rocm", "nvidia")
    assert pconfig.RESOURCE_BY_VENDOR["nvidia"] == "nvidia.com/gpu"


# -- the manifests -----------------------------------------------------------


CONFIGS = {
    "tpu": {}, "tpu-2-slices": {"num_slices": 2},
    "v4": {"accelerator": "tpu-v4-podslice", "tpu_topology": "2x2x4"},
    "v5p-3-slices": {"accelerator": "tpu-v5p-slice",
                     "tpu_topology": "4x4x4", "num_slices": 3},
    "nvidia": {"vendor": "nvidia", "gpu_workers": 3},
    "rocm": {"vendor": "rocm"},
    "registry": {"registry_port": 5001, "registry_name": "reg"},
}


def _manifests(man, cfg):
    return {
        "kind": man.kind_cluster_config(cfg),
        "configmap": man.registry_configmap(cfg),
        "hosts.toml": man.containerd_hosts_toml(cfg),
        "tpu-plugin": man.tpu_plugin_daemonset(cfg, "localhost:5000/p:dev"),
        "nvidia-plugin": man.gpu_plugin_daemonset(cfg, "nvidia", "n:dev"),
        "rocm-plugin": man.gpu_plugin_daemonset(cfg, "rocm", "r:dev"),
    }


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cluster_manifests_equal_the_reference(name):
    got = _manifests(pman, pconfig.SimConfig(**CONFIGS[name]))
    want = _manifests(jman, jconfig.SimConfig(**CONFIGS[name]))
    assert got == want
    for key, text in got.items():
        if key != "hosts.toml":
            assert yamlsubset.load_all(text) == list(yaml.safe_load_all(text))
    assert "containerdConfigPatches:\n- |\n  [plugins." in got["kind"]
    assert "localRegistryHosting.v1: |\n    host:" in got["configmap"]
    for vendor in ("tpu", "rocm", "nvidia"):
        assert pman.plugin_app_label(vendor) == jman.plugin_app_label(vendor)
    for const in ("KUBELET_DP_DIR", "PLUGIN_APP_LABEL", "PLUGIN_NAMESPACE",
                  "SIM_STATE_DIR", "UNHEALTHY_FILE"):
        assert getattr(pman, const) == getattr(jman, const)


def test_the_gpu_pods_land_on_create_nvidia_s_nodes():
    """The port's GPU pod selects the label and tolerates the taint that
    ``create nvidia`` puts on each worker, and asks for the resource
    whose capacity it patches."""
    pod = yamlsubset.load_all(pman.torch_gpu_pod())[0]["spec"]
    calls, _, _ = _simulate("port", ["create", "nvidia"])
    cmds = [" ".join(a) for a, _ in calls]
    for key, value in pod["nodeSelector"].items():
        assert f"kubectl label node kind-tpu-sim-worker {key}={value} " \
               "--overwrite" in cmds
    for tol in pod["tolerations"]:
        assert (f"kubectl taint node kind-tpu-sim-worker {tol['key']}="
                f"{tol['value']}:{tol['effect']} --overwrite") in cmds
    limits = pod["containers"][0]["resources"]["limits"]
    assert list(limits) == ["nvidia.com/gpu"]


LITERALS = [
    {"a": "x\ny\n"},
    {"a": ["  x\n y\n", "z"], "b": 1},
    {"k": {"m": "x\n\ny", "n": "p"}},
    {"k": "a\n\n"},
    {"k": "a\n\n", "z": "q"},
    {"k": "\nfoo\n"},
    {"k": "\n"},
    ["a\nb\n", {"c": "d\ne"}],
    {"a": [{"b": "x\ny\n", "c": ["l1\nl2\n"]}]},
    {"deep": {"er": {"est": "one\n  two\n\nthree\n"}}},
]


@pytest.mark.parametrize("doc", LITERALS, ids=range(len(LITERALS)))
def test_literal_blocks_are_pyyaml_s_and_read_back(doc):
    text = yamlsubset.dump(doc)
    assert text == jman.to_yaml(doc)
    assert yamlsubset.load_all(text) == [doc]


@pytest.mark.parametrize("text", ["x \ny", "x\ty\n", "x\ny "])
def test_text_yaml_would_double_quote_is_refused(text):
    assert jman.to_yaml({"a": text}).startswith('a: "')
    with pytest.raises(ValueError, match="not written as a literal block"):
        yamlsubset.dump({"a": text})


@pytest.mark.parametrize("text", [
    "a: 1\n...\n---\nb: 2\n", "a: 1\n...\n", "a: |+\n  x\n\n...\n# c\n",
    "---\na: 1\n...\n---\n...\n", "a: 1\n...\n---\n---\nb: 2\n"])
def test_the_document_end_marker_reads_as_yaml_reads_it(text):
    assert yamlsubset.load_all(text) == list(yaml.safe_load_all(text))


def test_content_after_the_end_marker_needs_a_start_marker():
    with pytest.raises(ValueError, match="line 3: content after '...'"):
        yamlsubset.load_all("a: 1\n...\nb: 2\n")


# -- the lint ------------------------------------------------------------------


POD_FILES = sorted((ROOT / "pods").glob("*.yaml"))


@pytest.mark.parametrize("path", POD_FILES, ids=[p.name for p in POD_FILES])
def test_lint_verdicts_on_the_pods_equal_the_reference(path):
    text = path.read_text()
    assert plint.validate_yaml(text) == jlint.validate_yaml(text)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cluster_manifests_lint_clean_on_both(name):
    for text in _manifests(pman, pconfig.SimConfig(**CONFIGS[name])).values():
        if text.startswith("[host."):
            continue
        assert plint.validate_yaml(text) == jlint.validate_yaml(text) == []


BROKEN = [
    {"kind": "Pod", "apiVersion": "v2", "metadata": {"name": "Bad_Name"},
     "spec": {"containers": []}},
    {"kind": "DaemonSet", "apiVersion": "apps/v1", "metadata": {"name": ""},
     "spec": {"selector": {"matchLabels": {"a": "b"}}, "template": {
         "metadata": {"labels": {"a": "c"}}, "spec": {"containers": [{
             "name": "c", "image": "",
             "env": [{"name": "X"}, {"name": "X", "value": 1}],
             "volumeMounts": [{"name": "v"}]}]}}}},
    {"kind": "StatefulSet", "apiVersion": "apps/v1",
     "metadata": {"name": "s"}, "spec": {"replicas": -1, "selector": {},
                                         "template": {"metadata": {}, "spec": {
                                             "containers": [{
                                                 "name": "c", "image": "i",
                                                 "resources": {"limits": {
                                                     "nvidia.com/gpu": "2x"}}}]}}}},
    {"kind": "Cluster", "apiVersion": "kind.x-k8s.io/v1alpha4",
     "nodes": [{"role": "boss"}, {}]},
    {"kind": "Cluster", "apiVersion": "x", "nodes": []},
    {"kind": "Widget"},
    {"kind": "ConfigMap", "apiVersion": "v1",
     "metadata": {"name": "x", "namespace": ""}},
    {"kind": "Service", "apiVersion": "v1", "metadata": {"name": "x"},
     "spec": {"ports": {}, "clusterIP": None}},
    {"kind": "Deployment", "apiVersion": "apps/v1",
     "metadata": {"name": "d"}, "spec": {
         "replicas": 2.0, "selector": {"matchLabels": {}},
         "template": {"metadata": {}, "spec": {"containers": [
             {"name": 1, "image": "i"}]}}}},
    {"kind": "Deployment", "apiVersion": "apps/v1", "metadata": ["x"],
     "spec": {"replicas": True, "selector": {"matchLabels": {}},
              "template": {"metadata": {}, "spec": {"containers": []}}}},
]


@pytest.mark.parametrize("doc", BROKEN, ids=range(len(BROKEN)))
def test_lint_verdicts_on_broken_documents_equal_the_reference(doc):
    got = plint.validate_doc(json.loads(json.dumps(doc)))
    assert got == jlint.validate_doc(json.loads(json.dumps(doc)))
    assert got
    text = yaml.safe_dump(doc, sort_keys=False)
    assert plint.validate_yaml(text) == jlint.validate_yaml(text)


# -- the classified retry ------------------------------------------------------


FAILURES = [
    (1, "Error from server (NotFound): nodes \"x\" not found", "", "fatal"),
    (1, "dial tcp 127.0.0.1:6443: connect: connection refused", "",
     "transient"),
    (124, "", "", "transient"), (137, "killed", "", "transient"),
    (1, "etcdserver: leader changed", "", "transient"),
    (1, "invalid value; i/o timeout", "", "fatal"),
    (2, "something odd", "", "fatal"),
    (1, "", "the server is currently unable: Service Unavailable",
     "transient"),
    (1, "exec: \"kind\": executable file not found in $PATH", "", "fatal"),
    (124, "Error: unknown flag: --x", "", "fatal"),
]


@pytest.mark.parametrize("rc,err,out,want", FAILURES,
                         ids=range(len(FAILURES)))
def test_classify_failure_matches_the_reference(rc, err, out, want):
    got = pshell.classify_failure(pshell.ExecResult(rc, out, err))
    assert got == jshell.classify_failure(jshell.ExecResult(rc, out, err))
    assert got == want


@pytest.mark.parametrize("seed", [0, 7, None])
def test_run_with_retry_backs_off_as_the_reference(seed, monkeypatch):
    """The seeded backoff schedule (full jitter on exponential doubling,
    capped), the retries recorded in the recovery log and the final
    error, on both sides; an unseeded policy draws fresh jitter."""
    runs = {}
    for side, (shell, metrics) in {"port": (pshell, pmetrics),
                                   "reference": (jshell, jmetrics)}.items():
        delays = []
        monkeypatch.setattr(shell.time, "sleep", delays.append)
        left = [3]

        def respond(argv, stdin, shell=shell, left=left):
            left[0] -= 1
            if left[0] >= 0:
                return shell.ExecResult(1, "", "connection reset by peer")
            return shell.ExecResult(0, "ok")

        ex = shell.FakeExecutor(rules={"kubectl get": respond})
        policy = shell.RetryPolicy(max_retries=4, base_ms=100.0, max_ms=250.0,
                                   seed=seed)
        before = metrics.recovery_log().counts()
        res = shell.run_with_retry(ex, ["kubectl", "get", "nodes"],
                                   policy=policy)
        events = metrics.recovery_log().snapshot_since(before)
        with pytest.raises(shell.CommandError) as err:
            shell.run_with_retry(
                shell.FakeExecutor(rules={"kubectl": shell.ExecResult(
                    1, "", "i/o timeout")}), ["kubectl", "x"],
                policy=shell.RetryPolicy(max_retries=2, base_ms=1.0,
                                         seed=1))
        runs[side] = (res.stdout, len(ex.calls), events, str(err.value),
                      err.value.attempts, delays)
    got, want = runs["port"], runs["reference"]
    assert got[:5] == want[:5] == ("ok", 4, {"exec_retry": 3},
                                   want[3], 3)
    assert len(got[5]) == len(want[5]) == 5
    if seed is not None:
        assert got[5] == want[5]
    bases = [0.1, 0.2, 0.25]
    assert all(b <= d <= b + 0.1 for b, d in zip(bases, got[5]))


def test_retry_policy_from_env_matches_the_reference():
    for env in ({}, {"KIND_TPU_SIM_MAX_RETRIES": "5",
                     "KIND_TPU_SIM_RETRY_BASE_MS": "2.5",
                     "KIND_TPU_SIM_CMD_TIMEOUT_S": "1.5",
                     "KIND_TPU_SIM_CHAOS_SEED": "9"},
                {"KIND_TPU_SIM_MAX_RETRIES": "x",
                 "KIND_TPU_SIM_CHAOS_SEED": "nope"}):
        got = pshell.RetryPolicy.from_env(env)
        want = jshell.RetryPolicy.from_env(env)
        assert vars(got) == vars(want)
    policy = pshell.RetryPolicy(seed=3)
    rng_a, rng_b = random.Random(3), random.Random(3)
    assert [policy.backoff_s(i, rng_a) for i in range(8)] == [
        jshell.RetryPolicy(seed=3).backoff_s(i, rng_b) for i in range(8)]


def test_the_system_executor_runs_and_times_out():
    ex = pshell.SystemExecutor()
    assert ex.run(["sh", "-c", "echo hi; echo no >&2"]) == pshell.ExecResult(
        0, "hi\n", "no\n")
    assert not ex.run(["sh", "-c", "exit 3"], check=False).ok
    with pytest.raises(pshell.CommandError, match=r"command failed \(3\)"):
        ex.run(["sh", "-c", "exit 3"])
    late = ex.run(["sleep", "5"], check=False, timeout=0.2)
    assert late.returncode == 124
    assert pshell.classify_failure(late) == "transient"
    assert ex.run(["sh", "-c", "echo $KTS_X"], env={"KTS_X": "y"}).stdout \
        == "y\n"
    assert ex.have("sh") and not ex.have("no-such-binary-here")


def test_status_reads_capacity_and_ready_latency(capsys):
    pods = {"items": [{"status": {"conditions": [
        {"type": "PodScheduled", "status": "True",
         "lastTransitionTime": "2026-01-01T00:00:00Z"},
        {"type": "Ready", "status": "True",
         "lastTransitionTime": f"2026-01-01T00:00:{s:02d}Z"}]}}
        for s in (3, 5, 9)]}
    nodes = {"items": [{"metadata": {"name": "w", "labels": {
        "kind-tpu-sim.dev/worker-id": "0"}},
        "status": {"capacity": {"nvidia.com/gpu": "2", "cpu": "8"}}}]}
    reports = {}
    for side, (cli, fakes) in SIDES.items():
        shell = pshell if side == "port" else jshell
        cfg = cli.config_from_args(_args(cli, ["status"]))
        ex = fakes.dry_run_executor(cfg)
        ex.rules["kubectl get nodes -o json"] = shell.ExecResult(
            0, json.dumps(nodes))
        ex.rules["kubectl get pods -A -o json"] = shell.ExecResult(
            0, json.dumps(pods))
        reports[side] = (cli.Simulator(cfg, executor=ex).status(),
                         capsys.readouterr().out)
    assert reports["port"] == reports["reference"]
    assert reports["port"][0]["ready_latency"] == {
        "count": 3, "p50_s": 5.0, "max_s": 9.0, "min_s": 3.0}
    assert pmetrics.ready_latency_summary(json.dumps(pods)) == \
        jmetrics.ready_latency_summary(json.dumps(pods))


def test_phase_timer_matches_the_reference():
    ticks = iter([0.0, 1.5, 1.0, 4.0])
    t = pmetrics.PhaseTimer(clock=lambda: next(ticks))
    with t.phase("a"):
        pass
    with t.phase("b"):
        pass
    t.record("c", 0.25)
    assert t.as_dict() == {"a": 1.5, "b": 3.0, "c": 0.25, "total": 4.75}
    assert t.wall_seconds == 4.0
    assert t.overlap_saved_seconds == 0.75
    ticks2 = iter([0.0, 1.5, 1.0, 4.0])
    j = jmetrics.PhaseTimer(clock=lambda: next(ticks2))
    for name in ("a", "b"):
        with j.phase(name):
            pass
    j.record("c", 0.25)
    assert t.report() == j.report()


def test_parser_flags_are_the_reference_s():
    """Each cluster command takes the reference's flags and defaults."""
    for argv in (["create"], ["delete"], ["load", "--image-name", "i"],
                 ["status"]):
        got = vars(pcli.build_parser().parse_args(argv))
        want = vars(jcli.build_parser().parse_args(argv))
        assert got == want
    got = vars(pcli.build_parser().parse_args(["chaos", "fail"]))
    want = vars(jcli.build_parser().parse_args(["chaos", "fail"]))
    assert {k: v for k, v in got.items() if k != "device"} == want
    assert isinstance(pcli.build_parser(), argparse.ArgumentParser)
