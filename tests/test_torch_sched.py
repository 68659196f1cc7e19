"""PyTorch port parity: the cluster scheduler and its inventory.

The port's ``kind_tpu_sim_torch/sched/`` and ``topology.py`` against the
JAX package's ``kind_tpu_sim/sched/`` and ``topology.py``. Both
schedulers take the same request stream (the fields of the reference's
seeded ``generate_gangs``) on the same inventory and the same node,
link and failure-domain chaos, under each placement policy, and must
give the same bound placements, the same event log, the same eviction
callbacks and the same ``report()``. Preemption with its rollback,
defrag moves, gray avoid marks and chip quarantine are driven on
purpose and checked to occur. Pure Python: no model, no device.
"""

import dataclasses

import pytest

from kind_tpu_sim import sched as jsched
from kind_tpu_sim import topology as jtopo
from kind_tpu_sim_torch import sched as psched
from kind_tpu_sim_torch import topology as ptopo

PODS = (("tpu-v5-lite-podslice", "4x8"), ("tpu-v5-lite-podslice", "4x8"),
        ("tpu-v4-podslice", "2x2x4"))
SHAPES = (("tpu-v5-lite-podslice", "2x4", 4), ("tpu-v5-lite-podslice",
                                                "4x4", 3),
          ("tpu-v5-lite-podslice", "4x8", 2), ("tpu-v5-lite-podslice",
                                               "2x2", 2),
          ("tpu-v4-podslice", "2x2x2", 2))
ONE_POD = (("tpu-v5-lite-podslice", "4x8"),)


def _gangs(seed, n=30, rate=4.0, hold=(1.0, 6.0)):
    spec = jsched.SchedWorkloadSpec(n_gangs=n, gangs_per_s=rate,
                                    shapes=SHAPES, priorities=(0, 0, 1, 2),
                                    hold_s=hold)
    return [dataclasses.asdict(g) for g in jsched.generate_gangs(spec, seed)]


def _drive(mod, gangs, policy, chaos=(), rack_pods=None, max_s=40.0,
           pods=PODS, **cfg):
    """The reference's ``sched run`` loop on ``mod``'s scheduler, with
    node events (by index into the sorted node names), link events (by
    index into the sorted domains), failure-domain faults, gray avoid
    marks, chip quarantines and gray evictions at their times."""
    inv = mod.build_inventory(list(pods), rack_pods=rack_pods)
    evicted = []
    sc = mod.ClusterScheduler(inv, mod.SchedConfig(policy=policy, **cfg),
                              on_evict=lambda r: evicted.append(r.name))
    pending = [mod.SliceRequest(**g) for g in gangs]
    chaos = sorted(chaos)
    nodes = sorted(inv.nodes)
    domains = sorted(inv.domains)
    now = 0.0
    while now <= max_s:
        while chaos and chaos[0][0] <= now:
            _, action, target, param = chaos.pop(0)
            if action.startswith("node_"):
                mod.apply_node_event(sc, action, nodes[target], now)
            elif action.startswith("link_"):
                mod.apply_link_event(sc, action, domains[target], param,
                                     now)
            elif action == "domain_fault":
                fd = inv.failure_domains()[target]
                for node in inv.failure_domain_nodes(fd):
                    mod.apply_node_event(sc, "node_fail", node, now)
            elif action == "avoid":
                inv.mark_avoid(nodes[target], bool(param))
            elif action == "quarantine":
                # as the fleet's integrity quarantine: chips out of the
                # node, then its gangs evicted to rebind elsewhere
                inv.quarantine_chips(nodes[target], int(param))
                for name in sorted(sc.bound):
                    if nodes[target] in sc.bound[name].placement.node_names:
                        sc.evict_gang(name, now, reason="sdc")
            elif action == "evict":
                name = sorted(sc.bound)[target % len(sc.bound)]
                sc.evict_gang(name, now, reason="gray")
        while pending and pending[0].arrival_s <= now:
            sc.submit(pending.pop(0), now)
        sc.step(now)
        if (not pending and not sc.pending and not chaos
                and all(g.release_s is None for g in sc.bound.values())):
            break
        now = round(now + sc.cfg.cycle_s, 9)
    return {"events": sc.events, "report": sc.report(),
            "placements": sc.placement_snapshot(), "evicted": evicted,
            "failed_attempts": sc.failed_attempts,
            "failure_domains": inv.failure_domains(),
            "inventory": inv.as_dict()}


CHAOS = [(1.0, "node_drain", 3, 0.0), (1.5, "link_degrade", 1, 0.25),
         (2.0, "node_fail", 9, 0.0), (2.2, "avoid", 0, 1.0),
         (2.6, "evict", 1, 0.0),
         (3.0, "node_restore", 3, 0.0), (3.5, "link_restore", 1, 1.0),
         (4.0, "node_restore", 9, 0.0), (4.2, "avoid", 0, 0.0)]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("policy", ["ici", "binpack", "spread"])
def test_scheduler_matches_the_reference_under_chaos(policy, seed):
    gangs = _gangs(seed)
    want = _drive(jsched, gangs, policy, CHAOS)
    got = _drive(psched, gangs, policy, CHAOS)
    assert got == want
    kinds = got["report"]["event_counts"]
    for kind in ("Scheduled", "Preempted", "NodeDrained", "NodeFailed",
                 "NodeRestored", "LinkDegraded", "LinkRestored"):
        assert kinds.get(kind), kind


def test_rack_failure_domains_match_the_reference():
    gangs = _gangs(1, n=20)
    chaos = [(1.0, "domain_fault", 1, 0.0), (2.5, "node_restore", 8, 0.0)]
    want = _drive(jsched, gangs, "ici", chaos, rack_pods=1)
    got = _drive(psched, gangs, "ici", chaos, rack_pods=1)
    assert got == want
    assert got["failure_domains"] == ["rack-0", "rack-1", "rack-2"]
    assert got["report"]["event_counts"]["NodeFailed"] == 4
    for rack in got["failure_domains"]:
        assert (psched.build_inventory(list(PODS), rack_pods=1)
                .failure_domain_nodes(rack)
                == jsched.build_inventory(list(PODS), rack_pods=1)
                .failure_domain_nodes(rack))


def _fill_then(priority, topology):
    """Four low-priority single-host gangs on one 4x8 pod, then one
    gang of ``priority`` and ``topology``."""
    gangs = [dict(name=f"low-{i}", topology="2x4", priority=0,
                  arrival_s=0.0) for i in range(4)]
    gangs.append(dict(name="high", topology=topology, priority=priority,
                      arrival_s=0.5))
    return gangs


@pytest.mark.parametrize("case", ["preempts", "rolls back", "equal priority"])
def test_preemption_and_its_rollback_match_the_reference(case):
    if case == "preempts":
        gangs = _fill_then(5, "4x8")
    elif case == "rolls back":
        # 8x8 fits no 4x8 pod: evicting everything would not help
        gangs = _fill_then(5, "8x8")
    else:
        gangs = _fill_then(0, "4x8")
    want = _drive(jsched, gangs, "ici", max_s=2.0, pods=ONE_POD,
                  defrag=False)
    got = _drive(psched, gangs, "ici", max_s=2.0, pods=ONE_POD,
                 defrag=False)
    assert got == want
    kinds = got["report"]["event_counts"]
    if case == "preempts":
        assert kinds["Preempted"] == 4 and got["evicted"] == [
            "low-3", "low-2", "low-1", "low-0"]
        assert "high" in got["placements"]
    else:
        assert "Preempted" not in kinds and not got["evicted"]
        # the stuck gang's FailedScheduling is emitted once, then counted
        assert kinds["FailedScheduling"] == 1
        assert got["failed_attempts"] > 1


def test_defrag_moves_match_the_reference():
    # low gangs on hosts 0 and 3 leave two free hosts that are not a
    # contiguous 2-host block for a 4x4 (a column of 2 hosts)
    gangs = [dict(name=f"low-{i}", topology="2x4", priority=0,
                  arrival_s=0.0, hold_s=hold)
             for i, hold in enumerate((0.0, 0.5, 0.5, 0.0))]
    gangs += [dict(name="gap", topology="4x4", priority=5, arrival_s=1.0)]
    for policy in ("ici", "binpack", "spread"):
        want = _drive(jsched, gangs, policy, max_s=3.0, pods=ONE_POD,
                      preemption=False)
        got = _drive(psched, gangs, policy, max_s=3.0, pods=ONE_POD,
                     preemption=False)
        assert got == want, policy
        assert got["report"]["event_counts"]["Migrated"] == 2
        assert len(got["evicted"]) == 2
        assert "gap" in got["placements"]


def test_chip_quarantine_matches_the_reference_for_single_hosts():
    """The fleet's integrity quarantine: chips leave a node, its gangs
    rebind elsewhere, the host is avoided. Single-host gangs (the
    serving replicas' shape) place alike."""
    spec = jsched.SchedWorkloadSpec(
        n_gangs=24, gangs_per_s=6.0, shapes=(
            ("tpu-v5-lite-podslice", "2x4", 3),
            ("tpu-v5-lite-podslice", "2x2", 2)),
        priorities=(0, 1), hold_s=(0.5, 3.0))
    gangs = [dataclasses.asdict(g) for g in jsched.generate_gangs(spec, 4)]
    chaos = [(0.6, "quarantine", 1, 1.0), (1.2, "quarantine", 6, 3.0)]
    want = _drive(jsched, gangs, "ici", chaos, pods=PODS[:2])
    got = _drive(psched, gangs, "ici", chaos, pods=PODS[:2])
    assert got == want
    nodes = got["inventory"]["domains"]
    assert got["report"]["event_counts"]["Preempted"] >= 1
    assert sum(n.get("quarantined_chips", 0) for d in nodes.values()
               for n in d["nodes"]) == 4


def test_a_multi_host_gang_skips_a_quarantined_host():
    """ROADMAP C-16: the reference offers a host with quarantined chips
    to a multi-host gang as whole (free == its reduced capacity) and its
    bind raises; the port's inventory leaves that host out."""
    gangs = [dict(name="row", topology="4x4", priority=0, arrival_s=0.5)]
    chaos = [(0.0, "quarantine", 0, 1.0)]
    with pytest.raises(RuntimeError, match="bind over capacity"):
        _drive(jsched, gangs, "ici", chaos, pods=ONE_POD, max_s=1.0)
    got = _drive(psched, gangs, "ici", chaos, pods=ONE_POD, max_s=1.0)
    assert "tpu-node-0-0" not in got["placements"]["row"]["placement"][
        "nodes"]


def test_unknown_names_raise_like_the_reference():
    for mod in (jsched, psched):
        sc = mod.ClusterScheduler(mod.build_inventory(list(PODS)))
        with pytest.raises(ValueError, match="unknown node"):
            mod.apply_node_event(sc, "node_drain", "nope", 0.0)
        with pytest.raises(ValueError, match="unknown ICI domain"):
            mod.apply_link_event(sc, "link_degrade", "nope", 0.5, 0.0)
        with pytest.raises(ValueError, match="unknown policy"):
            mod.SchedConfig(policy="nope")
        sc.submit(mod.SliceRequest(name="a"), 0.0)
        with pytest.raises(ValueError, match="duplicate gang"):
            sc.submit(mod.SliceRequest(name="a"), 0.0)
    assert psched.resolve_seed() == jsched.resolve_seed() == 0
    assert psched.POLICIES == jsched.POLICIES


def test_topology_helpers_match_the_reference():
    assert ({k: dataclasses.asdict(v) for k, v in ptopo.ACCELERATORS.items()}
            == {k: dataclasses.asdict(v)
                for k, v in jtopo.ACCELERATORS.items()})
    for name in ("DEFAULT_ACCELERATOR", "DEFAULT_TOPOLOGY", "TAINT_KEY",
                 "TAINT_VALUE", "TAINT_EFFECT", "LABEL_ACCELERATOR",
                 "LABEL_TOPOLOGY", "LABEL_WORKER_ID", "LABEL_HOST_COORD",
                 "LABEL_SLICE_ID", "LABEL_HARDWARE_TYPE"):
        assert getattr(ptopo, name) == getattr(jtopo, name), name
    for acc, top in [("tpu-v5-lite-podslice", "2x2"),
                     ("tpu-v5-lite-podslice", "4x8"),
                     ("tpu-v5-lite-podslice", "8x16"),
                     ("tpu-v4-podslice", "2x2x4"),
                     ("tpu-v5p-slice", "4x4x4")]:
        p, j = ptopo.make_slice(acc, top), jtopo.make_slice(acc, top)
        for attr in ("num_chips", "num_hosts", "chips_per_host",
                     "host_grid"):
            assert getattr(p, attr) == getattr(j, attr), (top, attr)
        assert p.host_coords() == j.host_coords()
        assert ([p.node_labels(w) for w in range(p.num_hosts)]
                == [j.node_labels(w) for w in range(j.num_hosts)])
        assert ptopo.parse_topology(top) == jtopo.parse_topology(top)
        assert (ptopo.format_topology(p.dims)
                == jtopo.format_topology(j.dims) == top)
    for outer, block in [((4, 2), (2, 1)), ((2, 2, 4), (1, 2, 2)),
                         ((2, 2), (3, 1)), ((3, 3), (1, 1))]:
        pa = ptopo.enumerate_block_anchors(outer, block)
        assert pa == jtopo.enumerate_block_anchors(outer, block)
        for anchor in pa:
            assert (ptopo.block_coords(anchor, block)
                    == jtopo.block_coords(anchor, block))
    for bad in ("4x", "0x4", "axb"):
        with pytest.raises(ValueError, match="malformed"):
            ptopo.parse_topology(bad)
    with pytest.raises(ValueError, match="unknown accelerator"):
        ptopo.make_slice("tpu-v9", "2x2")
    with pytest.raises(ValueError, match="not divisible"):
        ptopo.make_slice("tpu-v5-lite-podslice", "3x4")
