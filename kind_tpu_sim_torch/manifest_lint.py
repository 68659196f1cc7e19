"""Schema + contract validation for every manifest the cluster layer and
the pods emit (the port's copy of ``kind_tpu_sim/manifest_lint.py``).

The source system validated its DaemonSets by actually applying them
(kind-gpu-sim.sh:279-283 blocks on rollout); a host without a cluster
splits validation in two:

1. **Pinned structural schemas**: a deliberately small,
   in-repo subset of the Kubernetes OpenAPI for the kinds we generate
   (Pod, DaemonSet, StatefulSet, Service, ConfigMap, kind Cluster).
   Pinned rather than fetched: zero-network CI, and the subset only
   asserts fields our tooling actually relies on — a schema bump is a
   reviewed diff, not a moving target.
2. **Cross-field contract checks** schemas cannot express: label
   selectors must match template labels (a mismatched DaemonSet is
   accepted by the apiserver and then controls nothing), volumeMounts
   must reference declared volumes, env names must be unique, and
   resource quantities must parse.

The machine with the card has neither ``jsonschema`` nor PyYAML, so
the port reads manifests with ``yamlsubset.load_all`` and checks the
schemas with :func:`schema_errors`, a validator of the Draft 7 keywords
these schemas use (``type``, ``required``, ``properties``, ``items``,
``const``, ``enum``, ``minLength``, ``minimum``, ``minItems``,
``pattern``): its errors, their order, paths and messages are what
``jsonschema.Draft7Validator.iter_errors`` gives (jsonschema 4.x).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, List, Tuple

from kind_tpu_sim_torch import yamlsubset

_QUANTITY = re.compile(
    r"^[0-9]+(\.[0-9]+)?(m|k|Ki|Mi|Gi|Ti|M|G|T)?$")

_META = {
    "type": "object",
    "required": ["name"],
    "properties": {
        "name": {"type": "string", "minLength": 1,
                 "pattern": r"^[a-z0-9]([-a-z0-9.]*[a-z0-9])?$"},
        "namespace": {"type": "string", "minLength": 1},
        "labels": {"type": "object"},
    },
}

_CONTAINER = {
    "type": "object",
    "required": ["name", "image"],
    "properties": {
        "name": {"type": "string", "minLength": 1},
        "image": {"type": "string", "minLength": 1},
        "env": {
            "type": "array",
            "items": {
                "type": "object",
                "required": ["name"],
                "properties": {
                    "name": {"type": "string", "minLength": 1},
                    "value": {"type": "string"},
                    "valueFrom": {"type": "object"},
                },
            },
        },
        "volumeMounts": {
            "type": "array",
            "items": {
                "type": "object",
                "required": ["name", "mountPath"],
            },
        },
        "resources": {"type": "object"},
    },
}

_POD_SPEC = {
    "type": "object",
    "required": ["containers"],
    "properties": {
        "containers": {"type": "array", "minItems": 1,
                       "items": _CONTAINER},
        "volumes": {
            "type": "array",
            "items": {"type": "object", "required": ["name"]},
        },
        "tolerations": {"type": "array"},
        "nodeSelector": {"type": "object"},
    },
}

_TEMPLATE = {
    "type": "object",
    "required": ["metadata", "spec"],
    "properties": {
        "metadata": {"type": "object"},
        "spec": _POD_SPEC,
    },
}

SCHEMAS: Dict[str, Dict[str, Any]] = {
    "Pod": {
        "type": "object",
        "required": ["apiVersion", "kind", "metadata", "spec"],
        "properties": {
            "apiVersion": {"const": "v1"},
            "metadata": _META,
            "spec": _POD_SPEC,
        },
    },
    "DaemonSet": {
        "type": "object",
        "required": ["apiVersion", "kind", "metadata", "spec"],
        "properties": {
            "apiVersion": {"const": "apps/v1"},
            "metadata": _META,
            "spec": {
                "type": "object",
                "required": ["selector", "template"],
                "properties": {
                    "selector": {
                        "type": "object",
                        "required": ["matchLabels"],
                    },
                    "template": _TEMPLATE,
                },
            },
        },
    },
    "Deployment": {
        "type": "object",
        "required": ["apiVersion", "kind", "metadata", "spec"],
        "properties": {
            "apiVersion": {"const": "apps/v1"},
            "metadata": _META,
            "spec": {
                "type": "object",
                "required": ["selector", "template"],
                "properties": {
                    "selector": {
                        "type": "object",
                        "required": ["matchLabels"],
                    },
                    "template": _TEMPLATE,
                    "replicas": {"type": "integer", "minimum": 0},
                },
            },
        },
    },
    "StatefulSet": {
        "type": "object",
        "required": ["apiVersion", "kind", "metadata", "spec"],
        "properties": {
            "apiVersion": {"const": "apps/v1"},
            "metadata": _META,
            "spec": {
                "type": "object",
                "required": ["selector", "template", "serviceName"],
                "properties": {
                    "selector": {
                        "type": "object",
                        "required": ["matchLabels"],
                    },
                    "template": _TEMPLATE,
                    "replicas": {"type": "integer", "minimum": 0},
                    "serviceName": {"type": "string"},
                },
            },
        },
    },
    "Service": {
        "type": "object",
        "required": ["apiVersion", "kind", "metadata", "spec"],
        "properties": {
            "apiVersion": {"const": "v1"},
            "metadata": _META,
            "spec": {
                "type": "object",
                "properties": {
                    "selector": {"type": "object"},
                    "ports": {"type": "array"},
                    "clusterIP": {"type": "string"},
                },
            },
        },
    },
    "ConfigMap": {
        "type": "object",
        "required": ["apiVersion", "kind", "metadata", "data"],
        "properties": {
            "apiVersion": {"const": "v1"},
            "metadata": _META,
            "data": {"type": "object"},
        },
    },
    "Cluster": {  # kind.x-k8s.io cluster config
        "type": "object",
        "required": ["kind", "apiVersion", "nodes"],
        "properties": {
            "apiVersion": {"const": "kind.x-k8s.io/v1alpha4"},
            "nodes": {
                "type": "array",
                "minItems": 1,
                "items": {
                    "type": "object",
                    "required": ["role"],
                    "properties": {
                        "role": {"enum": ["control-plane", "worker"]},
                    },
                },
            },
        },
    },
}


# -- the schema check (Draft 7, the keywords above) --------------------


def _is_type(instance: Any, kind: str) -> bool:
    """Draft 7's type checker."""
    if kind == "object":
        return isinstance(instance, dict)
    if kind == "array":
        return isinstance(instance, list)
    if kind == "string":
        return isinstance(instance, str)
    if kind == "boolean":
        return isinstance(instance, bool)
    if kind == "null":
        return instance is None
    if isinstance(instance, bool):
        return False
    if kind == "integer":
        return isinstance(instance, int) or (
            isinstance(instance, float) and instance.is_integer())
    if kind == "number":
        return isinstance(instance, (int, float))
    raise ValueError(f"unknown type {kind!r}")


def _equal(one: Any, two: Any) -> bool:
    """jsonschema's equality: bools are not numbers."""
    if isinstance(one, str) or isinstance(two, str):
        return one == two
    if isinstance(one, list) and isinstance(two, list):
        return len(one) == len(two) and all(
            _equal(a, b) for a, b in zip(one, two))
    if isinstance(one, dict) and isinstance(two, dict):
        return one.keys() == two.keys() and all(
            _equal(one[k], two[k]) for k in one)
    if isinstance(one, bool) or isinstance(two, bool):
        return type(one) is type(two) and one == two
    return one == two


def _non_empty(minimum: int, short: str) -> str:
    return "should be non-empty" if minimum == 1 else short


def _errors(schema: Dict[str, Any], instance: Any,
            path: Tuple) -> Iterator[Tuple[Tuple, str]]:
    """(path, message) of each error, in the schema's keyword order."""
    for key, value in schema.items():
        if key == "type":
            types = value if isinstance(value, list) else [value]
            if not any(_is_type(instance, t) for t in types):
                yield path, (f"{instance!r} is not of type "
                             + ", ".join(repr(t) for t in types))
        elif key == "required":
            if isinstance(instance, dict):
                for prop in value:
                    if prop not in instance:
                        yield path, f"{prop!r} is a required property"
        elif key == "properties":
            if isinstance(instance, dict):
                for prop, sub in value.items():
                    if prop in instance:
                        yield from _errors(sub, instance[prop],
                                           path + (prop,))
        elif key == "items":
            if isinstance(instance, list):
                for i, item in enumerate(instance):
                    yield from _errors(value, item, path + (i,))
        elif key == "const":
            if not _equal(instance, value):
                yield path, f"{value!r} was expected"
        elif key == "enum":
            if all(not _equal(each, instance) for each in value):
                yield path, f"{instance!r} is not one of {value!r}"
        elif key == "minLength":
            if isinstance(instance, str) and len(instance) < value:
                yield path, (f"{instance!r} "
                             + _non_empty(value, "is too short"))
        elif key == "minItems":
            if isinstance(instance, list) and len(instance) < value:
                yield path, (f"{instance!r} "
                             + _non_empty(value, "is too short"))
        elif key == "minimum":
            if _is_type(instance, "number") and instance < value:
                yield path, (f"{instance!r} is less than the minimum "
                             f"of {value!r}")
        elif key == "pattern":
            if isinstance(instance, str) and not re.search(value, instance):
                yield path, f"{instance!r} does not match {value!r}"
        else:
            raise ValueError(f"schema keyword {key!r} is not checked")


def schema_errors(schema: Dict[str, Any], doc: Any) -> List[str]:
    """Every error of ``doc`` against ``schema``, as ``path: message``
    (``<root>`` for the document itself)."""
    return [f"{'/'.join(str(p) for p in path) or '<root>'}: {message}"
            for path, message in _errors(schema, doc, ())]


def _pod_specs(doc: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
    kind = doc.get("kind")
    if kind == "Pod":
        yield doc.get("spec", {})
    elif kind in ("DaemonSet", "StatefulSet", "Deployment"):
        yield doc.get("spec", {}).get("template", {}).get("spec", {})


def _contract_errors(doc: Dict[str, Any]) -> List[str]:
    """Cross-field rules a schema can't express."""
    errs: List[str] = []
    kind = doc.get("kind")

    if kind in ("DaemonSet", "StatefulSet", "Deployment"):
        sel = (doc.get("spec", {}).get("selector", {})
               .get("matchLabels", {}))
        labels = (doc.get("spec", {}).get("template", {})
                  .get("metadata", {}).get("labels", {}))
        for key, val in sel.items():
            if labels.get(key) != val:
                errs.append(
                    f"selector {key}={val} does not match template "
                    f"labels {labels} (the controller would select "
                    "nothing)")

    for spec in _pod_specs(doc):
        declared = {v.get("name") for v in spec.get("volumes", [])}
        for c in spec.get("containers", []):
            names = [e.get("name") for e in c.get("env", [])]
            dupes = {n for n in names if names.count(n) > 1}
            if dupes:
                errs.append(
                    f"container {c.get('name')}: duplicate env "
                    f"names {sorted(dupes)}")
            for e in c.get("env", []):
                if "value" not in e and "valueFrom" not in e:
                    errs.append(
                        f"env {e.get('name')}: needs value or "
                        "valueFrom")
            for m in c.get("volumeMounts", []):
                if m.get("name") not in declared:
                    errs.append(
                        f"container {c.get('name')}: volumeMount "
                        f"{m.get('name')} has no matching volume")
            res = c.get("resources", {})
            for section in ("limits", "requests"):
                for rname, qty in res.get(section, {}).items():
                    if not _QUANTITY.match(str(qty)):
                        errs.append(
                            f"resource {rname}: bad quantity "
                            f"{qty!r}")
    return errs


def validate_doc(doc: Dict[str, Any]) -> List[str]:
    """All schema + contract errors for one manifest document
    (empty list = valid). Unknown kinds fail — every manifest the
    port emits must have a pinned schema."""
    kind = doc.get("kind")
    schema = SCHEMAS.get(kind or "")
    if schema is None:
        return [f"no pinned schema for kind {kind!r}"]
    return schema_errors(schema, doc) + _contract_errors(doc)


def validate_yaml(text: str) -> List[str]:
    """Validate every document in a (possibly multi-doc) YAML string,
    read with ``yamlsubset.load_all``."""
    errs: List[str] = []
    for i, doc in enumerate(yamlsubset.load_all(text)):
        if doc is None:
            continue
        for e in validate_doc(doc):
            errs.append(f"doc[{i}] {doc.get('kind')}: {e}")
    return errs
