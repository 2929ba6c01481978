"""Watching control plane: reconcile a directory of CRD manifests (the
port's copy of ``aigw_tpu/config/controller.py``).

Upstream's main way of operating is "apply a CRD, the gateway
reconfigures itself": a controller watches live Kubernetes objects,
reconciles them into gateway config and writes Accepted/error status
conditions back onto each object (internal/controller/controller.go:
117-330, gateway.go:89; newRouteCondition in routes.go).

Without an API server the watched source is a manifest directory —
every ``*.yaml`` / ``*.yml`` file holds CRD objects, read by
``crd.load_documents`` (JSON text where pyyaml is missing) — and the
reconcile semantics are kept:

- editing/adding/removing a manifest converges the serving config within
  the watch interval, no restart;
- every object gets a status condition (Accepted True/False with a
  reason), written to ``<dir>/aigw-status.json`` in the reference's
  format, so either package's ``status`` reads the other's file;
- a broken object quarantines only itself: the remaining objects
  compile and serve.

Kubernetes-style generation tracking: the status records the content
checksum it was computed from, so a reader can tell whether the
condition reflects the manifest they are looking at.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from typing import Any

from aigw_tpu_torch.config.crd import compile_crd_objects, load_documents
from aigw_tpu_torch.config.model import Config, ConfigError

logger = logging.getLogger(__name__)

STATUS_FILE = "aigw-status.json"

#: cross-kind order for the quarantine pass: providers before consumers,
#: and policies AFTER their targets — a broken BackendSecurityPolicy only
#: manifests once its target backend is present, so adding the policy
#: last pins the blame on the policy object, not the healthy backend.
_KIND_ORDER = [
    "Secret",
    "Backend",
    "BackendTLSPolicy",
    "InferencePool",
    "AIServiceBackend",
    "BackendSecurityPolicy",
    "GatewayConfig",
    "BackendTrafficPolicy",
    "AIGatewayRoute",
    "MCPRoute",
]
_KIND_RANK = {k: i for i, k in enumerate(_KIND_ORDER)}


def _obj_key(obj: dict[str, Any]) -> str:
    """Object identity for conditions/status. Namespace-qualified for
    non-default namespaces so same-named objects in different
    namespaces never share a verdict; the bare Kind/name
    form is kept for the default namespace — the common single-tenant
    manifest-dir case and the format `aigw status` has always shown.
    Collision-free: '/' is illegal in K8s names."""
    kind = obj.get("kind", "?")
    meta = obj.get("metadata") or {}
    name = meta.get("name", "?")
    ns = meta.get("namespace") or "default"
    return f"{kind}/{name}" if ns == "default" else f"{kind}/{ns}/{name}"


def _obj_checksum(obj: dict[str, Any]) -> str:
    blob = json.dumps(obj, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


class Reconciler:
    """Scan a manifest directory → (Config, per-object status conditions).

    ``load()`` is the ConfigWatcher loader: it compiles the directory and
    writes the status file as a side effect, raising only when *nothing*
    servable could be compiled (startup must fail loudly; a partial
    manifest set serves the accepted subset).
    """

    def __init__(self, directory: str, status_path: str | None = None):
        self.directory = directory
        self.status_path = status_path or os.path.join(
            directory, STATUS_FILE)
        # accepted-state memory so lastTransitionTime only moves on flips
        self._conditions: dict[str, dict[str, Any]] = {}

    # -- manifest scanning -------------------------------------------------

    def _manifest_files(self) -> list[str]:
        try:
            names = sorted(os.listdir(self.directory))
        except FileNotFoundError:
            raise ConfigError(
                f"manifest directory {self.directory!r} does not exist"
            ) from None
        return [
            os.path.join(self.directory, n)
            for n in names
            if n.endswith((".yaml", ".yml")) and not n.startswith(".")
        ]

    def _read_objects(
        self,
    ) -> tuple[list[dict[str, Any]], dict[str, str]]:
        """All CRD objects across the directory, plus per-file parse
        errors (a torn file quarantines that file, not the directory)."""
        objects: list[dict[str, Any]] = []
        file_errors: dict[str, str] = {}
        for path in self._manifest_files():
            try:
                with open(path, "r", encoding="utf-8") as f:
                    docs = load_documents(f.read(), repr(path))
            except Exception as e:  # noqa: BLE001 — yaml errors vary
                file_errors[os.path.basename(path)] = (
                    f"{type(e).__name__}: {e}")
                continue
            for d in docs:
                if isinstance(d, dict) and d.get("kind"):
                    objects.append(d)
        objects.sort(key=lambda o: _KIND_RANK.get(o.get("kind", ""), 99))
        return objects, file_errors

    # -- compile with per-object quarantine --------------------------------

    @staticmethod
    def _compile(objs: list[dict[str, Any]]) -> Config:
        cfg = Config.parse(compile_crd_objects(objs))
        cfg.validate()
        return cfg

    def _reconcile(
        self, objects: list[dict[str, Any]]
    ) -> tuple[Config, dict[str, str]]:
        """Compile, quarantining objects that break the compile.

        Admission first: the reference's CRD CEL rules run on every
        object (config.admission); an object an API server would refuse
        at apply time is NotAccepted with the rule's message. Then the
        fast path: everything compiles together. Slow path (something is
        broken): add objects one at a time in dependency order, keeping
        the growing good set — each rejected object is blamed with its
        own error. N+1 compiles of small dicts; only runs on bad input.
        """
        from aigw_tpu_torch.config import admission, refgrant

        errors: dict[str, str] = {}
        # cross-object admission: ReferenceGrant enforcement for
        # cross-namespace backendRefs (reference referencegrant.go)
        grant_errors = refgrant.validate(objects)
        admitted: list[dict[str, Any]] = []
        for obj in objects:
            errs = admission.validate(obj)
            key = _obj_key(obj)
            if key in grant_errors:
                errs = list(errs) + [grant_errors[key]]
            if errs:
                errors[key] = "; ".join(errs)
            else:
                admitted.append(obj)
        objects = admitted
        try:
            return self._compile(objects), errors
        except Exception:  # noqa: BLE001 — find the offenders
            pass
        good: list[dict[str, Any]] = []
        for obj in objects:
            try:
                self._compile(good + [obj])
            except Exception as e:  # noqa: BLE001
                errors[_obj_key(obj)] = f"{type(e).__name__}: {e}"
                continue
            good.append(obj)
        return self._compile(good), errors

    # -- status conditions -------------------------------------------------

    def _update_conditions(
        self,
        objects: list[dict[str, Any]],
        errors: dict[str, str],
        file_errors: dict[str, str],
    ) -> bool:
        """Refresh conditions; True when anything actually changed."""
        now = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        fresh: dict[str, dict[str, Any]] = {}
        for obj in objects:
            key = _obj_key(obj)
            err = errors.get(key, "")
            cond = {
                "type": "Accepted",
                "status": "False" if err else "True",
                "reason": "NotAccepted" if err else "Accepted",
                "message": err or "object compiled into the serving config",
            }
            prev = self._conditions.get(key)
            if prev is not None and prev["status"] == cond["status"]:
                cond["lastTransitionTime"] = prev["lastTransitionTime"]
            else:
                cond["lastTransitionTime"] = now
            cond["observedChecksum"] = _obj_checksum(obj)
            fresh[key] = cond
        for fname, err in file_errors.items():
            key = f"file/{fname}"
            prev = self._conditions.get(key)
            fresh[key] = {
                "type": "Accepted",
                "status": "False",
                "reason": "ParseError",
                "message": err,
                "lastTransitionTime": (
                    prev["lastTransitionTime"]
                    if prev is not None and prev["status"] == "False"
                    else now
                ),
            }
        changed = fresh != self._conditions
        self._conditions = fresh
        return changed

    def _write_status(self) -> None:
        payload = {
            "apiVersion": "aigateway.envoyproxy.io/v1alpha1",
            "kind": "StatusReport",
            "objects": self._conditions,
        }
        tmp = f"{self.status_path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.status_path)
        except OSError as e:
            logger.warning("status write failed: %s", e)

    def conditions(self) -> dict[str, dict[str, Any]]:
        """Per-object Accepted conditions from the last load() —
        ``{key: {status, reason, message, ...}}``. Public accessor for
        the CLI/status surfaces (the reference exposes the same data as
        `kubectl get` conditions on each object)."""
        return dict(self._conditions)

    def not_accepted(self) -> dict[str, dict[str, Any]]:
        """Subset of conditions() whose status is not \"True\"."""
        return {k: c for k, c in self._conditions.items()
                if c.get("status") != "True"}

    # -- watcher loader ----------------------------------------------------

    def load(self) -> Config:
        objects, file_errors = self._read_objects()
        cfg, errors = self._reconcile(objects)
        # write + log only on transitions: the watcher ticks every few
        # seconds and a persistently broken object must not churn the
        # status file's mtime or spam the log (the reference writes
        # conditions only when they change)
        if self._update_conditions(objects, errors, file_errors):
            self._write_status()
            for key, err in {**errors,
                             **{f"file/{f}": e
                                for f, e in file_errors.items()}}.items():
                logger.warning("reconcile: %s NOT accepted: %s", key, err)
        return cfg


def is_manifest_dir(path: str) -> bool:
    """A directory of CRD manifests (vs a sharded config bundle, which
    carries an index.json)."""
    if not os.path.isdir(path):
        return False
    if os.path.exists(os.path.join(path, "index.json")):
        return False
    try:
        return any(
            n.endswith((".yaml", ".yml")) and not n.startswith(".")
            for n in os.listdir(path)
        )
    except OSError:
        return False
