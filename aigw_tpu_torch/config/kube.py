"""Live Kubernetes source for the reconciling control plane (the port's
copy of ``aigw_tpu/config/kube.py``).

The gateway's primary deployment mode: list/watch the AI Gateway CRDs on
an API server, converge the serving config, and write Accepted
conditions back onto each object's status (upstream's controller,
internal/controller/controller.go:117-330; ``kubectl get`` shows the
conditions). The manifest-directory mode (``config/controller.py``)
stays the default; this source is selected with ``run kube:<kubeconfig>``
or ``kube:in-cluster``.

No Kubernetes client library: the API surface needed is four HTTP verbs
against a stable REST layout, carried by the port's standard-library
client (``gateway/http.py``) with the cluster's TLS settings:

- ``load_kubeconfig`` / ``in_cluster_auth``: auth material (bearer
  token, client certificate, CA bundle) from the standard locations; a
  kubeconfig is read through ``crd.load_documents`` (pyyaml where
  installed, else JSON text).
- ``KubeClient.list_resource`` / ``watch_resource``: ``GET
  /apis/{g}/{v}/{plural}`` and the same with ``?watch=true&
  resourceVersion=``, a stream of JSON lines, the protocol ``kubectl get
  -w`` speaks.
- ``KubeClient.patch_status``: ``PATCH .../{name}/status`` with
  ``application/merge-patch+json``.

``KubeSource`` runs the watches on a thread and event loop of its own
and keeps an object cache; ``KubeReconciler`` feeds that cache through
the Reconciler (admission, compile, quarantine, conditions) and patches
per-object conditions back, from the replica that holds the status
writer's Lease (``LeaderElector``) only. The Lease's wire is the
reference's, so gateways of either package on one cluster elect one
writer between them.
"""

from __future__ import annotations

import asyncio
import base64
import calendar
import json
import logging
import os
import socket
import ssl
import tempfile
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Callable

from aigw_tpu_torch.gateway.http import ClientError, ClientResponse, HTTPClient

logger = logging.getLogger(__name__)

#: kind → (group, version, plural, namespaced): upstream's CRD groups
#: (api/v1alpha1; gateway.envoyproxy.io for Backend; gateway-api and the
#: inference extension for the imported kinds)
RESOURCES: dict[str, tuple[str, str, str, bool]] = {
    "AIGatewayRoute": (
        "aigateway.envoyproxy.io", "v1alpha1", "aigatewayroutes", True),
    "AIServiceBackend": (
        "aigateway.envoyproxy.io", "v1alpha1", "aiservicebackends", True),
    "BackendSecurityPolicy": (
        "aigateway.envoyproxy.io", "v1alpha1",
        "backendsecuritypolicies", True),
    "MCPRoute": (
        "aigateway.envoyproxy.io", "v1alpha1", "mcproutes", True),
    "GatewayConfig": (
        "aigateway.envoyproxy.io", "v1alpha1", "gatewayconfigs", True),
    "QuotaPolicy": (
        "aigateway.envoyproxy.io", "v1alpha1", "quotapolicies", True),
    "Backend": (
        "gateway.envoyproxy.io", "v1alpha1", "backends", True),
    "BackendTLSPolicy": (
        "gateway.networking.k8s.io", "v1alpha3",
        "backendtlspolicies", True),
    "InferencePool": (
        "inference.networking.x-k8s.io", "v1alpha2",
        "inferencepools", True),
    "ReferenceGrant": (
        "gateway.networking.k8s.io", "v1beta1", "referencegrants", True),
    "Secret": ("", "v1", "secrets", True),
}

#: kinds whose status the gateway owns (Accepted conditions are written
#: only on its own API group's objects)
STATUS_KINDS = {
    "AIGatewayRoute", "AIServiceBackend", "BackendSecurityPolicy",
    "MCPRoute", "GatewayConfig", "QuotaPolicy",
}


def resource_path(kind: str, namespace: str = "", name: str = "") -> str:
    group, version, plural, namespaced = RESOURCES[kind]
    prefix = f"/apis/{group}/{version}" if group else f"/api/{version}"
    if namespace and namespaced:
        path = f"{prefix}/namespaces/{namespace}/{plural}"
    else:
        path = f"{prefix}/{plural}"  # cluster-wide (all namespaces)
    if name:
        path += f"/{name}"
    return path


@dataclass
class KubeAuth:
    server: str
    token: str = ""
    ca_data: bytes | None = None
    client_cert: tuple[str, str] | None = None  # (cert path, key path)
    insecure: bool = False

    def ssl_context(self) -> ssl.SSLContext | bool:
        if self.server.startswith("http://"):
            return False  # plain HTTP (tests, port-forwards)
        ctx = ssl.create_default_context()
        if self.ca_data:
            ctx.load_verify_locations(cadata=self.ca_data.decode())
        if self.client_cert:
            ctx.load_cert_chain(*self.client_cert)
        if self.insecure:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        return ctx


def _b64_to_tempfile(data: str, suffix: str) -> str:
    # the file outlives the process, as the reference's does: ssl reads
    # a certificate chain from a path
    f = tempfile.NamedTemporaryFile("wb", suffix=suffix, delete=False)
    f.write(base64.b64decode(data))
    f.close()
    return f.name


def load_kubeconfig(path: str) -> KubeAuth:
    """Parse the standard kubeconfig: current-context → cluster + user.
    Supports token, tokenFile, client-certificate(-data) and
    certificate-authority(-data)."""
    from aigw_tpu_torch.config.crd import load_documents

    with open(path, encoding="utf-8") as f:
        docs = load_documents(f.read(), f"kubeconfig {path}")
    doc = (docs[0] if docs else None) or {}
    ctx_name = doc.get("current-context", "")
    contexts = {c["name"]: c["context"] for c in doc.get("contexts", [])}
    clusters = {c["name"]: c["cluster"] for c in doc.get("clusters", [])}
    users = {u["name"]: u.get("user", {}) for u in doc.get("users", [])}
    if ctx_name not in contexts:
        raise ValueError(f"kubeconfig {path}: no context {ctx_name!r}")
    ctx = contexts[ctx_name]
    cluster = clusters.get(ctx.get("cluster", ""), {})
    user = users.get(ctx.get("user", ""), {})
    server = cluster.get("server", "")
    if not server:
        raise ValueError(f"kubeconfig {path}: cluster has no server")
    ca_data = None
    if cluster.get("certificate-authority-data"):
        ca_data = base64.b64decode(cluster["certificate-authority-data"])
    elif cluster.get("certificate-authority"):
        with open(cluster["certificate-authority"], "rb") as f:
            ca_data = f.read()
    token = user.get("token", "")
    if not token and user.get("tokenFile"):
        with open(user["tokenFile"], encoding="utf-8") as f:
            token = f.read().strip()
    client_cert = None
    if user.get("client-certificate-data") and user.get("client-key-data"):
        client_cert = (
            _b64_to_tempfile(user["client-certificate-data"], ".crt"),
            _b64_to_tempfile(user["client-key-data"], ".key"),
        )
    elif user.get("client-certificate") and user.get("client-key"):
        client_cert = (user["client-certificate"], user["client-key"])
    return KubeAuth(
        server=server.rstrip("/"), token=token, ca_data=ca_data,
        client_cert=client_cert,
        insecure=bool(cluster.get("insecure-skip-tls-verify")),
    )


_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def in_cluster_auth() -> KubeAuth:
    host = os.environ.get("KUBERNETES_SERVICE_HOST", "")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    if not host:
        raise ValueError("not running in-cluster "
                         "(KUBERNETES_SERVICE_HOST unset)")
    # AIGW_SA_DIR points the token and CA mount elsewhere: a sidecar's
    # real `run kube:in-cluster` args then run against a local TLS API
    # server (the role upstream's envtest plays)
    sa_dir = os.environ.get("AIGW_SA_DIR", _SA_DIR)
    with open(f"{sa_dir}/token", encoding="utf-8") as f:
        token = f.read().strip()
    with open(f"{sa_dir}/ca.crt", "rb") as f:
        ca = f.read()
    return KubeAuth(server=f"https://{host}:{port}", token=token,
                    ca_data=ca)


class KubeAPIError(ClientError):
    """The API server answered an error status."""

    def __init__(self, status: int, url: str):
        super().__init__(f"{status}, url={url!r}")
        self.status = status


class KubeClient:
    """REST client for the subset of the API the reconciler needs: one
    ``HTTPClient`` with the cluster's TLS context, made on first use."""

    def __init__(self, auth: KubeAuth):
        self.auth = auth
        self._http: HTTPClient | None = None

    def _headers(self) -> dict[str, str]:
        h = {"accept": "application/json"}
        if self.auth.token:
            h["authorization"] = f"Bearer {self.auth.token}"
        return h

    def session(self) -> HTTPClient:
        if self._http is None or self._http.closed:
            ctx = self.auth.ssl_context()
            self._http = HTTPClient(ssl_context=ctx or None)
        return self._http

    async def close(self) -> None:
        if self._http is not None and not self._http.closed:
            self._http.close()

    async def _open(self, method: str, url: str, body: Any = None,
                   content_type: str = "application/json"
                   ) -> ClientResponse:
        """One request with the client's headers (``body`` sent as
        JSON); the response is the caller's to read and release."""
        headers = self._headers()
        data = b""
        if body is not None:
            data = json.dumps(body).encode()
            headers["content-type"] = content_type
        return await self.session().request(method, url, data=data,
                                            headers=headers)

    async def call(self, method: str, url: str, body: Any = None,
                   content_type: str = "application/json"
                   ) -> tuple[int, bytes]:
        """One request read whole: (status, body)."""
        async with await self._open(method, url, body, content_type) as r:
            return r.status, await r.read()

    async def list_resource(
        self, kind: str,
    ) -> tuple[list[dict], str, bool]:
        """(objects cluster-wide, list resourceVersion the watch starts
        from, CRD-installed flag)."""
        url = self.auth.server + resource_path(kind)
        status, raw = await self.call("GET", url)
        if status == 404:
            # CRD not installed: empty and not installed, not fatal; the
            # caller polls slowly instead of hot-looping a watch on a
            # missing resource
            return [], "", False
        if status >= 400:
            raise KubeAPIError(status, url)
        body = json.loads(raw)
        items = body.get("items") or []
        for item in items:
            item.setdefault("kind", kind)
            gv = RESOURCES[kind]
            item.setdefault(
                "apiVersion", f"{gv[0]}/{gv[1]}" if gv[0] else gv[1])
        rv = (body.get("metadata") or {}).get("resourceVersion", "")
        return items, rv, True

    async def watch_resource(
        self, kind: str, resource_version: str,
        on_event: Callable[[str, dict], None],
    ) -> None:
        """One watch stream; returns when the server closes it (the
        caller re-lists and watches again: the standard watch loop)."""
        url = (self.auth.server + resource_path(kind)
               + f"?watch=true&resourceVersion={resource_version}"
               + "&allowWatchBookmarks=true")
        async with await self._open("GET", url) as resp:
            if resp.status >= 400:
                raise KubeAPIError(resp.status, url)
            buf = b""
            async for chunk in resp.iter_any():
                buf += chunk
                while b"\n" in buf:
                    line, _, buf = buf.partition(b"\n")
                    line = line.strip()
                    if not line:
                        continue  # a heartbeat
                    try:
                        ev = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    etype = ev.get("type", "")
                    obj = ev.get("object") or {}
                    if etype == "BOOKMARK":
                        continue
                    if etype == "ERROR" or etype not in (
                            "ADDED", "MODIFIED", "DELETED"):
                        # an in-stream error (410 Gone: an expired
                        # resourceVersion) carries a Status object that
                        # must never enter the cache: end the stream so
                        # the caller re-lists
                        raise RuntimeError(
                            f"watch {kind}: server sent "
                            f"{etype or 'untyped'} event")
                    on_event(etype, obj)

    async def patch_status(self, obj: dict,
                           conditions: list[dict]) -> bool:
        """Merge-patch Accepted conditions onto the object's /status
        (upstream's status writeback)."""
        kind = obj.get("kind", "")
        meta = obj.get("metadata") or {}
        path = resource_path(
            kind, meta.get("namespace", ""), meta.get("name", ""))
        status, _ = await self.call(
            "PATCH", self.auth.server + path + "/status",
            {"status": {"conditions": conditions}},
            "application/merge-patch+json")
        if status >= 400:
            logger.warning("status patch %s/%s -> %d", kind,
                           meta.get("name", ""), status)
            return False
        return True


class KubeSource:
    """Object cache fed by list+watch on a dedicated thread. The
    reconcile loop reads a consistent snapshot through ``objects()``;
    status patches go back through ``submit()`` onto the same loop."""

    def __init__(self, auth: KubeAuth,
                 kinds: tuple[str, ...] | None = None):
        self.auth = auth
        self.kinds = tuple(kinds or RESOURCES)
        self._cache: dict[tuple[str, str, str], dict] = {}
        self._lock = threading.Lock()
        self._synced = threading.Event()
        self._stopping = threading.Event()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._client: KubeClient | None = None
        self._synced_kinds: set[str] = set()
        self._listeners: list[Callable[[str, dict], None]] = []
        #: what ``submit`` runs, held until done: the loop keeps tasks
        #: only weakly, and a request's connection holds its task only
        #: in a cycle the collector may reclaim mid-request
        self._submitted: set = set()
        self.generation = 0  # bumped on every cache change

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="kube-source", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stopping.set()
        if self._loop is not None:
            self._loop.call_soon_threadsafe(lambda: None)  # wake
        if self._thread is not None:
            self._thread.join(timeout=10)

    def wait_synced(self, timeout: float = 30.0) -> bool:
        return self._synced.wait(timeout)

    def _run(self) -> None:
        asyncio.run(self._main())

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._client = KubeClient(self.auth)
        try:
            tasks = [
                asyncio.create_task(self._kind_loop(kind),
                                    name=f"watch-{kind}")
                for kind in self.kinds
            ]
            while not self._stopping.is_set():
                await asyncio.sleep(0.2)
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
        finally:
            await self._client.close()

    def _notify(self, listeners: list, etype: str, obj: dict) -> None:
        for fn in listeners:
            try:
                fn(etype, obj)
            except Exception:  # noqa: BLE001 — a handler must not
                logger.exception("informer handler failed")  # kill watch

    async def _kind_loop(self, kind: str) -> None:
        """list → watch → (on the stream's close or error) re-list,
        until stopped. A kind whose CRD is not installed is listed again
        every 30 s instead of watched."""
        while not self._stopping.is_set():
            try:
                items, rv, installed = \
                    await self._client.list_resource(kind)
                with self._lock:
                    # the resync delta for listeners (client-go replays
                    # the gap on a re-list: informers must not miss
                    # objects created or deleted while the watch was down)
                    old = {k: v for k, v in self._cache.items()
                           if k[0] == kind}
                    new = {self._key(item): item for item in items}
                    for key in old:
                        del self._cache[key]
                    self._cache.update(new)
                    self.generation += 1
                    listeners = list(self._listeners)
                for key, obj in old.items():
                    if key not in new:
                        self._notify(listeners, "DELETED", obj)
                for key, obj in new.items():
                    prev = old.get(key)
                    if prev != obj:
                        self._notify(listeners, "ADDED" if prev is None
                                     else "MODIFIED", obj)
                self._synced_kinds.add(kind)
                if self._synced_kinds >= set(self.kinds):
                    self._synced.set()
                if not installed:
                    await asyncio.sleep(30.0)
                    continue
                await self._client.watch_resource(kind, rv, self._event)
            except asyncio.CancelledError:
                return
            except Exception as e:  # noqa: BLE001 — network flaps
                logger.warning("watch %s failed: %s; re-listing", kind, e)
                await asyncio.sleep(1.0)

    @staticmethod
    def _key(obj: dict) -> tuple[str, str, str]:
        meta = obj.get("metadata") or {}
        return (obj.get("kind", ""), meta.get("namespace", ""),
                meta.get("name", ""))

    def _event(self, etype: str, obj: dict) -> None:
        if not obj.get("kind"):
            return
        with self._lock:
            if etype == "DELETED":
                self._cache.pop(self._key(obj), None)
            else:  # ADDED / MODIFIED
                self._cache[self._key(obj)] = obj
            self.generation += 1
            listeners = list(self._listeners)
        # the informer hook (the generated <Kind>Informer classes), on
        # the watch thread after the cache applied the event
        self._notify(listeners, etype, obj)

    def add_listener(self, fn: Callable[[str, dict], None]) -> None:
        """Subscribe to (event_type, object) pairs: the informer contract
        over the shared watch."""
        with self._lock:
            self._listeners.append(fn)

    # -- reconcile-side API ----------------------------------------------
    def objects(self) -> list[dict]:
        with self._lock:
            return [dict(o) for o in self._cache.values()]

    def submit(self, coro) -> None:
        """Run a coroutine on the source loop (status patches)."""
        if self._loop is not None and not self._stopping.is_set():
            fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
            self._submitted.add(fut)
            fut.add_done_callback(self._submitted.discard)
        else:
            coro.close()

    @property
    def client(self) -> KubeClient:
        if self._client is None:
            raise RuntimeError("the kube source has not started")
        return self._client


def _pod_namespace() -> str:
    """The pod's own namespace in a cluster (a Role there is enough for
    the election Lease), else "default"; read from the same mount as
    ``in_cluster_auth`` (``AIGW_SA_DIR``)."""
    sa_dir = os.environ.get("AIGW_SA_DIR", _SA_DIR)
    try:
        with open(f"{sa_dir}/namespace", encoding="utf-8") as f:
            return f.read().strip() or "default"
    except OSError:
        return "default"


class KubeReconciler:
    """The Reconciler's admission → compile → quarantine → conditions
    pipeline (``config/controller.py``) fed from a ``KubeSource`` cache
    instead of a manifest directory, with each condition written back
    onto the object's ``status.conditions`` through the API (upstream's
    controller, controller.go:117-330)."""

    def __init__(self, source: KubeSource,
                 status_path: str | None = None,
                 leader_election: bool | None = None,
                 dry_run: bool = False):
        from aigw_tpu_torch.config.controller import Reconciler

        self.source = source
        # leader election (on unless AIGW_LEADER_ELECTION=off): every
        # replica serves from its watch cache, only the Lease holder
        # patches status (controller-runtime's split); a single replica
        # elects itself
        if leader_election is None:
            leader_election = os.environ.get(
                "AIGW_LEADER_ELECTION", "").lower() != "off"
        self._elector: LeaderElector | None = None
        if leader_election:
            self._elector = LeaderElector(
                source.client,
                lease_name=os.environ.get(
                    "AIGW_LEASE_NAME", "aigw-tpu-status-writer"),
                namespace=os.environ.get("AIGW_LEASE_NAMESPACE",
                                         _pod_namespace()),
            )
            source.submit(self._elector.run())
        if status_path is None:
            # one file per instance: two gateways on one host must not
            # share a predictable name
            fd, status_path = tempfile.mkstemp(
                prefix="aigw-kube-status-", suffix=".json")
            os.close(fd)
        # a Reconciler whose file-reading entry points are bypassed; it
        # keeps the condition memory and writes the status file
        self._rec = Reconciler(directory=".", status_path=status_path)
        self._dry_run = dry_run
        self._patched: dict[str, str] = {}  # key → last patched stamp

    def conditions(self) -> dict[str, dict[str, Any]]:
        return self._rec.conditions()

    def not_accepted(self) -> dict[str, dict[str, Any]]:
        return self._rec.not_accepted()

    def shutdown(self) -> None:
        """Stop the election loop and surrender the Lease now (the renew
        loop may be mid-sleep), so a peer takes over at once instead of
        after leaseDurationSeconds."""
        if self._elector is not None:
            self._elector.stop()
            self.source.submit(self._elector.release())

    def load(self):
        """Compile the current cluster state; patch changed conditions
        back onto the objects (the status subresource, merge-patch)."""
        from aigw_tpu_torch.config.controller import _KIND_RANK, _obj_key

        objects = self.source.objects()
        objects.sort(key=lambda o: _KIND_RANK.get(o.get("kind", ""), 99))
        cfg, errors = self._rec._reconcile(objects)
        if self._rec._update_conditions(objects, errors, {}):
            self._rec._write_status()
        conds = self._rec.conditions()
        if self._dry_run:
            return cfg  # validate: report, never write onto the cluster
        if self._elector is not None and not self._elector.is_leader:
            # not the leader: serve, and leave status writing (and the
            # patched stamps) to whoever is; unpatched conditions go out
            # if leadership moves here
            return cfg
        for obj in objects:
            kind = obj.get("kind", "")
            if kind not in STATUS_KINDS:
                continue
            key = _obj_key(obj)
            cond = conds.get(key)
            if cond is None:
                continue
            # patch only a condition not yet pushed for the object's
            # content: else every tick patches again, and the watch
            # event of our own patch triggers the next
            stamp = cond.get("observedChecksum", "") + cond["status"]
            if self._patched.get(key) == stamp:
                continue
            # stamped before the patch (dedupes the in-flight window),
            # cleared on failure so the next tick retries
            self._patched[key] = stamp
            k8s_cond = {
                "type": "Accepted",
                "status": cond["status"],
                "reason": cond["reason"],
                "message": cond["message"],
                "lastTransitionTime": cond["lastTransitionTime"],
                "observedGeneration": (
                    (obj.get("metadata") or {}).get("generation", 0)),
            }
            self.source.submit(
                self._patch_with_retry(obj, k8s_cond, key, stamp))
        return cfg

    async def _patch_with_retry(self, obj: dict, cond: dict, key: str,
                                stamp: str) -> None:
        try:
            ok = await self.source.client.patch_status(obj, [cond])
        except Exception as e:  # noqa: BLE001 — network flaps
            logger.warning("status patch %s failed: %s", key, e)
            ok = False
        if not ok and self._patched.get(key) == stamp:
            del self._patched[key]


def parse_kube_target(target: str) -> KubeAuth:
    """``kube:<kubeconfig-path>`` / ``kube:in-cluster`` / bare ``kube:``
    (KUBECONFIG, else ~/.kube/config, else in-cluster)."""
    spec = target[len("kube:"):] if target.startswith("kube:") else target
    if spec == "in-cluster":
        return in_cluster_auth()
    if not spec:
        spec = os.environ.get("KUBECONFIG", "")
        if not spec:
            default = os.path.expanduser("~/.kube/config")
            if os.path.exists(default):
                spec = default
            else:
                return in_cluster_auth()
    return load_kubeconfig(spec)


# ---------------------------------------------------------------------------
# Leader election (coordination.k8s.io Leases)
# ---------------------------------------------------------------------------

LEASE_PATH = "/apis/coordination.k8s.io/v1/namespaces/{ns}/leases"


class LeaderElector:
    """Lease-based leader election (controller-runtime's, upstream's
    cmd/controller/main.go): every gateway replica in kube mode serves
    from its watch cache; only the Lease holder patches object status.

    Protocol (client-go's): acquire the Lease if absent or expired
    (renewTime + leaseDuration < now), renew every ``renew_seconds``
    while held, surrender on stop. Clock skew is absorbed by the gap
    between the duration and the renew period."""

    def __init__(self, client: KubeClient, *, lease_name: str,
                 namespace: str = "default", identity: str = "",
                 lease_seconds: float = 15.0, renew_seconds: float = 5.0):
        self.client = client
        self.lease_name = lease_name
        self.namespace = namespace
        self.identity = identity or (
            f"{socket.gethostname()}_{uuid.uuid4().hex[:8]}")
        self.lease_seconds = lease_seconds
        self.renew_seconds = renew_seconds
        self._leader = False
        self._stopping = False
        self._valid_until = 0.0  # when the Lease we hold expires

    @property
    def is_leader(self) -> bool:
        return self._leader

    def _became_leader(self) -> None:
        self._leader = True
        self._valid_until = time.time() + self.lease_seconds

    def _lease_url(self, name: str = "") -> str:
        url = (self.client.auth.server
               + LEASE_PATH.format(ns=self.namespace))
        return f"{url}/{name}" if name else url

    @staticmethod
    def _now() -> str:
        return time.strftime("%Y-%m-%dT%H:%M:%S.000000Z", time.gmtime())

    @staticmethod
    def _parse_micro_time(value: str) -> float:
        try:
            base, _, frac = value.partition(".")
            # RFC 3339 at whole seconds carries the Z on the base
            # ("...T12:00:00Z"): a parse failure would read as expired
            # and elect a second writer
            secs = calendar.timegm(
                time.strptime(base.rstrip("Zz"), "%Y-%m-%dT%H:%M:%S"))
            frac = frac.rstrip("Zz")
            if frac.isdigit():
                secs += float(f"0.{frac}")
            return secs
        except (ValueError, AttributeError):
            return 0.0

    async def try_acquire(self) -> bool:
        """One acquire or renew attempt; updates ``is_leader``. A
        transient failure does not demote while our own Lease is still
        valid."""
        try:
            status, raw = await self.client.call(
                "GET", self._lease_url(self.lease_name))
            if status == 404:
                body = {
                    "apiVersion": "coordination.k8s.io/v1",
                    "kind": "Lease",
                    "metadata": {"name": self.lease_name,
                                 "namespace": self.namespace},
                    "spec": self._spec(acquisitions=1),
                }
                status, _ = await self.client.call(
                    "POST", self._lease_url(), body)
                if status < 300:
                    self._became_leader()
                else:
                    self._leader = False
                return self._leader
            if status >= 400:
                raise KubeAPIError(status, self._lease_url(self.lease_name))
            lease = json.loads(raw)
            spec = lease.get("spec") or {}
            holder = spec.get("holderIdentity", "")
            renew = self._parse_micro_time(
                spec.get("renewTime", "") or spec.get("acquireTime", ""))
            duration = float(spec.get("leaseDurationSeconds",
                                      self.lease_seconds))
            expired = renew + duration < time.time()
            if holder != self.identity and not expired:
                self._leader = False
                return False
            acquisitions = int(spec.get("leaseTransitions", 0) or 0)
            if holder != self.identity:
                acquisitions += 1
            body = dict(lease)
            body["spec"] = self._spec(acquisitions=acquisitions)
            status, _ = await self.client.call(
                "PUT", self._lease_url(self.lease_name), body)
            # a 409: another candidate updated first
            if status < 300:
                self._became_leader()
            else:
                self._leader = False
                self._valid_until = 0.0
            return self._leader
        except Exception as e:  # noqa: BLE001 — election must not crash
            logger.warning("leader election attempt failed: %s", e)
            # client-go's rule: a failed renew does not abdicate while
            # the Lease we wrote is unexpired (nobody else can acquire it
            # then, so halting our writes would leave none)
            if self._leader and time.time() >= self._valid_until:
                self._leader = False
            return self._leader

    def _spec(self, acquisitions: int) -> dict[str, Any]:
        now = self._now()
        return {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": int(self.lease_seconds),
            "acquireTime": now,
            "renewTime": now,
            "leaseTransitions": acquisitions,
        }

    async def run(self) -> None:
        """The renew loop; runs on the KubeSource loop (``submit``)."""
        while not self._stopping:
            await self.try_acquire()
            await asyncio.sleep(self.renew_seconds)
        if self._leader:
            await self.release()

    async def release(self) -> None:
        """Surrender the Lease (graceful shutdown): blank the holder and
        pre-expire it, so a peer acquires at once.

        Guarded: the blank PUT goes out only if we still hold the Lease
        on the server; a peer that acquired after ours lapsed keeps its
        Lease (else a third candidate could acquire: two writers). The
        fetched resourceVersion rides the PUT, so a real API server
        answers 409 to any change in between."""
        if not self._leader:
            return
        self._leader = False
        self._valid_until = 0.0
        try:
            status, raw = await self.client.call(
                "GET", self._lease_url(self.lease_name))
            if status != 200:
                return
            lease = json.loads(raw)
            holder = (lease.get("spec") or {}).get("holderIdentity", "")
            if holder != self.identity:
                return  # another holds it: not ours to blank
            meta = {"name": self.lease_name, "namespace": self.namespace}
            rv = (lease.get("metadata") or {}).get("resourceVersion")
            if rv is not None:
                meta["resourceVersion"] = rv
            body = {
                "apiVersion": "coordination.k8s.io/v1",
                "kind": "Lease",
                "metadata": meta,
                "spec": {"holderIdentity": "",
                         "leaseDurationSeconds": 1,
                         "renewTime": "1970-01-01T00:00:00.000000Z"},
            }
            await self.client.call(
                "PUT", self._lease_url(self.lease_name), body)
        except Exception as e:  # noqa: BLE001 — best-effort surrender
            logger.debug("lease release failed: %s", e)

    def stop(self) -> None:
        self._stopping = True
