"""Fleet control plane: the replica lifecycle manager (the port's copy
of ``aigw_tpu/gateway/controller.py``; its ``/drain`` posts go through
the standard-library client of ``gateway/http.py`` and its default
launcher child is the port's replica, ``tpuserve/child.py``).

It closes the loop between what the gateway observes (the health state
machines, the SLO burn-rate monitor, the decision audit ring) and what
it can do:

- **Autoscaling.** Scale-out consumes :class:`~aigw_tpu_torch.obs.slomon.
  SLOMonitor`'s fleet-key **sustained-overshoot flag** (K consecutive
  windows of measured error-budget burn, never predictions) and acts
  through a pluggable :class:`ReplicaLauncher`. Scale-in fires on
  sustained idle capacity (``idle_ticks`` consecutive controller ticks
  with free slots above ``idle_slots_frac`` and an empty fleet queue)
  and retires via lossless drain, never kill.

- **Lossless drain.** Retirement flips the replica ``draining`` both
  replica-side (``POST /drain``: the replica refuses new admissions
  with 503 and reports ``draining: true`` on /state) and gateway-side
  (the picker stops routing to draining replicas through the merged
  routability view), lets the gateway's migration orchestrator move
  every live migration-capable stream off (the ``_Migrator`` exports at
  once from a draining source, bypassing its queue-depth and
  young-stream gates), waits out the stragglers, and only then
  terminates: zero dropped streams by construction.

- **Crash failover.** When :class:`~aigw_tpu_torch.gateway.fleetstate.
  ReplicaHealth` walks a replica to ``down``, the controller drops the
  dead replica's session/prefix affinity entries (queued-at-the-gateway
  work re-routes on its next pick), and after ``down_grace_s`` of
  sustained death (a flapping replica must not trigger a launch/kill
  oscillation) launches a replacement when the live pool fell below
  ``min_replicas``. Streams caught mid-flight resume from their last
  exported state where one exists (the gateway retries the continuation
  on a sibling) and otherwise end with a clean typed error event.

Every lifecycle action lands in the controller's bounded event ring
(``/fleet/state`` → ``controller``), the decision audit ring
(``/debug/decisions``, ``lifecycle=...`` entries), and the
``aigw_ctl_*`` gauges on ``/fleet/metrics``.

The in-tree launcher is :class:`LocalProcessLauncher`: a subprocess per
replica, ``python -m aigw_tpu_torch.tpuserve.child SPEC`` unless the
config names another child. Tests step the controller's clock (the
picker's unless one is given) as they step the picker's.
"""


from __future__ import annotations

import asyncio
import collections
import json
import logging
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Any

from typing import Callable

from aigw_tpu_torch.gateway.fleetstate import DEGRADED, DOWN, UNKNOWN, UP
from aigw_tpu_torch.gateway.http import ClientError, HTTPClient, Timeout
from aigw_tpu_torch.gateway.picker import EndpointPicker
from aigw_tpu_torch.obs.slomon import SLOMonitor

logger = logging.getLogger(__name__)


@dataclass
class ControllerConfig:
    """Knobs for one backend pool's lifecycle manager. Defaults are
    deliberately conservative — production ticks in seconds; tests and
    the tools shrink everything."""

    enabled: bool = True
    #: pool size envelope: failover replaces below min, scale-out stops
    #: at max, scale-in never goes below min
    min_replicas: int = 1
    max_replicas: int = 4
    #: control-loop period
    tick_s: float = 1.0
    #: minimum seconds between any two scale actions (out, in, or
    #: failover replacement) — the anti-oscillation hysteresis
    scale_cooldown_s: float = 30.0
    #: scale-in predicate: this many CONSECUTIVE ticks of idle capacity
    #: (free-slot fraction ≥ idle_slots_frac, zero queued, no overshoot)
    idle_ticks: int = 60
    idle_slots_frac: float = 0.75
    #: a replica must stay `down` this long before the controller
    #: launches its replacement (flap protection — the health machine's
    #: own hysteresis walks it back up in 2 good polls)
    down_grace_s: float = 5.0
    #: drain budget: after this long a draining replica is retired with
    #: whatever stragglers remain (they see clean typed errors, never a
    #: silent hang — and the timeout is the operator's backstop against
    #: a wedged session pinning a replica forever)
    drain_timeout_s: float = 120.0
    #: launcher spec (config form): {"kind": "local", "spec": {...},
    #: "env": {...}} — None means observe/drain/re-route only, no
    #: launch capability
    launcher: dict | None = None

    @staticmethod
    def parse(value: dict) -> "ControllerConfig":
        """Raises ValueError on malformed input (Backend.parse maps it
        to ConfigError)."""
        if not isinstance(value, dict):
            raise ValueError(f"controller must be a mapping, got "
                             f"{type(value).__name__}")
        cfg = ControllerConfig(
            enabled=bool(value.get("enabled", True)),
            min_replicas=int(value.get("min_replicas", 1)),
            max_replicas=int(value.get("max_replicas", 4)),
            tick_s=float(value.get("tick_s", 1.0)),
            scale_cooldown_s=float(value.get("scale_cooldown_s", 30.0)),
            idle_ticks=int(value.get("idle_ticks", 60)),
            idle_slots_frac=float(value.get("idle_slots_frac", 0.75)),
            down_grace_s=float(value.get("down_grace_s", 5.0)),
            drain_timeout_s=float(value.get("drain_timeout_s", 120.0)),
            launcher=value.get("launcher"),
        )
        if cfg.min_replicas < 0 or cfg.max_replicas < 1:
            raise ValueError("controller replica bounds must be >= 0/1")
        if cfg.min_replicas > cfg.max_replicas:
            raise ValueError(
                f"controller min_replicas {cfg.min_replicas} > "
                f"max_replicas {cfg.max_replicas}")
        if cfg.tick_s <= 0:
            raise ValueError("controller tick_s must be > 0")
        if not 0.0 < cfg.idle_slots_frac <= 1.0:
            raise ValueError("controller idle_slots_frac must be in "
                             "(0, 1]")
        lc = cfg.launcher
        if lc is not None and dict(lc).get("kind", "local") != "local":
            raise ValueError(
                f"unknown controller launcher kind "
                f"{dict(lc).get('kind')!r}; in-tree: 'local'")
        return cfg


class ReplicaLauncher:
    """The controller's actuation interface. Implementations boot a
    replica process/pod and return its ``host:port``; terminate must be
    GRACEFUL (the controller drains before calling it)."""

    async def launch(self) -> str:
        raise NotImplementedError

    async def terminate(self, address: str) -> None:
        raise NotImplementedError

    def owns(self, address: str) -> bool:
        """Whether this launcher started (and may terminate) a replica.
        The controller never terminates replicas it didn't launch — it
        drains and removes them from routing instead."""
        return False

    async def close(self) -> None:
        """Terminate everything this launcher started (gateway
        shutdown must not orphan replica processes)."""


#: the repository root: the default child runs as a module of the port
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: the default child, ``python -m`` this module with the spec's JSON
DEFAULT_CHILD = "aigw_tpu_torch.tpuserve.child"


class LocalProcessLauncher(ReplicaLauncher):
    """Subprocess-per-replica launcher: one replica process per launch
    (``tpuserve/child.py``, or the script ``child_path`` names), serving
    the spec's model on a fresh port that it reports as
    ``SERVE_PORT=<port>`` on its standard output. SIGTERM on terminate
    rides the replica's graceful drain handler, SIGKILL only after
    ``term_grace_s``."""

    def __init__(self, spec: dict, child_path: str = "",
                 env: dict | None = None, boot_timeout_s: float = 1200.0,
                 term_grace_s: float = 30.0):
        self.spec = dict(spec)
        self.child_path = child_path
        self.env = dict(env or {})
        self.boot_timeout_s = boot_timeout_s
        self.term_grace_s = term_grace_s
        self._procs: dict[str, subprocess.Popen] = {}
        #: exit codes of replicas this launcher terminated (the drain
        #: rig asserts exit 0 — a clean drain, not a SIGKILL)
        self._exit_codes: dict[str, int] = {}
        #: address → (seconds the launch took, the child's own
        #: ``SERVE_BOOT_S`` or None when it printed none)
        self.boot_seconds: dict[str, tuple[float, float | None]] = {}

    @staticmethod
    def from_config(value: dict) -> "LocalProcessLauncher":
        v = dict(value)
        return LocalProcessLauncher(
            spec=dict(v.get("spec") or {}),
            child_path=str(v.get("child", "")),
            env={str(k): str(x) for k, x in (v.get("env") or {}).items()},
            boot_timeout_s=float(v.get("boot_timeout_s", 1200.0)),
            term_grace_s=float(v.get("term_grace_s", 30.0)),
        )

    def _wait_port(self, proc: subprocess.Popen) -> tuple[int, float | None]:
        """Blocking SERVE_PORT= parse (runs on a worker thread), with the
        child's SERVE_BOOT_S when it printed one first; the select loop
        keeps a wedged-but-alive child from holding the read forever."""
        import select

        boot = None
        fd = proc.stdout.fileno()
        os.set_blocking(fd, False)
        deadline = time.time() + self.boot_timeout_s
        buf = ""
        while time.time() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"replica child exited rc={proc.returncode} before "
                    "listening")
            r, _, _ = select.select([fd], [], [], 2.0)
            if not r:
                continue
            buf += os.read(fd, 4096).decode(errors="replace")
            *complete, buf = buf.split("\n")
            for line in complete:
                if line.startswith("SERVE_BOOT_S="):
                    boot = float(line.split("=", 1)[1])
                if line.startswith("SERVE_PORT="):
                    return int(line.split("=", 1)[1]), boot
        proc.kill()
        raise RuntimeError("replica child never reported a port")

    def command(self) -> list[str]:
        """The child's command line: the script ``child_path`` names,
        else the port's own child module."""
        spec = json.dumps(self.spec)
        if self.child_path:
            return [sys.executable, self.child_path, spec]
        return [sys.executable, "-m", DEFAULT_CHILD, spec]

    async def launch(self) -> str:
        env = dict(os.environ, **self.env)
        if not self.child_path:
            # the checkout holds the package; nothing is installed
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (_ROOT, env.get("PYTHONPATH", "")) if p)
        t0 = time.monotonic()
        proc = subprocess.Popen(self.command(), stdout=subprocess.PIPE,
                                text=True, env=env)
        try:
            port, boot = await asyncio.to_thread(self._wait_port, proc)
        except BaseException:
            if proc.poll() is None:
                proc.kill()
            raise
        addr = f"127.0.0.1:{port}"
        self._procs[addr] = proc
        self.boot_seconds[addr] = (time.monotonic() - t0, boot)
        logger.info("launched replica %s (pid %d)", addr, proc.pid)
        return addr

    def owns(self, address: str) -> bool:
        return address in self._procs

    def pid(self, address: str) -> int | None:
        proc = self._procs.get(address)
        return proc.pid if proc is not None else None

    async def terminate(self, address: str) -> None:
        proc = self._procs.pop(address, None)
        if proc is None:
            return
        if proc.poll() is None:
            proc.terminate()  # SIGTERM → graceful drain → exit 0
            try:
                await asyncio.to_thread(proc.wait, self.term_grace_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                await asyncio.to_thread(proc.wait, 10)
        self._exit_codes[address] = proc.returncode
        proc.stdout.close()
        logger.info("terminated replica %s rc=%s", address,
                    proc.returncode)

    def returncode(self, address: str) -> int | None:
        """Exit code of a terminated replica (None while running or
        unknown) — the drain rig asserts exit 0."""
        proc = self._procs.get(address)
        if proc is not None:
            return proc.returncode
        return self._exit_codes.get(address)

    async def close(self) -> None:
        for addr in list(self._procs):
            await self.terminate(addr)


#: counters every snapshot carries (each is a gauge of
#: obs.metrics.CONTROLLER_GAUGES)
COUNTERS = ("scale_outs", "scale_ins", "drains", "retires",
            "failovers", "launch_failures")


class FleetController:
    """Lifecycle manager for ONE backend pool, layered on the picker's
    existing poll loop — the controller adds no replica traffic beyond
    the ``POST /drain`` it sends when retiring.

    Deterministically testable: ``tick(now=...)`` is the whole control
    step; ``clock`` (the picker's by default) is the monotonic clock a
    tick without ``now`` and the drain budget read; ``start()`` merely
    runs the step on a timer."""

    EVENTS_MAX = 64

    def __init__(self, picker: EndpointPicker, cfg: ControllerConfig,
                 launcher: ReplicaLauncher | None = None,
                 decisions=None, backend: str = "pool",
                 clock: Callable[[], float] | None = None):
        self.picker = picker
        self.clock = clock or picker.clock
        self.cfg = cfg
        self.launcher = launcher
        #: the gateway's DecisionRing — every lifecycle action is a
        #: routing-relevant decision and lands there too (None in
        #: standalone/test use)
        self.decisions = decisions
        self.backend = backend
        self.counters: dict[str, int] = {k: 0 for k in COUNTERS}
        self.events: collections.deque = collections.deque(
            maxlen=self.EVENTS_MAX)
        self.idle_streak = 0
        #: None = no scale action yet (the first one is never
        #: cooldown-blocked — 0.0 would block it for cooldown seconds
        #: of a freshly-booted monotonic clock)
        self._last_scale_ts: float | None = None
        self._down_since: dict[str, float] = {}
        self._failover_done: set[str] = set()
        self._launches: set[asyncio.Task] = set()
        self._drains: dict[str, asyncio.Task] = {}
        self._drain_poll_s = max(0.05, min(0.5, cfg.tick_s / 2))
        self._client = HTTPClient()
        self._task: asyncio.Task | None = None

    # -- lifecycle --------------------------------------------------------
    async def start(self) -> None:
        self._task = asyncio.create_task(self._loop(),
                                         name=f"fleet-ctl-{self.backend}")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        for t in list(self._launches) + list(self._drains.values()):
            t.cancel()
        self._client.close()
        if self.launcher is not None:
            await self.launcher.close()

    async def _loop(self) -> None:
        while True:
            try:
                await self.tick()
            except Exception:  # noqa: BLE001 — the control loop must
                # survive any single tick's failure (a dead controller
                # is worse than a skipped tick)
                logger.exception("controller tick failed")
            await asyncio.sleep(self.cfg.tick_s)

    # -- bookkeeping ------------------------------------------------------
    def _event(self, action: str, replica: str = "",
               reason: str = "") -> None:
        ev = {"ts": round(time.time(), 3), "action": action}
        if replica:
            ev["replica"] = replica
        if reason:
            ev["reason"] = reason
        self.events.append(ev)
        if self.decisions is not None:
            self.decisions.record(lifecycle=action, backend=self.backend,
                                  replica=replica, reason=reason)
        logger.info("fleet-ctl[%s] %s %s %s", self.backend, action,
                    replica, reason)

    def _health_of(self, addr: str) -> str:
        return self.picker.fleet.health_of(addr)

    def live_addrs(self) -> list[str]:
        """Replicas currently carrying (or about to carry) load: up,
        degraded, or too new to have been polled — excluding draining,
        down, and mid-retirement ones."""
        return [e.address for e in self.picker.endpoints
                if self._health_of(e.address) in (UP, DEGRADED, UNKNOWN)
                and e.address not in self._drains]

    def _live_count(self) -> int:
        return len(self.live_addrs()) + len(self._launches)

    def _cooldown_ok(self, now: float) -> bool:
        return (self._last_scale_ts is None
                or now - self._last_scale_ts >= self.cfg.scale_cooldown_s)

    # -- the control step -------------------------------------------------
    async def tick(self, now: float | None = None) -> None:
        """One reconcile pass: failover detection, then the scale-out
        and scale-in predicates. All actuation is spawned as tasks so a
        slow launch/drain never blocks detection."""
        now = self.clock() if now is None else now
        self._tick_failover(now)
        self._tick_scale_out(now)
        self._tick_scale_in(now)

    def _tick_failover(self, now: float) -> None:
        down = {e.address for e in self.picker.endpoints
                if self._health_of(e.address) == DOWN}
        # replicas that recovered (restart on the same port walks back
        # up through the health machine's 2-good-poll gate) re-arm
        for addr in list(self._down_since):
            if addr not in down:
                self._down_since.pop(addr, None)
                self._failover_done.discard(addr)
        for addr in down:
            if addr not in self._down_since:
                # first sighting: re-route queued work NOW — affine
                # sessions must not chase the dead replica through the
                # stickiness margin while the grace timer runs
                self._down_since[addr] = now
                self.picker.forget_endpoint(addr)
                self._event("reroute", addr, "replica down")
            if addr in self._failover_done:
                continue
            if now - self._down_since[addr] < self.cfg.down_grace_s:
                continue  # flap protection
            self._failover_done.add(addr)
            self.counters["failovers"] += 1
            self._event("failover", addr,
                        f"down for {now - self._down_since[addr]:.1f}s")
            if (self._live_count() < self.cfg.min_replicas
                    and self.launcher is not None):
                self._last_scale_ts = now
                self._spawn_launch("failover replacement")

    def _tick_scale_out(self, now: float) -> None:
        # keyed on INTERACTIVE SLO burn only: the burn
        # monitor reads the replicas' TTFT histograms, and the engine
        # never observes batch streams into those — a fleet saturated
        # with offline soak but meeting interactive TTFT does not
        # scale out; batch absorbs the slack instead
        mon = self.picker.fleet.slomon
        if mon is None or not mon.sustained(SLOMonitor.FLEET_KEY):
            return
        if self._live_count() >= self.cfg.max_replicas:
            return
        if not self._cooldown_ok(now) or self._launches:
            return
        if self.launcher is None:
            self._event("scale_out_skipped", reason="no launcher")
            return
        self._last_scale_ts = now
        self.counters["scale_outs"] += 1
        self._event("scale_out",
                    reason="sustained SLO overshoot (measured burn)")
        self._spawn_launch("scale_out")

    def _tick_scale_in(self, now: float) -> None:
        live = self.live_addrs()
        if len(live) <= self.cfg.min_replicas or self._drains:
            self.idle_streak = 0
            return
        mon = self.picker.fleet.slomon
        if mon is not None and mon.sustained(SLOMonitor.FLEET_KEY):
            self.idle_streak = 0
            return
        slots_total = slots_free = queued = 0
        for addr in live:
            st = self.picker.state.get(addr)
            if st is None or not st.healthy:
                continue
            slots_total += st.max_slots
            # idleness is judged on INTERACTIVE occupancy:
            # batch soak is SUPPOSED to fill idle slots — counting it
            # would let a big offline backlog pin fleet capacity the
            # interactive class no longer needs
            slots_free += max(0, st.max_slots
                              - (st.active_slots - st.batch_active))
            queued += st.queued
        idle = (slots_total > 0 and queued == 0
                and slots_free / slots_total >= self.cfg.idle_slots_frac)
        self.idle_streak = self.idle_streak + 1 if idle else 0
        if self.idle_streak < self.cfg.idle_ticks:
            return
        if not self._cooldown_ok(now):
            return
        victim = self._scale_in_victim(live)
        if victim is None:
            self.idle_streak = 0
            return
        self._last_scale_ts = now
        self.idle_streak = 0
        self.counters["scale_ins"] += 1
        self._event("scale_in", victim,
                    f"idle for {self.cfg.idle_ticks} ticks")
        self._spawn_drain(victim, "scale_in")

    def _scale_in_victim(self, live: list[str]) -> str | None:
        """Least-loaded retirement candidate, preferring replicas the
        launcher owns (those can actually be terminated; a configured
        static replica is only drained out of routing)."""
        def load(addr: str) -> float:
            st = self.picker.state.get(addr)
            if st is None:
                return 0.0
            return (st.active_slots + st.queued
                    + float(getattr(st, "migratable_slots", 0)) * 0.01
                    # prefer retiring the replica with the least batch
                    # backlog to wait out (its state is replica-local)
                    + float(getattr(st, "batch_queued", 0)) * 0.1)

        owned = [a for a in live
                 if self.launcher is not None and self.launcher.owns(a)]
        pool = owned or list(live)
        return min(pool, key=load) if pool else None

    # -- actuation --------------------------------------------------------
    def _spawn_launch(self, reason: str) -> None:
        task = asyncio.create_task(self._launch(reason))
        self._launches.add(task)
        task.add_done_callback(self._launches.discard)

    async def _launch(self, reason: str) -> None:
        try:
            addr = await self.launcher.launch()
        except Exception as e:  # noqa: BLE001 — a failed launch is a
            # counted event, not a dead control loop
            self.counters["launch_failures"] += 1
            self._event("launch_failed", reason=f"{reason}: {e}")
            return
        self.picker.add_endpoint(addr)
        self._event("launch", addr, reason)

    def _spawn_drain(self, addr: str, reason: str) -> None:
        if addr in self._drains:
            return
        task = asyncio.create_task(self.drain_and_retire(addr, reason))
        self._drains[addr] = task
        task.add_done_callback(lambda _t: self._drains.pop(addr, None))

    async def drain_and_retire(self, addr: str,
                               reason: str = "operator") -> bool:
        """The lossless-drain protocol: (1) flip the replica draining on
        BOTH sides — ``POST /drain`` makes tpuserve refuse new
        admissions with 503 and report ``draining: true`` on /state,
        the fleet mark makes the picker stop routing immediately (new
        streams never land on it); (2) the gateway's migration
        orchestrator moves every live migration-capable stream off
        (draining sources export unconditionally); (3) wait until the
        replica reports zero active slots and an empty queue, or the
        drain budget runs out; (4) terminate (launcher-owned) and
        remove from the pool. Returns True when the replica was
        verifiably empty at retirement."""
        self.counters["drains"] += 1
        self._event("drain_start", addr, reason)
        posted = await self._post_drain(addr, True)
        if not posted:
            self._event("drain_post_failed", addr,
                        "replica /drain unreachable; gateway-side only")
        deadline = self.clock() + self.cfg.drain_timeout_s
        drained = False
        while self.clock() < deadline:
            # re-assert each pass: a poll of a replica that doesn't
            # report `draining` on /state (stubs, old builds) would
            # otherwise clear the overlay between passes
            self.picker.fleet.mark_draining(addr, True)
            st = self.picker.state.get(addr)
            if st is None:
                break  # removed underneath us
            if self._health_of(addr) == DOWN:
                break  # died mid-drain: nothing left to wait for
            if (st.healthy and st.active_slots == 0 and st.queued == 0
                    # batch backlog drains BEFORE retirement: queued
                    # and parked offline work is replica-local state,
                    # so the soak finishes first
                    and st.batch_queued == 0 and st.batch_active == 0
                    and st.staleness_s(self.picker.clock()) >= 0):
                drained = True
                break
            await asyncio.sleep(self._drain_poll_s)
        self._event("drain_complete" if drained else "drain_timeout",
                    addr)
        if self.launcher is not None and self.launcher.owns(addr):
            await self.launcher.terminate(addr)
        self.picker.remove_endpoint(addr)
        self.counters["retires"] += 1
        self._event("retire", addr, reason)
        return drained

    async def _post_drain(self, addr: str, on: bool) -> bool:
        try:
            async with await self._client.post(
                    f"http://{addr}/drain",
                    data=json.dumps({"on": on}).encode(),
                    headers={"content-type": "application/json"},
                    timeout=Timeout(total=10.0)) as r:
                await r.read()
                return r.status == 200
        except (ClientError, asyncio.TimeoutError, OSError):
            return False

    # -- read side --------------------------------------------------------
    def gauge_values(self) -> dict[str, Any]:
        """Flat numeric view for obs.metrics.CONTROLLER_GAUGES."""
        return {
            **self.counters,
            "launches_in_flight": len(self._launches),
            "drains_in_progress": len(self._drains),
            "replicas_min": self.cfg.min_replicas,
            "replicas_max": self.cfg.max_replicas,
            "replicas_live": len(self.live_addrs()),
            "idle_streak": self.idle_streak,
        }

    def snapshot(self) -> dict[str, Any]:
        """The ``controller`` block of ``/fleet/state`` (and the
        fleetwatch table's controller lines)."""
        return {
            "enabled": self.cfg.enabled,
            "min_replicas": self.cfg.min_replicas,
            "max_replicas": self.cfg.max_replicas,
            "launcher": (type(self.launcher).__name__
                         if self.launcher is not None else ""),
            "counters": dict(self.counters),
            "launches_in_flight": len(self._launches),
            "drains_in_progress": sorted(self._drains),
            "replicas_live": sorted(self.live_addrs()),
            "idle_streak": self.idle_streak,
            "events": list(self.events),
        }


def build_launcher(value: dict | None) -> ReplicaLauncher | None:
    """Launcher from the config block's ``launcher`` mapping (the
    config layer froze it; thaw defensively)."""
    if not value:
        return None
    from aigw_tpu_torch.config.model import _thaw

    v = _thaw(value) if not isinstance(value, dict) else dict(value)
    kind = str(v.get("kind", "local"))
    if kind == "local":
        return LocalProcessLauncher.from_config(v)
    raise ValueError(f"unknown launcher kind {kind!r}")
