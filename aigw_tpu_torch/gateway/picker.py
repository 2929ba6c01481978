"""Endpoint picker — KV-occupancy- and topology-aware load balancing
(the port's copy of ``aigw_tpu/gateway/picker.py``; its ``/state`` poll
runs on the port's standard-library client, ``gateway/http.py``, with
the reference's 2 s limit, and its clock is injectable).

The role the reference delegates to an external EPP service speaking
ext_proc (InferencePool → picker sets ``x-gateway-destination-endpoint``,
reference inferencepool.go:47, post_cluster_modify.go:67-80). Here the
picker is in-process: it polls each tpuserve replica's ``/state``
telemetry (KV page occupancy, queue depth, active slots — exported by
aigw_tpu/tpuserve/server.py) and scores endpoints:

    score = kv_occupancy [worst device]      (HBM pressure — on a mesh
                                              replica the WORST device's
                                              occupancy, polled from the
                                              per-device /state map)
          + queued / max_slots               (waiting work)
          + active_slots / max_slots * 0.5   (decode batch load)
          + queue_wait_ms / 1000             (queue latency: seconds the
                                              oldest request has waited —
                                              a replica whose queue MOVES
                                              beats one the same depth
                                              stuck behind a long prefill)
          + SLICE_PENALTY                    (for sessions only: replicas
                                              OUTSIDE the session's ICI
                                              slice — failover and
                                              load-forced moves prefer a
                                              same-slice sibling on ties)

    Topology is live, not just configured: each replica reports its own
    slice on ``/state`` (the replica exports its devices' slice index
    and chip coords), overriding the static ``slice`` label.

Session affinity (``x-aigw-session-affinity``, or derived from the
conversation head by the gateway) is per-endpoint STICKY: the session
stays on its previous replica — whose prefix cache holds its KV — unless
that replica's score exceeds the best alternative by
``STICKINESS_MARGIN``. Unhealthy or stale endpoints are skipped; with no
telemetry at all the picker falls back to round-robin.

Prefix affinity (``x-aigw-prefix-hash``, or derived from the request's
system-prompt head by the gateway) is SOFT, not sticky: requests whose
prefix hash was recently routed to a replica get a bounded score BONUS
toward it — that replica's prefix cache already holds the shared
system-prompt KV pages, so landing there turns the prompt prefill into
a suffix (or single-token) resume. The bonus is a constant
(``PREFIX_AFFINITY_BONUS``) while the load/queue_wait terms are
unbounded, so affinity never overrides saturation; unlike sessions,
many independent clients share one prefix key, and hard stickiness
would funnel them all onto one replica.
"""

from __future__ import annotations

import asyncio
import collections
import itertools
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from aigw_tpu_torch.gateway.http import ClientError, HTTPClient, Timeout
from aigw_tpu_torch.gateway.kvindex import KVIndex
from aigw_tpu_torch.gateway.fleetstate import DOWN, DRAINING, FleetState
from aigw_tpu_torch.obs.slomon import SLOMonitor

logger = logging.getLogger(__name__)

#: request header carrying a session affinity key (optional)
AFFINITY_HEADER = "x-aigw-session-affinity"

#: request header carrying a shared-prefix hash (optional; the gateway
#: derives one from the system/developer message head when the backend
#: enables the picker) — soft cache-affinity, see module docstring
PREFIX_HEADER = "x-aigw-prefix-hash"

#: request header carrying the LoRA adapter the request needs (derived
#: by the gateway from the model's ":adapter" suffix). SOFT affinity:
#: replicas reporting the adapter RESIDENT on /state get a score bonus
#: — landing there serves from the already-loaded row; any replica of
#: the pool can still hot-load it, so affinity never gates placement.
ADAPTER_HEADER = "x-aigw-adapter"

#: request header carrying the tenant key (client-set, or derived by the
#: gateway from the model's adapter suffix) — relayed upstream so the
#: replica's fairness guard and the gateway's quota/cost accounting key
#: on the same tenant
TENANT_HEADER = "x-aigw-tenant"

#: priority class header: requests marked ``batch`` ride the
#: offline tier — the picker routes them to the replica with the MOST
#: idle capacity (the inverse of the interactive preference) and never
#: SLO-sheds them (batch queues, it doesn't 429); relayed upstream so
#: the replica's two-class scheduler sees the same class
PRIORITY_HEADER = "x-aigw-priority"

#: KV chain-hash header: the hex content hash of the
#: request's first prompt page. Usually LEARNED, not client-set — each
#: tpuserve response carries it, and the picker remembers (prefix-head
#: → chain) so later requests sharing the prefix head resolve to a
#: chain the fleet index can locate. A client/test may also set it
#: directly. Replicas the index says hold the chain get the bounded
#: fleet-hit bonus and are named as fetch peers.
KV_CHAIN_HEADER = "x-aigw-kv-chain"

#: upstream request header naming sibling replicas that hold the
#: request's chain (comma-separated "host:port") — the chosen replica
#: fetches missing prefix pages from them over POST /kv/pages instead
#: of re-prefilling (tpuserve/server.py consumes it)
KV_PEERS_HEADER = "x-aigw-kv-peers"

#: request header carrying the client's own prompt-token count
#: (optional). When absent the gateway estimates one from the prompt
#: byte length before pick() — the estimate feeds the picker's
#: context-length filter and the prompt-priced TTFT model, never the
#: replica (tpuserve recounts with its real tokenizer on admission).
PROMPT_TOKENS_HEADER = "x-aigw-prompt-tokens"


class SLOShedError(Exception):
    """Every fresh candidate's predicted TTFT blows the configured SLO:
    admitting the request would queue it into collapse. The gateway
    surfaces 429 + Retry-After instead (admission control)."""

    def __init__(self, retry_after_s: int, predicted_ms: float,
                 slo_ms: float):
        super().__init__(
            f"predicted TTFT {predicted_ms:.0f}ms exceeds the "
            f"{slo_ms:.0f}ms SLO on every candidate replica")
        self.retry_after_s = retry_after_s
        self.predicted_ms = predicted_ms
        self.slo_ms = slo_ms


class ContextLengthError(Exception):
    """The request's prompt exceeds the advertised ``max_seq_len`` of
    EVERY fresh candidate replica: routing it anywhere would burn a
    full admission round-trip just to collect tpuserve's over-length
    ValueError mid-stream. The gateway surfaces a clean 400 instead
    (long-context satellite: context length is a routing input, not a
    replica-side surprise)."""

    def __init__(self, prompt_tokens: int, max_ctx: int):
        super().__init__(
            f"prompt of ~{prompt_tokens} tokens exceeds the "
            f"{max_ctx}-token context length of every candidate "
            f"replica")
        self.prompt_tokens = prompt_tokens
        self.max_ctx = max_ctx


@dataclass(frozen=True)
class Endpoint:
    address: str  # host:port
    slice_name: str = ""  # ICI slice / host grouping label

    @staticmethod
    def parse(value: Any) -> "Endpoint":
        if isinstance(value, str):
            return Endpoint(address=value)
        return Endpoint(address=value["address"],
                        slice_name=value.get("slice", ""))


@dataclass
class EndpointState:
    healthy: bool = False
    kv_occupancy: float = 0.0
    queued: int = 0
    active_slots: int = 0
    max_slots: int = 1
    queue_wait_ms: float = 0.0  # age of the oldest queued request
    # prefix-cache effectiveness reported by the replica on /state
    # (tpuserve prefix_cache_hit_rate) — dashboard/affinity telemetry
    prefix_hit_rate: float = 0.0
    # served base model + adapter zoo reported on /state: resident
    # adapters feed the adapter-affinity score term; registered names
    # feed the gateway's /v1/models zoo listing
    model: str = ""
    adapters_resident: frozenset = frozenset()
    adapters_registered: tuple = ()
    # slice reported by the replica itself on /state (multislice
    # slice_index) — overrides the statically configured slice label, so
    # topology follows reality after reschedules
    slice_name: str = ""
    # MEASURED per-device memory pressure polled from /state: the
    # device's bytes_in_use / bytes_limit as a fraction (0.0 on backends without
    # memory stats — the term then vanishes from the score)
    hbm_frac: float = 0.0
    # structured-output / tool-calling capability flags reported on
    # /state — merged into the gateway's /v1/models zoo listing
    constrained: bool = False
    capabilities: dict = field(default_factory=dict)
    # serving-phase latency distributions polled from /state
    # (phase → {p50, p95, p99} in ms; -1 = no observations) — the
    # SLO-aware mode's predictive inputs
    phase_percentiles: dict = field(default_factory=dict)
    # migration-eligibility gauge polled from /state: slots whose
    # prefill is done but decode is young — what a decode-leaning
    # sibling could take over
    migratable_slots: int = 0
    # mesh serving: the replica's REAL per-device map polled
    # from /state `devices` (memory_frac / kv_occupancy / param_bytes
    # per device), the worst-device memory fraction, its device
    # population, and whether the replica can serve /migrate/export|
    # import at all (`migration` capability flag; replicas predating
    # the flag are assumed capable — the export 409 still guards)
    devices: tuple = ()
    hbm_frac_worst: float = 0.0
    mesh_devices: int = 1
    migration_capable: bool = True
    # KV memory hierarchy: the replica's advertised chain-
    # hash digest (resident + host-spilled) polled from /state — fed
    # into the picker's fleet-wide KVIndex on every poll
    kv_chains: tuple = ()
    updated_at: float = 0.0
    # fleet observability: when the last poll SUCCEEDED
    # (monotonic; 0 = never), consecutive failed polls since, and the
    # replica's self-reported identity/uptime. The stale-poll fix: a
    # failed poll used to leave the last-good state frozen with only
    # `healthy` flipped — these stamps make staleness first-class, so
    # slo mode and /fleet/state can tell "current truth" from "how the
    # replica looked before it died".
    last_poll_ok_ts: float = 0.0
    poll_failures: int = 0
    replica_id: str = ""
    uptime_s: float = 0.0
    # long-context serving: the replica's advertised context length
    # (0 = not advertised, filter vanishes), its sequence-parallel
    # axis size, and the measured prefill cost per token — the
    # context-length filter and the prompt-priced TTFT model read
    # these off /state
    max_seq_len: int = 0
    sp: int = 1
    prefill_ms_per_token: float = 0.0
    # MoE serving: hottest-expert load ratio polled from
    # /state (max expert tokens / mean; 1.0 = perfectly balanced, 0.0 =
    # dense replica — the term vanishes). The worst-device discipline
    # extended to expert shards: an expert-parallel replica's step time
    # is its hottest expert's, so imbalance prices the replica even
    # when slots and queue look fine.
    moe_expert_imbalance: float = 0.0
    # priority-tiered serving: the replica's offline-class
    # footprint polled from /state. ``queued``/``queue_wait_ms`` above
    # stay interactive-only (batch rides its own engine queue), so
    # predicted_ttft_ms never prices batch backlog; these feed the
    # batch routing branch (most idle capacity), fleetwatch's per-class
    # columns, and the controller's retire-drain wait.
    batch_queued: int = 0
    batch_active: int = 0
    batch_preemptions: int = 0

    def staleness_s(self, now: float | None = None) -> float:
        """Seconds since the last successful poll (-1 = never)."""
        if not self.last_poll_ok_ts:
            return -1.0
        return max(0.0, (now if now is not None else time.monotonic())
                   - self.last_poll_ok_ts)

    def worst_hbm_frac(self) -> float:
        """Worst per-device memory fraction — the mesh memory signal
        the score consumes (one hot shard stalls every tensor-parallel
        step, so the WORST device prices the replica, not device 0).
        Falls back to the device-0 scalar when the replica exports no
        per-device data."""
        per = max((float(d.get("memory_frac", 0.0) or 0.0)
                   for d in self.devices), default=0.0)
        return max(self.hbm_frac, self.hbm_frac_worst, per)

    def worst_kv_occupancy(self) -> float:
        """Worst per-device KV pool occupancy (uniform under pure tensor
        parallelism — the head-sharded pool allocates pages globally —
        but real the moment layouts diverge). Never below the scalar
        gauge."""
        per = max((float(d.get("kv_occupancy", 0.0) or 0.0)
                   for d in self.devices), default=0.0)
        return max(self.kv_occupancy, per)


class EndpointPicker:
    """Picker for one backend pool."""

    STALE_AFTER = 10.0  # seconds without telemetry → treat as unknown

    def __init__(self, endpoints: list[Endpoint],
                 poll_interval: float = 1.0,
                 mode: str = "static",
                 slo_ttft_ms: float = 0.0,
                 fleet_obs: bool = True,
                 slo_objective: float = 0.95,
                 slo_window_s: float = 30.0,
                 slo_burn_windows: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        """``clock`` is the monotonic clock staleness and the stamps of
        polls and ``observe`` read (a test steps its own)."""
        if mode not in ("static", "slo"):
            raise ValueError(f"picker mode must be 'static' or 'slo' "
                             f"(got {mode!r})")
        self.endpoints = endpoints
        self.poll_interval = poll_interval
        #: "static" — the classic score sum; "slo" — rank candidates by
        #: PREDICTED TTFT derived from each replica's live phase
        #: histograms + queue depth, falling back to static
        #: scoring while no replica has histogram data yet
        self.mode = mode
        #: admission-control budget for slo mode: when > 0 and every
        #: fresh candidate's predicted TTFT exceeds it, pick() raises
        #: SLOShedError instead of routing (the gateway sheds with
        #: 429 + Retry-After). 0 = route-only (never shed).
        self.slo_ttft_ms = slo_ttft_ms
        self.clock = clock
        self.state: dict[str, EndpointState] = {
            e.address: EndpointState() for e in endpoints
        }
        self._by_addr = {e.address: e for e in endpoints}
        self._rr = itertools.cycle([e.address for e in endpoints])
        # session key → address, LRU-bounded
        self._affinity: "collections.OrderedDict[str, str]" = (
            collections.OrderedDict()
        )
        # prefix hash → address a request with that prefix was most
        # recently routed to (its prefix cache likely holds the pages)
        self._prefix_affinity: "collections.OrderedDict[str, str]" = (
            collections.OrderedDict()
        )
        # fleet-wide chain-hash → replica index, fed by the
        # kv_chains digests this poll loop already collects
        self.kv_index = KVIndex()
        # fleet observability plane: health state machine +
        # rollups + the live SLO burn-rate monitor, all fed from this
        # same poll loop. fleet_obs=False drops the monitor (the A/B
        # control); the health machine itself is a few dict ops and
        # stays on — /fleet/state must always answer.
        self.fleet_obs = fleet_obs
        self.fleet = FleetState(
            slomon=SLOMonitor(
                slo_ms=slo_ttft_ms, objective=slo_objective,
                window_s=slo_window_s, k_windows=slo_burn_windows)
            if fleet_obs else None)
        # prefix hash → KV chain hash learned from tpuserve response
        # headers (x-aigw-kv-chain): resolves a request's prefix head
        # to the content chain the index can locate, LRU-bounded
        self._prefix_chain: "collections.OrderedDict[str, str]" = (
            collections.OrderedDict()
        )
        # merged routability: the gateway installs its
        # circuit breaker here so pick() consults ONE view — health
        # machine (down/draining) + breaker state — instead of the two
        # tracking overlapping failure evidence independently
        self.breaker = None
        self._task: asyncio.Task | None = None

    # -- fleet membership (controller) ---------------------------
    def add_endpoint(self, address: str, slice_name: str = "") -> None:
        """Join a freshly launched replica to the pool (scale-out /
        failover replacement). Idempotent; the poll loop picks it up on
        its next cycle."""
        if address in self._by_addr:
            return
        e = Endpoint(address=address, slice_name=slice_name)
        self.endpoints.append(e)
        self._by_addr[address] = e
        self.state[address] = EndpointState()
        self._rr = itertools.cycle([x.address for x in self.endpoints])

    def remove_endpoint(self, address: str) -> None:
        """Retire a replica from the pool (scale-in after drain, or a
        crashed replica the controller replaced): drops its telemetry,
        fleet health entry, index entries, and affinity memory."""
        self.endpoints = [e for e in self.endpoints
                          if e.address != address]
        self._by_addr.pop(address, None)
        self.state.pop(address, None)
        self.kv_index.remove(address)
        self.fleet.forget(address)
        self.forget_endpoint(address)
        # pick() returns None before touching the cycle when the pool
        # is empty, so an empty cycle is never advanced
        self._rr = itertools.cycle([x.address for x in self.endpoints])

    def forget_endpoint(self, address: str) -> None:
        """Drop session/prefix affinity entries pointing at a dead or
        retired replica — the controller's "re-route queued work" hook:
        the next request of an affine session re-picks over the live
        pool instead of chasing its dead home through the stickiness
        margin."""
        for mapping in (self._affinity, self._prefix_affinity):
            for key in [k for k, v in mapping.items() if v == address]:
                del mapping[key]

    def is_routable(self, address: str) -> bool:
        """The merged health view: a replica is routable
        only when the fleet health machine doesn't have it down or
        draining AND the gateway's circuit breaker (when installed)
        isn't open for it. Poll-level freshness/health is layered on
        top by the score path."""
        if self.fleet.health_of(address) in (DOWN, DRAINING):
            return False
        return not (self.breaker is not None
                    and self.breaker.is_open(address))

    # -- polling ----------------------------------------------------------
    async def start(self) -> None:
        self._task = asyncio.create_task(self._poll_loop(),
                                         name="endpoint-picker")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    #: the limit on one /state poll, as the reference's session
    POLL_TIMEOUT = Timeout(total=2.0)

    async def _poll_loop(self) -> None:
        client = HTTPClient()
        try:
            while True:
                await asyncio.gather(
                    *(self._poll_one(client, e) for e in self.endpoints),
                    return_exceptions=True,
                )
                await asyncio.sleep(self.poll_interval)
        finally:
            client.close()

    async def _poll_one(self, client: HTTPClient, e: Endpoint) -> None:
        st = self.state.get(e.address)
        if st is None:
            return  # removed mid-poll-cycle

        def failed() -> None:
            # a failed poll counts, feeds the fleet health machine, and
            # leaves last_poll_ok_ts aging so every consumer sees the
            # staleness instead of the replica's last happy state
            st.healthy = False
            st.poll_failures += 1
            # a fetch pointed at a dead sibling only wastes its timeout
            self.kv_index.remove(e.address)
            self.fleet.note_poll(e.address, False)

        try:
            async with await client.get(f"http://{e.address}/state",
                                        timeout=self.POLL_TIMEOUT) as resp:
                if resp.status != 200:
                    failed()
                    return
                data = json.loads(await resp.read())
        except (ClientError, asyncio.TimeoutError, ValueError):
            # ValueError: a 200 with a torn or non-JSON body
            failed()
            return
        st.healthy = True
        st.kv_occupancy = float(data.get("kv_occupancy", 0.0))
        st.queued = int(data.get("queued", 0))
        st.active_slots = int(data.get("active_slots", 0))
        st.max_slots = max(1, int(data.get("max_slots", 1)))
        st.queue_wait_ms = float(data.get("queue_wait_ms", 0.0))
        st.prefix_hit_rate = float(data.get("prefix_cache_hit_rate", 0.0))
        st.phase_percentiles = dict(data.get("phase_percentiles") or {})
        st.migratable_slots = int(data.get("migratable_slots", 0))
        st.hbm_frac = float(data.get("device_memory_frac", 0.0) or 0.0)
        st.hbm_frac_worst = float(
            data.get("device_memory_frac_worst", 0.0) or 0.0)
        st.devices = tuple(d for d in (data.get("devices") or ())
                           if isinstance(d, dict))
        st.mesh_devices = max(1, int(data.get("mesh_devices", 1) or 1))
        st.migration_capable = bool(data.get("migration", True))
        st.constrained = bool(data.get("constrained_decoding", False))
        st.capabilities = dict(data.get("capabilities") or {})
        st.slice_name = str(data.get("slice", "") or "")
        st.model = str(data.get("model", "") or "")
        st.adapters_resident = frozenset(
            data.get("adapters_resident") or ())
        st.adapters_registered = tuple(
            data.get("adapters_registered") or ())
        st.kv_chains = tuple(
            str(k) for k in (data.get("kv_chains") or ()))
        self.kv_index.update(e.address, st.kv_chains)
        st.replica_id = str(data.get("replica_id", "") or "")
        st.uptime_s = float(data.get("uptime_s", 0.0) or 0.0)
        st.max_seq_len = int(data.get("max_seq_len", 0) or 0)
        st.sp = max(1, int(data.get("sp", 1) or 1))
        st.prefill_ms_per_token = float(
            data.get("prefill_ms_per_token", 0.0) or 0.0)
        st.moe_expert_imbalance = float(
            data.get("moe_expert_imbalance", 0.0) or 0.0)
        st.batch_queued = int(data.get("batch_queued", 0) or 0)
        st.batch_active = int(data.get("batch_active", 0) or 0)
        st.batch_preemptions = int(
            data.get("batch_preemptions", 0) or 0)
        st.poll_failures = 0
        st.last_poll_ok_ts = self.clock()
        st.updated_at = self.clock()
        # fleet aggregation: health machine + rollup source
        # + the burn-rate monitor's histogram feed, all off this poll
        self.fleet.note_poll(e.address, True, data)

    # -- manual state injection (tests / push-based telemetry) ------------
    def observe(self, address: str, *, kv_occupancy: float = 0.0,
                queued: int = 0, active_slots: int = 0,
                max_slots: int = 1, queue_wait_ms: float = 0.0,
                prefix_hit_rate: float = 0.0,
                slice_name: str = "",
                adapters_resident: tuple = (),
                model: str = "",
                adapters_registered: tuple = (),
                phase_percentiles: dict | None = None,
                migratable_slots: int = 0,
                hbm_frac: float = 0.0,
                hbm_frac_worst: float = 0.0,
                devices: tuple = (),
                migration_capable: bool = True,
                kv_chains: tuple = (),
                max_seq_len: int = 0,
                sp: int = 1,
                prefill_ms_per_token: float = 0.0,
                moe_expert_imbalance: float = 0.0,
                batch_queued: int = 0,
                batch_active: int = 0,
                batch_preemptions: int = 0) -> None:
        st = self.state[address]
        st.healthy = True
        st.kv_occupancy = kv_occupancy
        st.queued = queued
        st.active_slots = active_slots
        st.max_slots = max(1, max_slots)
        st.queue_wait_ms = queue_wait_ms
        st.prefix_hit_rate = prefix_hit_rate
        st.hbm_frac = hbm_frac
        st.hbm_frac_worst = hbm_frac_worst
        if devices:
            st.devices = tuple(devices)
        st.migration_capable = migration_capable
        if phase_percentiles is not None:
            st.phase_percentiles = dict(phase_percentiles)
        st.migratable_slots = migratable_slots
        if slice_name:
            st.slice_name = slice_name
        if adapters_resident:
            st.adapters_resident = frozenset(adapters_resident)
        if model:
            st.model = model
        if adapters_registered:
            st.adapters_registered = tuple(adapters_registered)
        if kv_chains:
            st.kv_chains = tuple(kv_chains)
            self.kv_index.update(address, st.kv_chains)
        if max_seq_len:
            st.max_seq_len = max_seq_len
        if sp > 1:
            # mirror the max_seq_len/prefill_ms_per_token guards: a
            # push-fed observe() that omits sp must not reset a polled
            # replica's advertised sp axis back to the default
            st.sp = sp
        if prefill_ms_per_token:
            st.prefill_ms_per_token = prefill_ms_per_token
        if moe_expert_imbalance:
            st.moe_expert_imbalance = moe_expert_imbalance
        st.batch_queued = batch_queued
        st.batch_active = batch_active
        if batch_preemptions:
            st.batch_preemptions = batch_preemptions
        st.poll_failures = 0
        st.last_poll_ok_ts = self.clock()
        st.updated_at = self.clock()
        self.fleet.note_poll(address, True)

    # -- picking ----------------------------------------------------------
    #: a sticky endpoint keeps the session unless its score exceeds the
    #: best alternative by this much (KV locality beats small load skew)
    STICKINESS_MARGIN = 0.5
    #: score penalty for leaving the session's current ICI slice: on
    #: failover (or a load-forced move) a same-slice replica wins score
    #: ties — it shares the multislice interconnect domain of the
    #: replica that holds the session's KV, so cross-replica prefix
    #: migration and any future KV-transfer path stay on ICI instead of
    #: DCN. Small enough that real load imbalance still dominates.
    SLICE_PENALTY = 0.25
    #: score bonus toward the replica that recently served this request's
    #: prefix hash (its prefix cache likely holds the shared prompt
    #: pages). A CONSTANT, while the occupancy/queue/queue_wait terms are
    #: unbounded — cache affinity tips ties and small skews but never
    #: overrides a saturated replica. Below STICKINESS_MARGIN so session
    #: stickiness (exact-KV locality) outranks prefix locality.
    PREFIX_AFFINITY_BONUS = 0.3
    #: score bonus toward replicas whose /state reports the request's
    #: LoRA adapter RESIDENT — serving there skips the hot load (a row
    #: scatter + possible eviction of another tenant's warm adapter).
    #: Below PREFIX_AFFINITY_BONUS: a resident adapter is cheaper to
    #: recreate than a warm KV prefix, and any replica can load it.
    ADAPTER_AFFINITY_BONUS = 0.2
    #: fleet-hit locality: bonus toward replicas the KVIndex
    #: says HOLD this request's chain (resident or host-spilled) —
    #: landing there serves the prefix from local memory, landing
    #: elsewhere costs a cross-replica page fetch. Deliberately BELOW
    #: session stickiness (a session's exact-KV replica always
    #: outranks a chain sibling) and ABOVE adapter affinity (warm KV
    #: pages are dearer to recreate than a LoRA row); like the other
    #: affinities it is a constant against unbounded load terms, so it
    #: never beats saturation.
    KV_FLEET_BONUS = 0.25
    #: MoE expert-imbalance penalty: scales with how far the
    #: replica's hottest expert runs above the mean (imbalance − 1,
    #: clamped to [0, 1]) — an expert-parallel step is as slow as its
    #: hottest expert shard, so a skewed router prices the replica like
    #: a hot device. BOUNDED by the constant: below STICKINESS_MARGIN
    #: (session KV locality still outranks router skew — moving a
    #: session costs more than a slow expert) and above
    #: ADAPTER_AFFINITY_BONUS (a saturated expert shard outweighs a
    #: warm LoRA row). 0 on dense replicas — the term vanishes.
    MOE_IMBALANCE_PENALTY = 0.25
    _AFFINITY_MAX = 100_000

    # -- slo mode -------------------------------------------------
    #: affinity adjustments in PREDICTED-TTFT MILLISECONDS (slo mode
    #: ranks in ms, not score units). A replica whose prefix cache holds
    #: the prompt head skips most of its prefill — worth a real ms
    #: bonus; a resident adapter saves a row load; leaving the session's
    #: slice costs ICI→DCN on any future KV transfer.
    PREFIX_AFFINITY_BONUS_MS = 100.0
    ADAPTER_AFFINITY_BONUS_MS = 50.0
    KV_FLEET_BONUS_MS = 75.0
    SLICE_PENALTY_MS = 50.0
    #: a sticky session stays put unless its replica's predicted TTFT
    #: exceeds the best candidate's by this much
    STICKINESS_MARGIN_MS = 250.0

    def predicted_ttft_ms(self, st: EndpointState,
                          prompt_tokens: int = 0) -> float | None:
        """Predicted TTFT for a NEW arrival on this replica, from its
        live phase histograms + queue depth: the arrival stands
        behind ``queued`` waiting requests plus itself — admitted in
        BATCHED prefill passes of up to ``max_slots`` prompts each
        (tpuserve coalesces same-burst admissions into one [G, S]
        call, so the queue drains in ceil((queued+1)/max_slots) prefill
        rounds, not queued+1 serial prefills) — plus however long the
        current queue head has already been stuck (queue_wait_ms: a
        moving queue predicts near zero, a wedged one predicts its own
        stall). None when the replica has no histogram data at all — a
        replica that has served nothing predicts nothing — and None
        when the telemetry is STALE (no successful poll within
        STALE_AFTER): a dead replica's last happy histograms predict
        nothing either (stale-poll fix; pick() also excludes
        stale endpoints, this guards direct callers like the
        migration orchestrator and push-fed test state).

        ``prompt_tokens`` (long-context satellite): when the caller
        knows the request's prompt length AND the replica exports its
        measured ``prefill_ms_per_token`` rate, the prediction adds the
        EXCESS of this prompt's priced prefill over the histogram p50 —
        a 64k prompt is not a p50 prefill, and routing it as one
        systematically under-predicts the very requests the chunked-sp
        path exists for. 0 (or an un-priced replica) leaves the
        historical model untouched."""
        if (st.last_poll_ok_ts
                and self.clock() - st.last_poll_ok_ts
                >= self.STALE_AFTER):
            return None
        pp = st.phase_percentiles or {}
        pf = float((pp.get("prefill") or {}).get("p50", -1.0))
        if pf < 0:
            # no prefill observations yet (e.g. decode-only so far):
            # fall back to the whole-TTFT distribution
            pf = float((pp.get("ttft") or {}).get("p50", -1.0))
            if pf < 0:
                return None
        rounds = -(-(st.queued + 1) // max(1, st.max_slots))
        pred = st.queue_wait_ms + pf * rounds
        if prompt_tokens > 0 and st.prefill_ms_per_token > 0:
            # the arrival's own prefill is one of those rounds; when
            # its priced cost exceeds the p50 round, charge the excess
            pred += max(
                0.0, prompt_tokens * st.prefill_ms_per_token - pf)
        return pred

    # -- KV memory hierarchy -----------------------------------
    def note_chain(self, prefix_key: str, chain_hex: str) -> None:
        """Learn (prefix-head hash → KV chain hash) from a tpuserve
        response's x-aigw-kv-chain header: the next request sharing the
        prefix head resolves to a chain the fleet index can locate."""
        if not prefix_key or not chain_hex:
            return
        self._prefix_chain[prefix_key] = chain_hex
        self._prefix_chain.move_to_end(prefix_key)
        while len(self._prefix_chain) > self._AFFINITY_MAX:
            self._prefix_chain.popitem(last=False)

    def _chain_for(self, headers: dict[str, str] | None) -> str:
        """The request's KV chain hash: an explicit x-aigw-kv-chain
        header wins, else the chain learned for its prefix-head hash
        ("" = unknown — fleet terms vanish)."""
        h = headers or {}
        chain = h.get(KV_CHAIN_HEADER, "")
        if chain:
            return chain
        pkey = h.get(PREFIX_HEADER, "")
        return self._prefix_chain.get(pkey, "") if pkey else ""

    def kv_peers(self, chosen: str,
                 headers: dict[str, str] | None = None,
                 limit: int = 3) -> list[str]:
        """Sibling replicas the fleet index says hold this request's
        chain (healthy, fresh, excluding the chosen replica) — the
        gateway names them in x-aigw-kv-peers so a prefix miss on
        ``chosen`` becomes a cross-replica page fetch."""
        chain = self._chain_for(headers)
        if not chain:
            return []
        now = self.clock()
        out = []
        for addr in sorted(self.kv_index.replicas(chain)):
            st = self.state.get(addr)
            if (addr != chosen and st is not None and st.healthy
                    and now - st.updated_at < self.STALE_AFTER):
                out.append(addr)
        return out[:limit]

    def _slice_of(self, addr: str) -> str:
        """Effective slice of an endpoint: the slice the replica itself
        reported on /state when available (tpuserve exports
        device topology), else the configured label."""
        st = self.state.get(addr)
        if st is not None and st.slice_name:
            return st.slice_name
        e = self._by_addr.get(addr)
        return e.slice_name if e is not None else ""

    def pick(self, headers: dict[str, str] | None = None,
             explain: dict[str, Any] | None = None,
             exclude: frozenset | set | None = None) -> str | None:
        """Returns 'host:port' for the request, or None if no endpoints.

        ``explain``: optional dict the pick fills with WHY the endpoint
        won (``sticky`` session affinity held / ``prefix_affinity``
        bonus applied to the winner / ``round_robin`` blind fallback,
        plus the number of fresh candidates) — the gateway attaches it
        to the request span so a trace shows the routing decision.

        ``exclude``: replicas to skip entirely — the pre-first-byte
        failover retry re-picks with the replica that just
        refused the connection excluded, so the retry can't land on
        the same dead process the poll loop hasn't condemned yet."""
        if not self.endpoints:
            return None
        exclude = exclude or frozenset()
        now = self.clock()
        affinity_key = (headers or {}).get(AFFINITY_HEADER, "")
        prev_addr = self._affinity.get(affinity_key) if affinity_key else None
        prefix_key = (headers or {}).get(PREFIX_HEADER, "")
        prefix_addr = (self._prefix_affinity.get(prefix_key)
                       if prefix_key else None)
        adapter_key = (headers or {}).get(ADAPTER_HEADER, "")
        # long-context satellite: the request's (estimated) prompt
        # token count — context-length filter + prompt-priced TTFT
        try:
            prompt_tokens = max(0, int(
                (headers or {}).get(PROMPT_TOKENS_HEADER, 0) or 0))
        except (TypeError, ValueError):
            prompt_tokens = 0
        # fleet-hit locality: replicas the index says hold
        # this request's KV chain — resident or host-spilled
        kv_chain = self._chain_for(headers)
        kv_holders = (self.kv_index.replicas(kv_chain) if kv_chain
                      else frozenset())
        # the slice to prefer: where the session's replica lives —
        # meaningful even when that replica is unhealthy (failover
        # should land on a same-slice sibling)
        prev_slice = self._slice_of(prev_addr) if prev_addr else ""

        def score_of(e: Endpoint) -> float | None:
            st = self.state[e.address]
            if e.address in exclude:
                return None
            if not self.is_routable(e.address):
                # merged view: down, DRAINING (the controller
                # is moving its sessions off — new work must not land
                # there), or the circuit breaker is open for it
                return None
            if not (st.healthy and now - st.updated_at < self.STALE_AFTER):
                return None
            score = (
                # WORST-device KV occupancy and memory pressure: a mesh
                # replica is priced by its hottest shard —
                # device 0 looking idle says nothing when device 5
                # holds the saturated head shard. Both reduce to the
                # scalar gauges on replicas without per-device data.
                st.worst_kv_occupancy()
                + st.queued / st.max_slots
                + 0.5 * st.active_slots / st.max_slots
                + st.queue_wait_ms / 1000.0
                # MEASURED device-memory pressure (the device's memory
                # polled from /state): a replica near its HBM limit is
                # a bad home for new KV even when its slot/queue
                # numbers look fine — weights/fragmentation/adapters
                # consume HBM the kv_occupancy label can't see. 0.0 on
                # backends without memory stats — the term vanishes.
                + st.worst_hbm_frac()
            )
            if st.moe_expert_imbalance > 1.0:
                # MoE router skew: price the replica by its
                # hottest expert — bounded so load terms still dominate
                score += self.MOE_IMBALANCE_PENALTY * min(
                    1.0, st.moe_expert_imbalance - 1.0)
            if prev_slice and self._slice_of(e.address) != prev_slice:
                score += self.SLICE_PENALTY
            if prefix_addr == e.address:
                # prefix-affinity: this replica recently served this
                # prefix hash — its cache likely still holds the pages
                score -= self.PREFIX_AFFINITY_BONUS
            if adapter_key and adapter_key in st.adapters_resident:
                # adapter-affinity: the LoRA row is already loaded
                # here — serving elsewhere pays a hot load (and may
                # evict a warm adapter on the other replica)
                score -= self.ADAPTER_AFFINITY_BONUS
            if e.address in kv_holders:
                # fleet-hit locality: this replica holds the chain's
                # KV (resident or spilled) — serving here skips both
                # the re-prefill AND the cross-replica fetch
                score -= self.KV_FLEET_BONUS
            return score

        scores = {e.address: score_of(e) for e in self.endpoints}
        fresh = {a: s for a, s in scores.items() if s is not None}
        # context-length filter (long-context satellite): drop fresh
        # candidates whose advertised max_seq_len the prompt exceeds —
        # tpuserve would only 400 it after a full admission round-trip
        # (or worse, mid-stream). When EVERY fresh candidate is
        # length-filtered the request is unroutable as a matter of
        # capability, not load: raise so the gateway answers a clean
        # 400 — falling into round-robin would knowingly route to a
        # replica that must reject.
        if prompt_tokens and fresh:
            fits = {a: s for a, s in fresh.items()
                    if not (self.state[a].max_seq_len
                            and prompt_tokens
                            > self.state[a].max_seq_len)}
            if not fits:
                max_ctx = max(self.state[a].max_seq_len for a in fresh)
                if explain is not None:
                    explain.update(
                        ctx_filtered=len(fresh),
                        prompt_tokens=prompt_tokens,
                        max_ctx=max_ctx)
                raise ContextLengthError(prompt_tokens, max_ctx)
            if explain is not None and len(fits) < len(fresh):
                explain["ctx_filtered"] = len(fresh) - len(fits)
            fresh = fits
        # slo mode: rank by PREDICTED TTFT from live phase
        # histograms instead of the static score sum. Candidates with no
        # histogram data yet predict 0 (a replica that has served
        # nothing is presumed idle); only when NO candidate has data
        # does the picker fall back to static scoring — and it never
        # sheds blind.
        # offline tier routing: batch goes to the replica
        # with the MOST idle capacity — total footprint (interactive
        # slots + queue + its own class's backlog) over slot count,
        # plus KV pressure. Batch is NEVER SLO-shed: the slo branch
        # below (and its shed) is skipped entirely — a loaded fleet
        # queues batch on the least-loaded replica and lets the
        # two-class engine scheduler soak slots as they free up.
        batch_pick = (headers or {}).get(PRIORITY_HEADER, "") == "batch"
        pred_raw: dict[str, float | None] = {}
        if self.mode == "slo" and fresh and not batch_pick:
            pred_raw = {a: self.predicted_ttft_ms(self.state[a],
                                                  prompt_tokens)
                        for a in fresh}
        if batch_pick and fresh:

            def batch_load(a: str) -> float:
                st = self.state[a]
                return ((st.active_slots + st.queued + st.batch_queued)
                        / st.max_slots + st.worst_kv_occupancy())

            chosen = min(sorted(fresh), key=batch_load)
            if explain is not None:
                explain.update(
                    mode="batch", candidates=len(fresh),
                    batch_load=round(batch_load(chosen), 4))
        elif any(p is not None for p in pred_raw.values()):
            pred = {a: (p if p is not None else 0.0)
                    for a, p in pred_raw.items()}
            if self.slo_ttft_ms > 0:
                # admission control on the RAW predictions (capacity,
                # not preference): every candidate blown → shed now
                # rather than queue the request into collapse
                best_raw = min(pred.values())
                if best_raw > self.slo_ttft_ms:
                    retry = max(1, int(
                        -(-(best_raw - self.slo_ttft_ms) // 1000)))
                    if explain is not None:
                        explain.update(
                            mode="slo", shed=True, candidates=len(pred),
                            predicted_ttft_ms={
                                a: round(p, 1) for a, p in pred.items()},
                            retry_after_s=retry)
                    raise SLOShedError(retry, best_raw, self.slo_ttft_ms)
            adj = {}
            for a, p in pred.items():
                v = p
                if prev_slice and self._slice_of(a) != prev_slice:
                    v += self.SLICE_PENALTY_MS
                if prefix_addr == a:
                    v -= self.PREFIX_AFFINITY_BONUS_MS
                if adapter_key and adapter_key in \
                        self.state[a].adapters_resident:
                    v -= self.ADAPTER_AFFINITY_BONUS_MS
                if a in kv_holders:
                    v -= self.KV_FLEET_BONUS_MS
                adj[a] = v
            chosen = min(adj, key=adj.__getitem__)
            if (prev_addr in adj and adj[prev_addr]
                    <= adj[chosen] + self.STICKINESS_MARGIN_MS):
                chosen = prev_addr
            if explain is not None:
                explain.update(
                    mode="slo",
                    candidates=len(adj),
                    predicted_ttft_ms={a: round(p, 1)
                                       for a, p in pred.items()},
                    predicted_ttft_chosen_ms=round(pred[chosen], 1),
                    sticky=chosen == prev_addr and bool(affinity_key),
                    prefix_affinity=chosen == prefix_addr
                    and bool(prefix_key),
                    adapter_affinity=bool(adapter_key) and adapter_key
                    in self.state[chosen].adapters_resident,
                    kv_fleet_hit=chosen in kv_holders,
                    staleness_s=round(
                        self.state[chosen].staleness_s(now), 3),
                )
        elif not fresh:
            # no telemetry (cold start / all down): round-robin blindly
            chosen = next(self._rr)
            for _ in range(len(self.endpoints)):
                # an excluded replica just actively refused — even the
                # blind fallback must not hand the retry right back
                if chosen not in exclude:
                    break
                chosen = next(self._rr)
            if explain is not None:
                explain.update(round_robin=True, candidates=0)
        else:
            best_addr = min(fresh, key=fresh.__getitem__)
            chosen = best_addr
            # per-endpoint stickiness: stay on the session's previous
            # replica (its prefix cache lives there) unless it is now much
            # worse than the best choice
            if (
                prev_addr in fresh
                and fresh[prev_addr] <= fresh[best_addr]
                + self.STICKINESS_MARGIN
            ):
                chosen = prev_addr
            if explain is not None:
                explain.update(
                    candidates=len(fresh),
                    score=round(fresh[chosen], 4),
                    # the mesh memory term the score consumed: the
                    # worst DEVICE's fraction, not device 0's
                    hbm_frac_worst=round(
                        self.state[chosen].worst_hbm_frac(), 4),
                    sticky=chosen == prev_addr and bool(affinity_key),
                    prefix_affinity=chosen == prefix_addr
                    and bool(prefix_key),
                    adapter_affinity=bool(adapter_key) and adapter_key
                    in self.state[chosen].adapters_resident,
                    kv_fleet_hit=chosen in kv_holders,
                    # how old the chosen replica's telemetry is — the
                    # decision ring / span answer to "was this routed
                    # on current truth or near-stale data"
                    staleness_s=round(
                        self.state[chosen].staleness_s(now), 3),
                )
        if affinity_key:
            self._affinity[affinity_key] = chosen
            self._affinity.move_to_end(affinity_key)
            while len(self._affinity) > self._AFFINITY_MAX:
                self._affinity.popitem(last=False)  # LRU eviction
        if prefix_key:
            # remember where this prefix landed — the NEXT request with
            # the same prefix hash prefers the replica whose cache the
            # routing just warmed (even when load moved it this time)
            self._prefix_affinity[prefix_key] = chosen
            self._prefix_affinity.move_to_end(prefix_key)
            while len(self._prefix_affinity) > self._AFFINITY_MAX:
                self._prefix_affinity.popitem(last=False)
        return chosen
