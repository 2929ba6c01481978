"""Command line of the port (counterpart of ``aigw_tpu/cli.py``).

    python -m aigw_tpu_torch tpuserve --model tiny-random --port 8011 \\
        --device cuda --attention-backend pallas-ragged --decode-backend fused
    python -m aigw_tpu_torch tpuserve --model tiny-random --device cpu \\
        --prefill-chunk-tokens 128 --prefill-bucket-rungs 4
    python -m aigw_tpu_torch tpuserve --model tiny-random --device cpu \\
        --quantize int8 --kv-cache-dtype int8
    python -m aigw_tpu_torch tpuserve --model tiny-random --device cpu \\
        --pallas-attn --spec-tokens 4
    python -m aigw_tpu_torch tpuserve --model tiny-random --device cpu \\
        --no-prefix-cache --no-constrained-decoding
    python -m aigw_tpu_torch tpuserve --model tiny-random --device cpu \\
        --logprobs 20 --tenant-slot-cap 4
    python -m aigw_tpu_torch tpuserve --model tiny-random --device cpu \\
        --flight-entries 512 --enable-profile-endpoint
    python -m aigw_tpu_torch tpuserve --model tiny-random --device cpu \\
        --lora fr=/ckpt/fr --lora de=/ckpt/de --lora-slots 1
    python -m aigw_tpu_torch tpuserve --model tiny-random --device cpu --tp 2
    python -m aigw_tpu_torch tpuserve --model tiny-random --device cpu --sp 2
    python -m aigw_tpu_torch convert /hf/llama-3-8b checkpoints/llama-3-8b
    python -m aigw_tpu_torch run gateway.json --port 1975
    python -m aigw_tpu_torch run gateway.json --mcp-config mcp.json
    python -m aigw_tpu_torch run manifests/ --port 1975 --workers 4
    python -m aigw_tpu_torch run gateway.json --port 1975 --reuse-port
    python -m aigw_tpu_torch run kube:~/.kube/config --port 1975
    TPUSERVE_URL=http://127.0.0.1:8011 python -m aigw_tpu_torch run
    python -m aigw_tpu_torch validate manifests/
    python -m aigw_tpu_torch validate kube:in-cluster
    python -m aigw_tpu_torch status manifests/ --json
    python -m aigw_tpu_torch translate gateway.json
    python -m aigw_tpu_torch healthcheck http://127.0.0.1:1975
    python -m aigw_tpu_torch quota-service --port 1981 --dir /var/aigw-quota
    python -m aigw_tpu_torch webhook --image aigw-tpu:latest \\
        --tls-cert tls.crt --tls-key tls.key
    python -m aigw_tpu_torch core-config gateway.json -o aigw-core.json \\
        --listen-port 1975 --fallback-port 1976 --access-log core.jsonl
    python -m aigw_tpu_torch --version

With no flags a replica runs the reference's default programs: the
bucket-ladder prefill (``xla-bucketed``, chunked past
``--prefill-chunk-tokens``) and the gather decode rung; the card's
kernel path is ``--attention-backend pallas-ragged --decode-backend
fused``. ``--warm-prefill-buckets`` and ``--warm-decode-buckets`` keep
the reference's names, defaults and help text: the programs they warm
are CUDA graphs captured ahead of traffic (``tpuserve/programs.py``),
counted on ``/state`` as ``warm_programs`` and ``xla_compiles``.

``--tp N`` / ``--ep N`` shard the model over ``tp x ep`` ranks, and
``--sp N`` adds ``N`` ranks along the sequence axis (each holding the
whole ``tp``/``ep`` shard; prompts of at least
``--sp-prefill-min-tokens`` prefill with their rows split over them):
this process leads, and starts a follower process for every other of
the ``tp x sp x ep`` ranks, on ``cuda:<rank>`` (NCCL) or with ``--device
cpu`` on the CPU (gloo); they stop with it. A machine with fewer cards
than ranks is refused.

SIGTERM or SIGINT drains the replica (new generations get 503 while
live ones finish, ``--drain-grace`` at most) and exits 0; a second
signal stops it at once.

``--lora NAME=ORBAX_DIR`` (repeatable) registers an adapter restored
from an orbax directory, as the reference does; ``--lora-slots`` sizes
its device rows. ``convert HF_DIR OUT_DIR`` imports local HF safetensors
shards on the CPU and writes them as an orbax directory that a registry
row's ``orbax:`` weights (and the reference) restore. Both read and
write orbax directories through ``tensorstore`` (``models/checkpoint.py``)
and raise naming it where it is missing, as on the card machine.

``run CONFIG`` starts the gateway data plane (``gateway/server.py``) in
front of replica pools. CONFIG is a config file (JSON, or YAML: through
``pyyaml`` where it is installed, else JSON text in the ``.yaml`` file),
a bundle directory (``config/bundle.py``), a directory of Kubernetes CRD
manifests, reconciled by ``config/controller.py``: a broken object is
quarantined while the rest serves, per-object Accepted conditions go to
``<dir>/aigw-status.json``, and ``/health`` counts the objects not
accepted; or a live cluster, ``kube:<kubeconfig>`` or
``kube:in-cluster`` (``config/kube.py``: the CRDs list/watched, the
conditions merge-patched onto each object's status by the replica that
holds the ``AIGW_LEASE_NAME`` Lease; a kubeconfig is YAML through
pyyaml, else JSON text). The source is watched every
``--watch-interval`` seconds and reloaded on change; ``--port 0`` binds
a free port, which the startup line names. With no CONFIG the config is
built from the environment (``config/autoconfig.py``: ``TPUSERVE_URL``,
``OPENAI_API_KEY``, ``ANTHROPIC_API_KEY``, ``AZURE_OPENAI_*``,
``AIGW_MODELS``). ``--workers N`` runs N processes (this one and N - 1
spawned children) bound to one explicit ``--port`` with
``SO_REUSEPORT``; they share one MCP session seed, and one token-quota
budget and one Responses transcript store through ``AIGW_QUOTA_DIR`` /
``AIGW_RESPONSES_DIR`` (a temporary directory when unset).
``--reuse-port`` binds one process with ``SO_REUSEPORT``, so a
replacement gateway can bind the same port before this one is stopped: a
rolling upgrade with no refused request. SIGTERM or SIGINT stops it
after ``AIGW_DRAIN_SECONDS`` (1 s) for the requests in flight, and stops
every replica its pools' controllers launched and every worker it
spawned. ``--mcp-config FILE`` / ``--mcp-json TEXT`` take the canonical
``mcpServers`` JSON: every stdio server (``command``) is spawned and
bridged to a local Streamable-HTTP endpoint (``mcp/stdio_bridge.py``),
and all of them join the config's ``mcp`` backends on every load; the
children stop with the gateway, on every exit path (refused with
``--workers`` above 1).

``validate CONFIG|DIR|kube:...`` parses a config (or reconciles a
manifest directory or the cluster's objects once, writing no status)
and prints a summary, exit 1 on an invalid config or a rejected object;
``status DIR [--json]`` prints the manifests' Accepted conditions
(from ``aigw-status.json`` when it is current, else reconciled now),
exit 1 when any is not accepted;
``translate CONFIG`` prints the compiled runtime view as JSON;
``healthcheck [URL]`` probes ``/health`` (exit 0 when healthy);
``--version`` prints the package's version and, in a git checkout, its
revision. Each prints what ``aigw_tpu``'s does.

``quota-service`` serves the shared token-quota counters
(``gateway/ratelimit.py``, flock'd files under ``--dir``): gateways
that set ``AIGW_QUOTA_URL`` to it enforce one budget with no shared
filesystem; SIGTERM or SIGINT stops it. ``webhook`` serves the pod
mutating webhook (``config/webhook.py``: ``POST /mutate`` injects the
gateway sidecar, ``run kube:in-cluster``, into Envoy Gateway's pods),
over TLS with ``--tls-cert`` and ``--tls-key``; SIGTERM or SIGINT stops
it.

``core-config CONFIG`` compiles the config's natively servable rules
(``config/nativecore.py``) into the JSON of the C++ proxy core
(``aigw-core``, built by ``aigw_tpu_torch.native.core_binary()``), which
listens in front and relays every other request to this gateway on the
fallback address (``run --port`` equal to ``--fallback-port``); it
prints what stays on the Python path. A gateway run with
``AIGW_CORE_ACCESS_LOG`` naming the core's ``--access-log`` tails it
into spans and post-hoc costs (``obs/native_spans.py``). ``run`` builds
and loads the C++ SSE and event-stream scanners (``utils/native.py``)
before it serves, and says so after its startup line; a failed build
stops it with the compiler's output.

Flag names follow the reference's.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading

logger = logging.getLogger(__name__)

_DESCRIPTION = "aigw-tpu serving on PyTorch/CUDA"


def _build_version() -> str:
    """The package's version, with the git revision when run from this
    project's checkout (upstream stamps the same through the Go linker,
    internal/version/version.go)."""
    try:
        from importlib.metadata import version as _pkg_version

        base = _pkg_version("aigw-tpu")
    except Exception:  # noqa: BLE001 — an uninstalled checkout
        base = "0.1.0"
    try:
        import subprocess

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        # stamp only when the repository holding the package is this
        # project (not some unrelated checkout around a virtualenv)
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"], cwd=root,
            capture_output=True, text=True, timeout=2,
        ).stdout.strip()
        if not top or not os.path.isdir(os.path.join(top, "aigw_tpu_torch")):
            return base
        rev = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=root,
            capture_output=True, text=True, timeout=2,
        ).stdout.strip()
        dirty = subprocess.run(
            ["git", "status", "--porcelain"], cwd=root,
            capture_output=True, text=True, timeout=2,
        ).stdout.strip()
        if rev:
            return f"{base} ({rev}{'-dirty' if dirty else ''})"
    except Exception:  # noqa: BLE001 — no git, or not a checkout
        pass
    return base


class _VersionAction(argparse.Action):
    """A lazy ``--version``: the git calls run only when it is asked
    for."""

    def __init__(self, option_strings, dest, **kwargs):
        super().__init__(option_strings, dest, nargs=0, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        print(f"aigw-tpu {_build_version()}")
        parser.exit(0)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="aigw_tpu_torch",
                                description=_DESCRIPTION)
    p.add_argument(
        "--version", action=_VersionAction,
        help="print version (with git revision when run from a checkout)")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("convert", help="import a local HF safetensors dir "
                                       "into an orbax checkpoint usable by "
                                       "tpuserve")
    c.add_argument("hf_dir")
    c.add_argument("out_dir")
    r = sub.add_parser("run", help="run the gateway data plane")
    r.add_argument("config", nargs="?", default="",
                   help="config file (JSON, or YAML: pyyaml, else JSON "
                        "text), bundle dir, CRD manifest dir (watched "
                        "and reconciled with status conditions), or "
                        "kube:<kubeconfig>|kube:in-cluster to list/watch "
                        "the CRDs on a live cluster with Accepted "
                        "conditions patched onto object status; omit to "
                        "autoconfig from env: OPENAI_API_KEY, "
                        "ANTHROPIC_API_KEY, AZURE_OPENAI_*, TPUSERVE_URL")
    r.add_argument("--host", default="127.0.0.1")
    r.add_argument("--port", type=int, default=1975)
    r.add_argument("--watch-interval", type=float, default=5.0)
    r.add_argument("--log-level", default="info")
    r.add_argument(
        "--workers", type=int, default=1,
        help="worker processes sharing the port via SO_REUSEPORT "
             "(each runs the full data plane and watches the config; "
             "requires an explicit --port)")
    r.add_argument(
        "--reuse-port", action="store_true",
        help="bind with SO_REUSEPORT even with --workers 1, so a "
             "replacement gateway process can bind the same port and "
             "take over before this one drains (a rolling upgrade)")
    r.add_argument(
        "--mcp-config", default="",
        help="Claude-Desktop-style mcpServers JSON file: http servers "
             "route through the MCP proxy; stdio servers (command/args) "
             "are spawned and bridged to Streamable HTTP automatically "
             "(the reference's aigw run --mcp-config)")
    r.add_argument(
        "--mcp-json", default="",
        help="same as --mcp-config but inline JSON")
    cc = sub.add_parser(
        "core-config",
        help="compile the native proxy core's config (aigw-core serves "
             "eligible routes in C++; the rest fall back to the Python "
             "gateway)")
    cc.add_argument("config")
    cc.add_argument("-o", "--out", default="aigw-core.json")
    cc.add_argument("--listen-host", default="0.0.0.0")
    cc.add_argument("--listen-port", type=int, default=1975)
    cc.add_argument("--fallback-host", default="127.0.0.1")
    cc.add_argument("--fallback-port", type=int, default=1976,
                    help="where the Python gateway listens (run it "
                         "with --port matching this)")
    cc.add_argument("--access-log", default="",
                    help="JSON-lines access log for natively routed "
                         "requests (model/backend/status/duration/"
                         "token usage per line)")
    v = sub.add_parser("validate", help="validate a config file")
    v.add_argument("config")
    st = sub.add_parser(
        "status",
        help="print per-object Accepted conditions for a manifest dir "
             "(from <dir>/aigw-status.json, written by the reconciling "
             "gateway, or computed fresh when no gateway has run)")
    st.add_argument("dir", help="CRD manifest directory")
    st.add_argument("--json", action="store_true",
                    help="machine-readable output")
    t = sub.add_parser(
        "translate",
        help="compile a config and print the normalized runtime view "
             "(resolved translator pairs, auth kinds, quota rules) as JSON")
    t.add_argument("config")
    h = sub.add_parser(
        "healthcheck",
        help="probe a gateway or replica /health endpoint (exit 0 = "
             "healthy)")
    h.add_argument("url", nargs="?", default="http://127.0.0.1:1975")
    h.add_argument("--timeout", type=float, default=5.0)
    q = sub.add_parser(
        "quota-service",
        help="run the shared quota service: gateways on other nodes "
             "point AIGW_QUOTA_URL here so one token budget is enforced "
             "with no shared filesystem")
    q.add_argument("--host", default="0.0.0.0")
    q.add_argument("--port", type=int, default=1981)
    q.add_argument("--dir", default="/tmp/aigw-quota",
                   help="counter storage (flock'd files; a shared volume "
                        "lets the service itself replicate)")
    w = sub.add_parser(
        "webhook",
        help="run the pod mutating webhook: injects the aigw gateway "
             "sidecar into Envoy Gateway pods (the reference's "
             "gateway_mutator role; K8s requires TLS — pass "
             "--tls-cert/--tls-key)")
    w.add_argument("--host", default="0.0.0.0")
    w.add_argument("--port", type=int, default=9443)
    w.add_argument("--image", required=True,
                   help="sidecar image (must provide `python -m "
                        "aigw_tpu_torch` as entrypoint)")
    w.add_argument("--gateway-port", type=int, default=1975)
    w.add_argument("--tls-cert", default="")
    w.add_argument("--tls-key", default="")
    s = sub.add_parser("tpuserve", help="run the serving engine")
    s.add_argument("--model", required=True,
                   help="model name (see aigw_tpu_torch.models.registry)")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8011)
    s.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the CUDA kernels; cpu their plain "
                        "PyTorch versions")
    s.add_argument("--max-batch-size", type=int, default=8)
    s.add_argument("--max-seq-len", type=int, default=2048)
    s.add_argument("--page-size", type=int, default=128)
    s.add_argument("--hbm-pages", type=int, default=0,
                   help="KV pages to allocate (0 = auto)")
    s.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree (devices on the mesh)")
    s.add_argument("--ep", type=int, default=1,
                   help="expert-parallel degree (MoE families; mesh "
                        "is dp=1 × tp × sp × ep)")
    s.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel degree: prompts >= "
                        "--sp-prefill-min-tokens prefill via ring "
                        "attention over the sp mesh axis")
    s.add_argument("--sp-prefill-min-tokens", type=int, default=1024,
                   help="minimum prompt length routed through the "
                        "sequence-parallel prefill path")
    s.add_argument("--decode-steps-per-tick", type=int, default=8,
                   help="decode steps per host round-trip (the adaptive "
                        "window's max; it shrinks to 1/4 under pressure)")
    s.add_argument("--no-adaptive-window", action="store_true")
    s.add_argument("--sync-transfers", action="store_true",
                   help="blocking token copy at drain time instead of an "
                        "async copy issued at dispatch")
    s.add_argument("--no-first-token-fast-path", action="store_true")
    s.add_argument("--prefill-chunk-tokens", type=int, default=256,
                   help="chunk prompts longer than this into fixed-size "
                        "prefill steps with decode ticks interleaved (0 = "
                        "off; the bucketed backend)")
    s.add_argument("--prefill-bucket-rungs", type=int, default=2,
                   choices=[1, 2, 4],
                   help="prefill bucket rungs per octave: 1 = powers of "
                        "two, 2 adds a 1.5xS rung, 4 adds 1.25x/1.5x/1.75x")
    s.add_argument("--warm-prefill-buckets", type=int, default=0,
                   help="pre-compile batched-prefill programs for the N "
                        "smallest prompt buckets at startup (all group "
                        "sizes) so a traffic burst never pays an XLA "
                        "compile")
    s.add_argument("--warm-decode-buckets", type=int, default=0,
                   help="pre-compile the decode-window ladder (and "
                        "row-update scatters) at the N smallest pow2 PAGE "
                        "buckets so the first admission at any covered "
                        "length never compiles a decode program on the "
                        "hot path (0 = only the quiesced bucket)")
    s.add_argument("--pallas-attn", action="store_true",
                   help="the chained decode rung: scatter, then the paged "
                        "attention kernel")
    s.add_argument("--attention-backend", default="xla-bucketed",
                   choices=["xla-bucketed", "pallas-ragged"],
                   help="prefill backend: xla-bucketed pads each prompt "
                        "to a bucket rung (dense attention); pallas-ragged "
                        "packs a burst into token-budget calls through "
                        "the ragged prefill kernel")
    s.add_argument("--decode-backend", default="auto",
                   choices=["auto", "chained", "fused"])
    s.add_argument("--kv-cache-dtype", default="bfloat16",
                   choices=["bfloat16", "float32", "int8", "int4"],
                   help="KV pages: int8/int4 store quantized rows with "
                        "per-row, per-head float32 scales")
    s.add_argument("--quantize", default="", choices=["", "int8", "int4"],
                   help="weight-only quantization: int8 (W8A16) or int4 "
                        "(W4A16, group-128 scales)")
    s.add_argument("--logprobs", type=int, default=0,
                   help="enable per-token logprobs: max top_logprobs "
                        "servable per request (0 = off; OpenAI caps "
                        "requests at 20); exclusive with --spec-tokens")
    s.add_argument("--spec-tokens", type=int, default=0,
                   help="speculative decoding: max draft tokens verified "
                        "per decode step (0 = off). Drafts come from n-gram "
                        "prompt lookup; an adaptive per-slot ladder "
                        "collapses to plain decode when acceptance is poor")
    s.add_argument("--no-spec-adaptive", action="store_true",
                   help="pin the draft length at --spec-tokens instead of "
                        "the adaptive rung ladder")
    s.add_argument("--no-speculation", action="store_true",
                   help="force speculative decoding off (overrides "
                        "--spec-tokens)")
    s.add_argument("--no-prefix-cache", action="store_true",
                   help="disable automatic prefix caching (shared prompt "
                        "prefixes then prefill again on every request)")
    s.add_argument("--no-constrained-decoding", action="store_true",
                   help="disable grammar-constrained decoding "
                        "(response_format json modes + tool calling); such "
                        "requests then 400 with a clear error instead of "
                        "being enforced")
    s.add_argument("--lora", action="append", default=[],
                   metavar="NAME=ORBAX_DIR",
                   help="register a LoRA adapter in the zoo (repeatable); "
                        "served as model '<base>:<name>'")
    s.add_argument("--lora-slots", type=int, default=0,
                   help="device rows for resident adapters; the rest of "
                        "the zoo loads on demand with refcounted LRU "
                        "eviction (0 = one row per registered adapter)")
    s.add_argument("--tenant-slot-cap", type=int, default=0,
                   help="max in-flight decode slots one tenant "
                        "(x-aigw-tenant / adapter suffix) may hold: the "
                        "fairness guard against one tenant's burst "
                        "starving others (0 = off)")
    s.add_argument("--kv-host-bytes", type=int, default=0,
                   help="byte budget of the host KV spill tier: prefix "
                        "pages evicted under pool pressure are copied to "
                        "host memory and revived by later hits instead "
                        "of prefilled again; 0 disables it")
    s.add_argument("--ragged-chunk-tokens", type=int, default=256)
    s.add_argument("--max-queued-requests", type=int, default=256)
    s.add_argument("--flight-entries", type=int, default=256,
                   help="request timelines the flight recorder keeps "
                        "(GET /debug/requests)")
    s.add_argument("--enable-profile-endpoint", action="store_true",
                   help="serve GET /debug/profile?seconds=N (a "
                        "torch.profiler capture; off by default: a "
                        "profiler on the data port is an inspection "
                        "surface)")
    s.add_argument("--drain-grace", type=float, default=30.0,
                   help="on SIGTERM/SIGINT, how long live requests may "
                        "take to finish before the replica stops")
    return p


def engine_config(args):
    from aigw_tpu_torch.tpuserve.engine import EngineConfig

    return EngineConfig(
        max_batch_size=args.max_batch_size,
        max_seq_len=args.max_seq_len,
        page_size=args.page_size,
        num_pages=args.hbm_pages,
        decode_steps_per_tick=args.decode_steps_per_tick,
        enable_prefix_cache=not args.no_prefix_cache,
        constrained_decoding=not args.no_constrained_decoding,
        adaptive_decode_window=not args.no_adaptive_window,
        async_transfers=not args.sync_transfers,
        first_token_fast_path=not args.no_first_token_fast_path,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        prefill_bucket_rungs=args.prefill_bucket_rungs,
        warm_prefill_buckets=args.warm_prefill_buckets,
        warm_decode_buckets=args.warm_decode_buckets,
        pallas_attn=args.pallas_attn,
        attention_backend=args.attention_backend,
        decode_backend=args.decode_backend,
        kv_cache_dtype=args.kv_cache_dtype,
        spec_tokens=0 if args.no_speculation else args.spec_tokens,
        spec_adaptive=not args.no_spec_adaptive,
        ragged_chunk_tokens=args.ragged_chunk_tokens,
        max_queued_requests=args.max_queued_requests,
        sp_prefill_min_tokens=args.sp_prefill_min_tokens,
        logprobs_topk=args.logprobs,
        tenant_slot_cap=args.tenant_slot_cap,
        kv_host_bytes=args.kv_host_bytes,
    )


def lora_adapters(specs: list[str]) -> dict[str, dict]:
    """``--lora NAME=ORBAX_DIR`` values → the zoo: each directory
    restored on the CPU (the adapter store keeps a host copy and loads
    rows on demand)."""
    from aigw_tpu_torch.models.checkpoint import restore_checkpoint

    adapters = {}
    for spec in specs:
        name, _, path = spec.partition("=")
        if not name or not path:
            raise ValueError(f"--lora expects NAME=ORBAX_DIR, got {spec!r}")
        adapters[name] = restore_checkpoint(path, device="cpu")
    return adapters


def convert(hf_dir: str, out_dir: str) -> int:
    """``convert``: HF shards imported on the CPU (bf16), written as an
    orbax directory."""
    from aigw_tpu_torch.models.checkpoint import (
        import_hf_checkpoint,
        save_checkpoint,
    )

    params = import_hf_checkpoint(hf_dir, device="cpu")
    save_checkpoint(params, out_dir)
    print(f"converted {len(params)} tensors -> {out_dir}")
    return 0


async def run_gateway_cli(args, reuse_port: bool = False) -> int:
    """``run``: the gateway until SIGTERM or SIGINT."""
    import asyncio
    import dataclasses

    from aigw_tpu_torch.config.runtime import RuntimeConfig
    from aigw_tpu_torch.config.watcher import ConfigWatcher
    from aigw_tpu_torch.gateway.server import run_gateway
    from aigw_tpu_torch.utils import native

    # the C++ scanners are built and loaded before anything is served
    # (nothing is on the loop yet), so no compile lands on it mid-stream;
    # a failed build raises with the compiler's output
    scanner = native.load()
    holder = {}

    def on_reload(rc) -> None:
        if "server" in holder:
            holder["server"].set_runtime(rc)

    # --mcp-config / --mcp-json: stdio servers are spawned and bridged
    # first, then every server (http and bridged) joins the MCP proxy's
    # backends, again on every reload through the watcher's transform
    bridges: list = []
    transform = None
    tailer = None
    mcp_text = ""
    if args.mcp_config:
        with open(os.path.expanduser(args.mcp_config),
                  encoding="utf-8") as f:
            mcp_text = f.read()
    elif args.mcp_json:
        mcp_text = args.mcp_json
    try:
        if mcp_text:
            from aigw_tpu_torch.mcp.stdio_bridge import (
                parse_mcp_servers,
                start_bridges,
            )

            try:
                http_backends, stdio_specs = parse_mcp_servers(mcp_text)
                bridged_backends, bridges = await start_bridges(stdio_specs)
            except ValueError as e:
                print(f"config error: {e}", file=sys.stderr)
                return 1
            mcp_backends = http_backends + bridged_backends
            print(f"mcp: {len(mcp_backends)} server(s): "
                  f"{', '.join(b['name'] for b in mcp_backends)}"
                  + (f" ({len(bridged_backends)} stdio-bridged)"
                     if bridged_backends else ""),
                  flush=True)

            def transform(cfg):
                mcp = dict(cfg.mcp or {})
                existing = list(mcp.get("backends") or ())
                have = {b.get("name") for b in existing}
                mcp["backends"] = existing + [
                    b for b in mcp_backends if b["name"] not in have]
                return dataclasses.replace(cfg, mcp=mcp)

        watcher = None
        if args.config:
            watcher = ConfigWatcher(args.config, on_reload,
                                    interval=args.watch_interval,
                                    transform=transform)
            runtime = watcher.load_initial()
        else:
            from aigw_tpu_torch.config.autoconfig import autoconfig_from_env

            cfg = autoconfig_from_env()
            if transform is not None:
                cfg = transform(cfg)
            print(f"autoconfig: {len(cfg.backends)} backend(s): "
                  f"{', '.join(b.name for b in cfg.backends)}", flush=True)
            runtime = RuntimeConfig.build(cfg)
        server = await run_gateway(runtime, host=args.host, port=args.port,
                                   reuse_port=reuse_port)
        holder["server"] = server
        if watcher is not None:
            server.conditions_fn = watcher.not_accepted
            await watcher.start()
        # native-core telemetry: when the C++ core's access log is
        # shared with us (AIGW_CORE_ACCESS_LOG), tail it into spans and
        # post-hoc costs (obs/native_spans.py)
        core_log = os.environ.get("AIGW_CORE_ACCESS_LOG", "")
        if core_log:
            from aigw_tpu_torch.obs.native_spans import (
                NativeLogTailer,
                make_cost_fn,
            )

            tailer = NativeLogTailer(
                core_log, server.tracer,
                cost_fn=make_cost_fn(
                    lambda: getattr(holder.get("server"), "_runtime",
                                    None),
                    server.cost_sink))
            tailer.start()
            print(f"native-core telemetry: tailing {core_log}",
                  flush=True)
        print(f"gateway listening on http://{args.host}:{server.port}",
              flush=True)
        print(f"native scanners: SSE and event-stream parsing in C++ "
              f"({os.path.basename(scanner._name)})", flush=True)
        loop = asyncio.get_running_loop()
        stop = asyncio.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        try:
            drain = float(os.environ.get("AIGW_DRAIN_SECONDS", "1.0"))
        except ValueError:
            drain = 1.0
        if watcher is not None:
            await watcher.stop()
        if tailer is not None:
            await asyncio.to_thread(tailer.stop)
        await server.stop(grace=max(0.0, drain))
        return 0
    finally:
        # the stdio children stop on every exit path: a config error or a
        # failed bind must not orphan them
        for bridge in bridges:
            await bridge.stop()


def run_gateway_workers(args) -> int:
    """``run --workers N``: N processes share the port through
    ``SO_REUSEPORT``, the kernel spreading accepted connections over
    them (CPython's GIL caps one process at one core). Each runs the
    whole data plane with its own config watcher. MCP session tokens
    are sealed with one process-group seed, and the token-quota budget
    and the Responses transcripts are shared through flock'd files
    (``AIGW_QUOTA_DIR``, ``AIGW_RESPONSES_DIR``), all inherited through
    the spawn's environment."""
    import asyncio
    import multiprocessing
    import secrets

    if args.port == 0:
        print("--workers requires an explicit --port (SO_REUSEPORT "
              "workers must bind the same port)", file=sys.stderr)
        return 1
    os.environ.setdefault("AIGW_MCP_SESSION_SEED", secrets.token_hex(32))
    if not (os.environ.get("AIGW_QUOTA_DIR")
            and os.environ.get("AIGW_RESPONSES_DIR")):
        import atexit
        import shutil
        import tempfile

        shared = tempfile.mkdtemp(prefix=f"aigw-shared-{args.port}-")
        atexit.register(shutil.rmtree, shared, ignore_errors=True)
        os.environ.setdefault("AIGW_QUOTA_DIR",
                              os.path.join(shared, "quota"))
        os.environ.setdefault("AIGW_RESPONSES_DIR",
                              os.path.join(shared, "responses"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_gateway_worker_main, args=(args,),
                         daemon=True)
             for _ in range(args.workers - 1)]
    for proc in procs:
        proc.start()
    try:
        return asyncio.run(run_gateway_cli(args, reuse_port=True))
    finally:
        for proc in procs:
            proc.terminate()
        for proc in procs:
            proc.join(timeout=5)


def _gateway_worker_main(args) -> None:
    import asyncio

    _log_setup(args.log_level)
    asyncio.run(run_gateway_cli(args, reuse_port=True))


def validate(config: str) -> int:
    """``validate``: parse a config, or reconcile a manifest directory or
    a cluster's objects once (a dry run: the status goes to a temporary
    file, nothing is patched), and print a summary; exit 1 when it is
    invalid or an object is not accepted."""
    import tempfile

    from aigw_tpu_torch.config.controller import Reconciler, is_manifest_dir
    from aigw_tpu_torch.config.model import load_config

    def report_rejections(rec) -> int:
        bad = sorted(rec.not_accepted().items())
        for key, cond in bad:
            print(f"NOT ACCEPTED {key}: {cond['message']}", file=sys.stderr)
        return len(bad)

    try:
        if config.startswith("kube:"):
            from aigw_tpu_torch.config.kube import (
                KubeReconciler,
                KubeSource,
                parse_kube_target,
            )

            source = KubeSource(parse_kube_target(config))
            source.start()
            try:
                if not source.wait_synced(30.0):
                    print("INVALID: API server never synced",
                          file=sys.stderr)
                    return 1
                with tempfile.NamedTemporaryFile(suffix=".json") as tf:
                    rec = KubeReconciler(source, status_path=tf.name,
                                         leader_election=False,
                                         dry_run=True)
                    cfg = rec.load()
                if report_rejections(rec):
                    return 1
            finally:
                source.stop()
        elif is_manifest_dir(config):
            with tempfile.NamedTemporaryFile(suffix=".json") as tf:
                rec = Reconciler(config, status_path=tf.name)
                cfg = rec.load()
            if report_rejections(rec):
                return 1
        else:
            cfg = load_config(config)
    except (OSError, ValueError) as e:  # ConfigError is a ValueError
        print(f"INVALID: {e}", file=sys.stderr)
        return 1
    print(
        f"OK: {len(cfg.backends)} backends, {len(cfg.routes)} routes, "
        f"{len(cfg.models)} models, {len(cfg.llm_request_costs)} cost metrics"
    )
    return 0


def status(directory: str, as_json: bool) -> int:
    """``status``: the manifests' Accepted conditions. The directory is
    always reconciled now (a dry run), so the exit code reflects the
    manifests as they are; a gateway's ``aigw-status.json`` is shown
    instead only when its statuses and checksums match that view (a
    stale file never masks an edit)."""
    import json
    import tempfile

    from aigw_tpu_torch.config.controller import (
        STATUS_FILE,
        Reconciler,
        is_manifest_dir,
    )

    if not is_manifest_dir(directory):
        print(f"{directory}: not a CRD manifest directory", file=sys.stderr)
        return 2
    with tempfile.NamedTemporaryFile(suffix=".json") as tf:
        rec = Reconciler(directory, status_path=tf.name)
        rec.load()
    conditions = rec.conditions()
    source = "live"
    status_file = os.path.join(directory, STATUS_FILE)
    if os.path.exists(status_file):
        try:
            with open(status_file, encoding="utf-8") as f:
                file_conds = json.load(f).get("objects", {})
        except (OSError, json.JSONDecodeError):
            file_conds = None

        def view(c: dict) -> dict:
            return {k: (v.get("status"), v.get("observedChecksum"))
                    for k, v in c.items()}

        if file_conds and view(file_conds) == view(conditions):
            conditions = file_conds
            source = STATUS_FILE
        elif file_conds is not None:
            source = f"live ({STATUS_FILE} stale)"
    if as_json:
        print(json.dumps({"source": source, "objects": conditions},
                         indent=1, sort_keys=True))
        return 0 if all(c.get("status") == "True"
                        for c in conditions.values()) else 1
    bad = 0
    for key in sorted(conditions):
        cond = conditions[key]
        accepted = cond.get("status") == "True"
        bad += not accepted
        mark = "Accepted" if accepted else "NOT ACCEPTED"
        line = f"{mark:13s} {key}"
        if not accepted:
            line += f"  [{cond.get('reason', '')}] {cond.get('message', '')}"
        print(line)
    print(f"-- {len(conditions)} objects, {bad} not accepted "
          f"(source: {source})")
    return 1 if bad else 0


def translate(config: str) -> int:
    """``translate``: the compiled runtime view as JSON: each route
    rule's backends with their schema, auth kind and whether an OpenAI
    chat request translates to them; the models, costs, quota rules and
    MCP backends."""
    import json

    from aigw_tpu_torch.config.model import (
        APISchemaName,
        ConfigError,
        load_config,
    )
    from aigw_tpu_torch.config.runtime import RuntimeConfig
    from aigw_tpu_torch.translate import (
        Endpoint,
        TranslationError,
        get_translator,
    )

    try:
        cfg = load_config(config)
        rc = RuntimeConfig.build(cfg)
    except ConfigError as e:
        print(f"INVALID: {e}", file=sys.stderr)
        return 1
    routes = []
    for route in cfg.routes:
        rules = []
        for rule in route.rules:
            backends = []
            for ref in rule.backends:
                b = cfg.backend(ref.backend)
                try:
                    get_translator(Endpoint.CHAT_COMPLETIONS,
                                   APISchemaName.OPENAI, b.schema.name)
                    chat_ok = True
                except TranslationError:
                    chat_ok = False
                backends.append({
                    "backend": ref.backend,
                    "weight": ref.weight,
                    "priority": ref.priority,
                    "schema": b.schema.name.value,
                    "auth": b.auth.kind.value,
                    "chat_translation": chat_ok,
                })
            rules.append({
                "models": list(rule.models),
                "model_prefixes": list(rule.model_prefixes),
                "backends": backends,
            })
        routes.append({"name": route.name, "rules": rules})
    print(json.dumps({
        "version": cfg.version,
        "routes": routes,
        "models": [m.name for m in cfg.models],
        "costs": [c.to_dict() for c in cfg.llm_request_costs],
        "quotas": len(rc.rate_limiter.rules),
        "mcp_backends": len((cfg.mcp or {}).get("backends", [])),
    }, indent=2))
    return 0


def core_config(args) -> int:
    """``core-config``: prints and writes what the reference's does."""
    from aigw_tpu_torch.config.model import ConfigError, load_config
    from aigw_tpu_torch.config.nativecore import (
        compile_core_config,
        write_core_config,
    )

    try:
        cfg = load_config(args.config)
    except ConfigError as e:
        print(f"INVALID: {e}", file=sys.stderr)
        return 1
    core, skipped = compile_core_config(
        cfg,
        listen_host=args.listen_host,
        listen_port=args.listen_port,
        fallback_host=args.fallback_host,
        fallback_port=args.fallback_port,
        access_log_path=args.access_log,
    )
    write_core_config(args.out, core)
    print(f"{args.out}: {len(core['rules'])} native rules, "
          f"fallback {args.fallback_host}:{args.fallback_port}")
    for s in skipped:
        print(f"  python-path: {s}")
    if cfg.llm_request_costs and args.access_log:
        # without the tailer, native requests' costs are silently never
        # computed: make the wiring requirement explicit
        print(f"  REMINDER: run the gateway with "
              f"AIGW_CORE_ACCESS_LOG={args.access_log} so native "
              f"requests get spans + post-hoc cost accounting")
    return 0


def healthcheck(url: str, timeout: float) -> int:
    """``healthcheck``: GET ``<url>/health``; exit 0 and print it when
    its status is ``ok``."""
    import json
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url.rstrip("/") + "/health",
                                    timeout=timeout) as resp:
            data = json.loads(resp.read())
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"UNHEALTHY: {e}", file=sys.stderr)
        return 1
    if data.get("status") != "ok":
        print(f"UNHEALTHY: {data}", file=sys.stderr)
        return 1
    print(json.dumps(data))
    return 0


def _log_setup(level: str) -> None:
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s %(message)s")


async def run_quota_service(args) -> int:
    """``quota-service``: the counters' HTTP service until SIGTERM or
    SIGINT."""
    import asyncio

    from aigw_tpu_torch.gateway.ratelimit import quota_service

    server = quota_service(args.dir)
    port = await server.start(args.host, args.port)
    print(f"quota service listening on http://{args.host}:{port} "
          f"(dir={args.dir})", flush=True)
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await server.stop()
    return 0


async def run_webhook(args, ssl_ctx) -> int:
    """``webhook``: the mutating webhook's server until SIGTERM or
    SIGINT."""
    import asyncio

    from aigw_tpu_torch.config.webhook import webhook_app

    server = webhook_app(args.image, port=args.gateway_port)
    await server.start(args.host, args.port, ssl=ssl_ctx)
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await server.stop()
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "convert":
        return convert(args.hf_dir, args.out_dir)
    if args.cmd == "webhook":
        import asyncio
        import ssl

        logging.basicConfig(level=logging.INFO)
        if bool(args.tls_cert) != bool(args.tls_key):
            # half a TLS pair fails loudly: with failurePolicy Ignore on
            # the API server's side, a webhook silently on plain HTTP
            # would just never mutate a pod
            print("webhook: --tls-cert and --tls-key must be provided "
                  "together", file=sys.stderr)
            return 1
        ssl_ctx = None
        if args.tls_cert and args.tls_key:
            ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ssl_ctx.load_cert_chain(args.tls_cert, args.tls_key)
        print(f"webhook listening on "
              f"{'https' if ssl_ctx else 'http'}://{args.host}:{args.port}"
              f"/mutate (sidecar image {args.image})", flush=True)
        return asyncio.run(run_webhook(args, ssl_ctx))
    if args.cmd == "quota-service":
        import asyncio

        logging.basicConfig(level=logging.INFO)
        return asyncio.run(run_quota_service(args))
    if args.cmd == "core-config":
        return core_config(args)
    if args.cmd in ("validate", "status", "translate", "healthcheck"):
        _log_setup("info")
        if args.cmd == "validate":
            return validate(args.config)
        if args.cmd == "status":
            return status(args.dir, args.json)
        if args.cmd == "translate":
            return translate(args.config)
        return healthcheck(args.url, args.timeout)
    if args.cmd == "run":
        import asyncio

        from aigw_tpu_torch.config.model import ConfigError

        _log_setup(args.log_level)
        try:
            if args.workers > 1:
                if args.mcp_config or args.mcp_json:
                    # every worker would spawn its own copy of each stdio
                    # server, and SO_REUSEPORT would spread one MCP
                    # session over diverging children
                    print("config error: --mcp-config/--mcp-json is "
                          "incompatible with --workers > 1 (stateful "
                          "stdio servers would be spawned per worker); "
                          "bridge the server once and use an http url",
                          file=sys.stderr)
                    return 1
                return run_gateway_workers(args)
            return asyncio.run(run_gateway_cli(args,
                                               reuse_port=args.reuse_port))
        except ConfigError as e:
            print(f"config error: {e}", file=sys.stderr)
            return 1
    adapters = lora_adapters(args.lora)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s "
                               "%(message)s")
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    server = TPUServeServer(args.model, engine_config(args),
                            device=args.device, host=args.host,
                            port=args.port, quantize=args.quantize,
                            lora_adapters=adapters or None,
                            lora_slots=args.lora_slots,
                            flight_entries=args.flight_entries,
                            enable_profile_endpoint=(
                                args.enable_profile_endpoint),
                            tp=args.tp, ep=args.ep, sp=args.sp)
    # the handler runs on the main thread between bytecodes: it only
    # records the signal; the loop below drains (the first) or stops
    # at once (the second)
    signalled = threading.Event()
    insist = threading.Event()

    def on_signal(*_) -> None:
        if signalled.is_set():
            insist.set()
        signalled.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, on_signal)
    server.start()
    print(f"listening on http://{args.host}:{server.port}", flush=True)
    try:
        while not signalled.wait(0.5):
            pass
        logger.info("signal received: draining (grace %.0fs)",
                    args.drain_grace)
        drained = server.drain(args.drain_grace, stop=insist)
        logger.info("drain %s; shutting down",
                    "complete" if drained else
                    "cut by a second signal" if insist.is_set()
                    else "timed out")
    finally:
        server.stop()
    return 0
