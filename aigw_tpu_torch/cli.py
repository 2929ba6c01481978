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

With no flags a replica runs the reference's default programs: the
bucket-ladder prefill (``xla-bucketed``, chunked past
``--prefill-chunk-tokens``) and the gather decode rung; the card's
kernel path is ``--attention-backend pallas-ragged --decode-backend
fused``. ``--warm-prefill-buckets`` and ``--warm-decode-buckets`` keep
the reference's names, defaults and help text: the programs they warm
are CUDA graphs captured ahead of traffic (``tpuserve/programs.py``),
counted on ``/state`` as ``warm_programs`` and ``xla_compiles``.

SIGTERM or SIGINT drains the replica (new generations get 503 while
live ones finish, ``--drain-grace`` at most) and exits 0; a second
signal stops it at once.

``--lora NAME=DIR`` names an adapter checkpoint, which the reference
reads with orbax; the port has no orbax (nor does the card machine), so
it refuses the flag with that reason until checkpoints are ported
(ROADMAP queue 1, checkpoints). A zoo is served from Python instead:
``TPUServeServer(..., lora_adapters=..., lora_slots=...)``.
``--lora-slots`` is wired through.

Only the ``tpuserve`` subcommand is ported; the gateway and the other
subcommands stay JAX-package code, and the gateway can front this
replica over HTTP. Flag names follow the reference's ``tpuserve``.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading

logger = logging.getLogger(__name__)

_DESCRIPTION = "aigw-tpu serving on PyTorch/CUDA"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="aigw_tpu_torch",
                                description=_DESCRIPTION)
    sub = p.add_subparsers(dest="cmd", required=True)
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
                        "served as model '<base>:<name>'. Refused: "
                        "adapter checkpoints are orbax, not ported yet")
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
        logprobs_topk=args.logprobs,
        tenant_slot_cap=args.tenant_slot_cap,
        kv_host_bytes=args.kv_host_bytes,
    )


def lora_adapters(specs: list[str]) -> dict[str, dict]:
    """``--lora NAME=DIR`` values → the zoo. The reference restores each
    DIR with orbax, which the port lacks: a well-formed value raises
    NotImplementedError with that reason, as the registry's ``orbax:``
    weights do."""
    for spec in specs:
        name, _, path = spec.partition("=")
        if not name or not path:
            raise ValueError(f"--lora expects NAME=ORBAX_DIR, got {spec!r}")
        raise NotImplementedError(
            f"--lora {spec}: adapter checkpoints are orbax directories, "
            "and checkpoint loading is not ported yet (ROADMAP queue 1: "
            "checkpoints); pass lora_adapters to TPUServeServer instead")
    return {}


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
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
                                args.enable_profile_endpoint))
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
