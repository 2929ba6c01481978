"""Command line of the port (counterpart of ``aigw_tpu/cli.py``).

    python -m aigw_tpu_torch tpuserve --model tiny-random --port 8011 \\
        --device cuda --attention-backend pallas-ragged --decode-backend fused
    python -m aigw_tpu_torch tpuserve --model tiny-random --device cpu \\
        --quantize int8 --kv-cache-dtype int8
    python -m aigw_tpu_torch tpuserve --model tiny-random --device cpu \\
        --pallas-attn --spec-tokens 4
    python -m aigw_tpu_torch tpuserve --model tiny-random --device cpu \\
        --no-prefix-cache

Only the ``tpuserve`` subcommand is ported; the gateway and the other
subcommands stay JAX-package code, and the gateway can front this
replica over HTTP. Flag names follow the reference's ``tpuserve``.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading

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
    s.add_argument("--pallas-attn", action="store_true",
                   help="the chained decode rung: scatter, then the paged "
                        "attention kernel")
    s.add_argument("--attention-backend", default="xla-bucketed",
                   choices=["xla-bucketed", "pallas-ragged"],
                   help="prefill backend; only pallas-ragged is ported "
                        "and xla-bucketed resolves to it (see /state)")
    s.add_argument("--decode-backend", default="auto",
                   choices=["auto", "chained", "fused"])
    s.add_argument("--kv-cache-dtype", default="bfloat16",
                   choices=["bfloat16", "float32", "int8", "int4"],
                   help="KV pages: int8/int4 store quantized rows with "
                        "per-row, per-head float32 scales")
    s.add_argument("--quantize", default="", choices=["", "int8", "int4"],
                   help="weight-only quantization: int8 (W8A16) or int4 "
                        "(W4A16, group-128 scales)")
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
    s.add_argument("--ragged-chunk-tokens", type=int, default=256)
    s.add_argument("--max-queued-requests", type=int, default=256)
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
        adaptive_decode_window=not args.no_adaptive_window,
        async_transfers=not args.sync_transfers,
        first_token_fast_path=not args.no_first_token_fast_path,
        pallas_attn=args.pallas_attn,
        attention_backend=args.attention_backend,
        decode_backend=args.decode_backend,
        kv_cache_dtype=args.kv_cache_dtype,
        spec_tokens=0 if args.no_speculation else args.spec_tokens,
        spec_adaptive=not args.no_spec_adaptive,
        ragged_chunk_tokens=args.ragged_chunk_tokens,
        max_queued_requests=args.max_queued_requests,
    )


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s "
                               "%(message)s")
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    server = TPUServeServer(args.model, engine_config(args),
                            device=args.device, host=args.host,
                            port=args.port, quantize=args.quantize)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    server.start()
    print(f"listening on http://{args.host}:{server.port}", flush=True)
    try:
        stop.wait()
    finally:
        server.stop()
    return 0
