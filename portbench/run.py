"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout, on a machine with the cell's cards.
The program under test is ``aigw_tpu_torch`` alone. Everything about a
cell is found by name: its configuration (``configs/<config>.json``),
its traffic mix (``traffic/<traffic>.json``, driven by
``arrivals/<arrival>.py`` in the load generator), the limits its output
check holds (``limits/<cell>.json``), and each metric's reader
(``e2e/<name>.py`` for an end-to-end metric, ``metrics/<name>.py`` for
a per-layer one).

A run: draw the weights on the card from the seed; start the replica
(``TPUServeServer``) in this process, warmed for the cell's shapes;
start the gateway (``python -m aigw_tpu_torch run``) in a child process
when the mix goes through it; start the load generator
(``loadgen.py``, the standard library only) in another child; measure
the window it announces, the device trace of a slice of it with
``--trace 1``; stop the children and the replica; check the served
tokens against the plain reference (``check.py``); print the result as
the last line of standard output, and the numbers compared beside their
limits as the last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level modules that may not be loaded in a run: JAX, its
#: libraries, and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "aigw_tpu")
#: the engine histograms the readers take means of
PHASES = ("queue_wait", "ttft", "decode_per_token")
#: the /state counters the readers take deltas of, and the backlog the
#: sweep reads
STATE_KEYS = ("tokens_generated", "decode_steps", "prefix_tokens_reused",
              "queued", "active_slots", "xla_compiles")


def cache_env() -> dict[str, str]:
    """Fixed build and cache directories inside the checkout (the
    port's own kernel and native builds already go to ``build/``), and
    no JAX for any library that would load it."""
    build = os.path.join(ROOT, "build")
    return {"TRITON_CACHE_DIR": os.path.join(build, "triton"),
            "TORCH_EXTENSIONS_DIR": os.path.join(build, "torch_extensions"),
            "USE_FLAX": "0", "USE_JAX": "0"}


os.environ.update(cache_env())
for p in (ROOT, HERE, os.path.join(HERE, "metrics")):
    if p not in sys.path:
        sys.path.insert(0, p)


#: seconds after which, and every so many after, a run still going
#: prints every thread's stack on standard error (a first run builds
#: and may take minutes; a warm one ends within about 220 s)
STACKS_EVERY_S = 300
#: the latest a run may end, from its start, and from the window's
#: close plus the mix's ``grace_s``: past either the watchdog ends it
LIMIT_S = 1100
AFTER_CLOSE_S = 240
#: the child processes a run has started, for the watchdog to end
CHILDREN: list = []


class Watchdog:
    """Ends a run that hangs: once its deadline has passed it prints
    every thread's stack on standard error, kills the children and
    leaves with exit code 4, so that the run fails and says where it
    stood instead of holding the card until it is killed from outside."""

    def __init__(self, at: float):
        self.at = at
        self._done = threading.Event()
        threading.Thread(target=self._watch, name="portbench-watchdog",
                         daemon=True).start()

    def move(self, at: float) -> None:
        self.at = min(self.at, at)

    def cancel(self) -> None:
        self._done.set()

    def _watch(self) -> None:
        while not self._done.wait(max(0.05, min(
                5.0, self.at - time.monotonic()))):
            if time.monotonic() >= self.at:
                log("past the run's deadline: every thread's stack, then "
                    "the run ends")
                faulthandler.dump_traceback(all_threads=True)
                for proc in CHILDREN:
                    if proc.poll() is None:
                        proc.kill()
                sys.stderr.flush()
                os._exit(4)


#: the run's watchdog (``main`` starts it)
WATCHDOG: Watchdog | None = None


def log(msg: str) -> None:
    """One line of progress on standard error, timed from the start."""
    print(f"portbench {time.monotonic() - T_START:.1f} s: {msg}",
          file=sys.stderr, flush=True)


def load_json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def reader(kind: str, name: str):
    """``read`` of ``<kind>/<name>.py``."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, key: str, cell: str) -> list[dict]:
    return [m for m in bench[key]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# -- the replica and the gateway ---------------------------------------------
def start_replica(cfg: dict, params: dict, device: str):
    """The configuration served by ``TPUServeServer`` on ``params``,
    warmed and listening on a free port."""
    from aigw_tpu_torch.models import llama, mixtral
    from aigw_tpu_torch.models.registry import ModelSpec, register_model
    from aigw_tpu_torch.tpuserve.engine import EngineConfig
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    common = dict(
        vocab_size=cfg["vocab_size"], dim=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        ffn_dim=cfg["intermediate_size"], rope_theta=cfg["rope_theta"],
        norm_eps=cfg["rms_norm_eps"],
        max_seq_len=cfg["engine"]["max_seq_len"])
    if cfg["family"] == "mixtral":
        mcfg = mixtral.MixtralConfig(
            **common, n_experts=cfg["num_local_experts"],
            experts_per_token=cfg["num_experts_per_tok"],
            capacity_factor=cfg["capacity_factor"])
    else:
        mcfg = llama.LlamaConfig(
            **common, tie_embeddings=cfg["tie_word_embeddings"],
            attn_bias=bool(cfg.get("qkv_bias")))
    register_model(ModelSpec(cfg["name"], cfg["family"], mcfg))
    server = TPUServeServer(cfg["name"], EngineConfig(**cfg["engine"]),
                            device=device, port=0, params=params)
    server.start()
    return server


def start_gateway(model: str, replica: str, workdir: str):
    """``python -m aigw_tpu_torch run`` on a config naming the one
    replica: (process, port)."""
    path = os.path.join(workdir, "gateway.json")
    with open(path, "w") as f:
        json.dump({
            "version": "v1",
            "backends": [{"name": "pool", "schema": "TPUServe",
                          "endpoints": [{"address": replica,
                                         "slice": "s0"}]}],
            "routes": [{"name": "serving", "rules": [
                {"models": [model], "backends": ["pool"]}]}],
            "models": [model]}, f)
    with open(os.path.join(workdir, "gateway.log"), "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "aigw_tpu_torch", "run", path, "--host",
             "127.0.0.1", "--port", "0", "--watch-interval", "3600"],
            cwd=ROOT, env=dict(os.environ, AIGW_DRAIN_SECONDS="0"),
            stdout=subprocess.PIPE, stderr=err, text=True)
    CHILDREN.append(proc)
    port = []
    up = threading.Event()

    def drain():
        for line in proc.stdout:
            m = re.search(r"gateway listening on http://[\d.]+:(\d+)", line)
            if m and not port:
                port.append(int(m.group(1)))
                up.set()
        up.set()

    threading.Thread(target=drain, daemon=True).start()
    up.wait(timeout=120)
    if not port:
        stop(proc)
        raise RuntimeError(f"the gateway did not start: "
                           f"{tail(workdir, 'gateway.log')}")
    return proc, port[0]


def stop(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=20)


def snapshot(server) -> dict:
    """The replica's counters and phase histograms' ``_sum`` and
    ``_count``, as ``/state`` and ``/metrics`` give them."""
    st = server.state()
    text = server.metrics().decode()
    hist = {}
    for phase in PHASES:
        fam = f"tpuserve_{phase}_hist_ms"
        s = re.search(rf"^{fam}_sum (\S+)$", text, re.M)
        c = re.search(rf"^{fam}_count (\S+)$", text, re.M)
        hist[phase] = (float(s.group(1)) if s else 0.0,
                       float(c.group(1)) if c else 0.0)
    return {"t": time.monotonic(), "hist": hist,
            "state": {k: st[k] for k in STATE_KEYS}}


def sleep_until(t: float) -> None:
    time.sleep(max(0.0, t - time.monotonic()))


# -- one run ------------------------------------------------------------------
def resolve(bench: dict, cell: dict) -> tuple[dict, dict, dict]:
    """The cell's configuration, traffic mix and limits, by name."""
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    return (cfg, load_json("traffic", cell["traffic"] + ".json"),
            load_json("limits", cell["name"] + ".json"))


class Rig:
    """The system under test, up: the weights, the warmed replica in
    this process and, when the mix goes through it, the gateway."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str):
        import weights

        self.cfg, self.device = cfg, device
        self.params = weights.make(cfg, seed, device)
        log("weights drawn")
        self.server = start_replica(cfg, self.params, device)
        log(f"replica warmed and listening on port {self.server.port}")
        self.workdir = tempfile.mkdtemp(prefix="portbench-")
        self.gateway = None
        self.address = f"127.0.0.1:{self.server.port}"
        try:
            if traffic.get("via_gateway"):
                self.gateway, port = start_gateway(
                    cfg["name"], self.address, self.workdir)
                self.address = f"127.0.0.1:{port}"
                log(f"gateway listening on port {port}")
        except BaseException:
            self.server.stop()
            raise

    def close(self) -> None:
        """Stop the gateway and the replica, and free the replica's
        device state (the weights stay: the reference reads them)."""
        import shutil

        import torch

        if self.gateway is not None:
            stop(self.gateway)
        self.server.stop()
        shutil.rmtree(self.workdir, ignore_errors=True)
        self.server = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()


def measure(rig: Rig, traffic: dict, seed: int, seconds: float,
            trace: bool) -> SimpleNamespace:
    """One window of ``traffic`` on ``rig``: the load generator's
    records, the replica's counters at the window's edges (and the
    traced slice's, with ``trace``), and the device trace."""
    cuda = rig.device == "cuda"
    plan = os.path.join(rig.workdir, "plan.json")
    out = os.path.join(rig.workdir, "records.jsonl")
    with open(plan, "w") as f:
        json.dump({"address": rig.address, "model": rig.cfg["name"],
                   "seed": seed, "seconds": seconds, "traffic": traffic}, f)
    with open(os.path.join(rig.workdir, "loadgen.log"), "w") as err:
        lg = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "loadgen.py"), plan, out],
            stdout=subprocess.PIPE, stderr=err, text=True)
    CHILDREN.append(lg)
    try:
        line = lg.stdout.readline()
        if not line.startswith("WINDOW "):
            lg.wait(timeout=60)
            raise RuntimeError(f"the load generator gave no window: "
                               f"{line!r} {tail(rig.workdir, 'loadgen.log')}")
        t_open = float(line.split()[1])
        t_close = t_open + seconds
        if WATCHDOG is not None:
            WATCHDOG.move(t_close + traffic.get("grace_s", 0)
                          + AFTER_CLOSE_S)
        sleep_until(t_open)
        log("window open")
        snaps = {"open": snapshot(rig.server)}
        dt = None
        if trace and cuda:
            import devtrace

            dt = devtrace.DeviceTrace()
            sleep_until(t_open + traffic["trace_offset_s"])
            snaps["trace_start"] = snapshot(rig.server)
            dt.start()
            log("trace started")
            sleep_until(dt.t0 + traffic["trace_s"])
            dt.stop()
            log("trace stopped")
            snaps["trace_end"] = snapshot(rig.server)
        sleep_until(t_close)
        snaps["close"] = snapshot(rig.server)
        captures = (snaps["close"]["state"]["xla_compiles"]
                    - snaps["open"]["state"]["xla_compiles"])
        log(f"window closed; graph captures inside it: {captures}")
        rest, _ = lg.communicate(timeout=traffic.get("grace_s", 0) + 120)
        log("load generator done")
        if "DONE" not in rest:
            raise RuntimeError(f"the load generator did not finish: "
                               f"{tail(rig.workdir, 'loadgen.log')}")
    finally:
        stop(lg)
    with open(out) as f:
        records = [json.loads(x) for x in f]
    # the counters' span: the whole window, or in a traced run the part
    # before the traced slice (whose end stalls this process while the
    # profiler hands its buffers over)
    end = "trace_start" if dt is not None else "close"
    return SimpleNamespace(cfg=rig.cfg, traffic=traffic, records=records,
                           t_open=t_open, t_close=t_close, seconds=seconds,
                           snaps=snaps, span=("open", end),
                           t_span_end=snaps[end]["t"],
                           setup_s=snaps["open"]["t"] - T_START,
                           trace=None, dt=dt)


def run_cell(bench: dict, cell: dict, cfg: dict, traffic: dict,
             limits: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: str | None = None) -> dict:
    """One run of ``cell``; returns the result's fields, and under
    ``check`` the numbers compared with their limits. With ``control``
    (a lower precision that ``reference.Model`` computes), the reference
    in that precision takes the program's place in the check: ``correct``
    and ``check`` are the control's, ``program_check`` the program's."""
    import torch

    import check

    cuda = device == "cuda"
    rig = Rig(cfg, traffic, seed, device)
    if trace and cuda:
        import devtrace

        devtrace.DeviceTrace.warm()
        log("profiler warmed")
    try:
        ctx = measure(rig, traffic, seed, seconds, trace)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        window_mods = forbidden_modules()
    finally:
        rig.close()
        log("replica and gateway stopped")
    records = ctx.records
    result = {"device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda
                         else "cpu",
                         "count": cell["chips"],
                         "memory_peak_bytes": peak}}
    if ctx.dt is not None:
        import devtrace

        dt = ctx.dt
        ctx.trace = devtrace.reduce(dt.events(), dt.t1 - dt.t0)
        ctx.trace_t0, ctx.trace_t1 = dt.t0, dt.t1
        result["device"]["busy_s"] = ctx.trace["busy_s"]
        result["device"]["window_s"] = ctx.trace["window_s"]
        result["breakdown"] = ctx.trace["breakdown"]
        log("trace reduced")
    kind, key = ("metrics", "per_layer") if trace else ("e2e", "end_to_end")
    metrics = {}
    for m in cell_metrics(bench, key, cell["name"]):
        if kind == "metrics" and ctx.trace is None:
            continue
        v = reader(kind, m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result["metrics"] = metrics
    result["attempted"], result["failed"] = counts(
        records, ctx.t_close, traffic["arrival"] == "closed")
    result["summary"] = summary(ctx)
    t_check = time.monotonic()
    cmp = check.compare(cfg, rig.params, records, seed, limits,
                        traffic.get("pin", "abcdefghijklmnopqrstuvwxyz"),
                        (control,) if control else ())
    log("output check done")
    result["check_info"] = dict(cmp["info"],
                                seconds=time.monotonic() - t_check)
    result["window_modules"] = window_mods
    result["check"] = cmp["controls"][control] if control \
        else cmp["numbers"]
    result["correct"] = check.passed(result["check"])
    if control:
        result["program_check"] = cmp["numbers"]
    return result


def counts(records: list[dict], t_close: float, closed: bool
           ) -> tuple[int, int]:
    """(attempted, failed): the requests due in the window (sent before
    its close, in a closed loop), and those of them that did not finish;
    a closed loop's streams that the window's close cut are not
    failures."""
    due = [r for r in records if r["segment"] == "window"
           and r.get("due") is not None and r["due"] < t_close]
    return len(due), sum(1 for r in due
                         if not r["ok"] and not (closed and r.get("cut")))


def summary(ctx) -> dict:
    """What the end-to-end metrics leave out, for the log: the TTFT
    median and 95th percentile over the requests due in the window (from
    the due time, a failed or refused request never answered) and every
    answered request's TTFT, the TPOT median, the generator's
    lateness."""
    import math

    import stats

    win = [r for r in ctx.records if r["segment"] == "window"]
    late = [r["sent"] - r["due"] for r in win if r.get("sent") is not None]
    ttft = [1e3 * (r["times"][0] - r["due"]) if r["ok"] and r["times"]
            else math.inf for r in win]
    tpot = [1e3 * (r["times"][-1] - r["times"][0]) / (len(r["times"]) - 1)
            for r in win if r["ok"] and len(r["times"]) > 1]
    return {"requests_in_window": len(win),
            "finished": sum(r["ok"] for r in win),
            "ttft_ms_p50": stats.quantile(ttft, 0.5),
            "ttft_ms_p95": stats.quantile(ttft, 0.95),
            "ttft_ms": [round(x, 1) for x in ttft if x < math.inf],
            "tpot_ms_p50": stats.quantile(tpot, 0.5),
            "late_ms_p50": 1e3 * stats.quantile(late, 0.5),
            "late_ms_max": 1e3 * max(late, default=0.0)}


def tail(workdir: str, name: str) -> str:
    try:
        with open(os.path.join(workdir, name)) as f:
            return f.read()[-3000:]
    except OSError:
        return ""


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    global WATCHDOG
    faulthandler.dump_traceback_later(STACKS_EVERY_S, repeat=True)
    WATCHDOG = Watchdog(T_START + LIMIT_S)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = run_cell(bench, cell, *resolve(bench, cell), args.seed,
                   args.seconds, bool(args.trace))
    faulthandler.cancel_dump_traceback_later()
    WATCHDOG.cancel()
    bad = forbidden_modules()
    if bad or res.pop("window_modules"):
        print(f"loaded in this process: {bad}: the port may not load JAX "
              "or the JAX package", file=sys.stderr)
        return 3
    print(json.dumps({"summary": res.pop("summary"),
                      "check_info": res.pop("check_info"),
                      "card": nvidia_smi()}), flush=True)
    check_numbers = res.pop("check")
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": res["device"]}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["check"] = check_numbers
    for name, v in check_numbers.items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
