"""Rule ``async-blocking``: no blocking calls inside async handlers.

Both servers run every request on one asyncio loop; a single
``time.sleep``, synchronous HTTP call, or blocking subprocess wait in
an ``async def`` stalls EVERY in-flight stream (token cadence, /state
polls, drain acknowledgements). The serving code's idiom for genuinely
blocking work is a nested sync function dispatched via
``asyncio.to_thread`` / ``run_in_executor`` (see the profiler capture
in the reference's tpuserve/server.py) — so this pass walks async function bodies but
does NOT descend into nested sync defs or lambdas, which are exactly
those dispatch targets.
"""

from __future__ import annotations

import ast

from aigw_tpu_torch.analysis.core import Finding, Source, dotted_name
from aigw_tpu_torch.analysis.registry import AnalysisConfig

RULE = "async-blocking"

#: dotted call names that block the event loop
BLOCKED_CALLS = {
    "time.sleep": "blocks the event loop; use `await asyncio.sleep`",
    "requests.get": "synchronous HTTP; use the gateway's HTTPClient",
    "requests.post": "synchronous HTTP; use the gateway's HTTPClient",
    "requests.put": "synchronous HTTP; use the gateway's HTTPClient",
    "requests.patch": "synchronous HTTP; use the gateway's HTTPClient",
    "requests.delete": "synchronous HTTP; use the gateway's HTTPClient",
    "requests.head": "synchronous HTTP; use the gateway's HTTPClient",
    "requests.request": "synchronous HTTP; use the gateway's "
                        "HTTPClient",
    "urllib.request.urlopen": "synchronous HTTP; use the gateway's "
                              "HTTPClient",
    "socket.create_connection": "blocking connect; use asyncio streams",
    "subprocess.run": "blocking child wait; use "
                      "asyncio.create_subprocess_exec",
    "subprocess.call": "blocking child wait; use "
                       "asyncio.create_subprocess_exec",
    "subprocess.check_call": "blocking child wait; use "
                             "asyncio.create_subprocess_exec",
    "subprocess.check_output": "blocking child wait; use "
                               "asyncio.create_subprocess_exec",
    "os.system": "blocking shell; use asyncio.create_subprocess_shell",
}

#: methods that block when called on ANY receiver inside an async def —
#: matched by attribute name alone, so keep this list to names that
#: have no non-blocking homonym in this codebase.
BLOCKED_METHODS = {
    "migrate_export": "blocks on the engine's migration queue; wrap in "
                      "asyncio.to_thread",
    "migrate_import": "blocks on the engine's migration queue; wrap in "
                      "asyncio.to_thread",
    "kv_export_pages": "blocks on the engine's migration queue; wrap "
                       "in asyncio.to_thread",
    "kv_import_pages": "blocks on the engine's migration queue; wrap "
                       "in asyncio.to_thread",
}


class _AsyncBodyVisitor(ast.NodeVisitor):
    def __init__(self) -> None:
        self.calls: list[tuple[int, str, str]] = []  # line, what, why

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        return  # sync def nested in async: the to_thread idiom

    def visit_Lambda(self, node: ast.Lambda) -> None:
        return

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        return  # visited separately by check()

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func)
        if name in BLOCKED_CALLS:
            self.calls.append((node.lineno, name, BLOCKED_CALLS[name]))
        elif isinstance(node.func, ast.Attribute):
            why = BLOCKED_METHODS.get(node.func.attr)
            if why is not None:
                # `await asyncio.to_thread(eng.migrate_export, …)`
                # passes the method WITHOUT calling it, so a Call node
                # here is a genuine inline invocation
                self.calls.append(
                    (node.lineno, f".{node.func.attr}()", why))
        self.generic_visit(node)


def check(sources: list[Source], config: AnalysisConfig) -> list[Finding]:
    out: list[Finding] = []
    for src in sources:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.AsyncFunctionDef):
                continue
            v = _AsyncBodyVisitor()
            for stmt in node.body:
                v.visit(stmt)
            for line, what, why in v.calls:
                out.append(Finding(
                    RULE, src.rel, line,
                    f"blocking call {what} inside `async def "
                    f"{node.name}` — {why}"))
    return out
