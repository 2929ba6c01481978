"""Grammar-constrained decoding (the port's own copy of
``aigw_tpu/tpuserve/constrain.py``; host-side Python and numpy, same
names, messages and ``NEG_MASK``).

``response_format`` (``json_object`` / ``json_schema``) and tool-call
envelopes become **token-level masks** that the engine adds to each
slot's logit-bias row:

- A (subset) JSON schema compiles to a **character-level pushdown
  automaton**: hashable frame stacks, with unions (``anyOf`` / enums /
  multi-tool envelopes) as *sets of stacks*, a lazy powerset
  construction, so alternative branches ride one state object.
- The automaton lifts to the **token level** through a trie over the
  tokenizer's per-token strings: a token is allowed in a state iff every
  character of its string advances the automaton. Per-state ``[V]``
  float32 mask rows (0 = allowed, ``NEG_MASK`` = disallowed) are cached
  per (tokenizer, grammar) key, so repeated traffic against the same
  schema compiles nothing again.
- The engine applies the mask of the slot's *settled* FSM state when it
  dispatches a window. Inside a multi-token decode window that mask is
  stale after the first token, so the host **verifies the window and
  rolls the slot back at the first token whose mask changed** (engine.py
  ``_cn_verify``), as a rejected speculative draft is.

Generation grammar (a deliberate subset):
- Compact JSON only (no whitespace between tokens).
- String bodies are printable ASCII without ``"`` or ``\\`` (escapes are
  never *generated*; ``enum``/``const`` literals render through
  ``json.dumps`` and may contain escapes, matched char for char).
- Objects with declared ``properties`` emit **every** declared property
  in declaration order (strict-mode style: always schema-valid, and the
  output length is bounded, so a constrained request can finish inside
  ``max_tokens``).
- Numbers are bounded to ``INT_DIGITS``/``FRAC_DIGITS`` digits.

Unsupported schema keywords raise :class:`UnsupportedConstraintError`
and malformed schemas ``JSONSchemaError`` (both client-facing 400s).
"""

from __future__ import annotations

import json
import logging
import re
from dataclasses import dataclass
from typing import Any, Iterable

import numpy as np

from aigw_tpu_torch.translate.structured import (
    JSONSchemaError,
    dereference,
)

logger = logging.getLogger(__name__)

#: additive logit penalty for disallowed tokens. Finite (not -inf) so
#: composed bias rows stay NaN-free through softmax/log_softmax on every
#: backend; 1e9 dwarfs any real logit.
NEG_MASK = -1.0e9

#: budgets that keep every literal finite (a random/hostile model must
#: not be able to extend a token run forever and force a "length" finish
#: with invalid JSON)
INT_DIGITS = 12
FRAC_DIGITS = 6
FREE_STR_MAX = 512  # string budget when the schema gives no maxLength
KEY_MAX = 32  # free-form object key budget (json_object mode)
ANY_DEPTH = 4  # free-form value nesting budget (json_object mode)

#: characters allowed inside a generated string body: printable ASCII
#: minus the two JSON-structural ones (close quote handled explicitly;
#: backslash escapes are never generated)
STR_CHARS = frozenset(chr(c) for c in range(0x20, 0x7F)) - {'"', "\\"}
_D09 = frozenset("0123456789")
_D19 = frozenset("123456789")

#: capability flags advertised on /v1/models and /state once the
#: subsystem serves a replica (the gateway merges them into its own
#: /v1/models listing)
CAPABILITIES: dict[str, Any] = {
    "response_format": ["text", "json_object", "json_schema"],
    "tools": True,
    "tool_choice": ["none", "auto", "required", "named"],
}

_TOOL_NAME_RE = re.compile(r"^[A-Za-z0-9_.\-]{1,64}$")


class UnsupportedConstraintError(ValueError):
    """The request asks for a constraint this server cannot enforce
    (unknown schema keyword, non-function tool, …) — client-facing 400,
    never a silent unconstrained 200."""


# ---------------------------------------------------------------------------
# schema → node table
# ---------------------------------------------------------------------------

#: schema keywords the compiler understands; anything else is an
#: explicit UnsupportedConstraintError (the 400 path)
_SUPPORTED_KEYS = frozenset({
    "type", "properties", "required", "additionalProperties", "items",
    "minItems", "maxItems", "enum", "const", "anyOf", "allOf",
    "minLength", "maxLength", "nullable",
    # annotations (no grammar effect)
    "description", "title", "default", "examples", "$defs",
    "definitions", "$schema", "$id",
})


def _dump(v: Any) -> str:
    return json.dumps(v, separators=(",", ":"), ensure_ascii=True)


class _NodeBuilder:
    """Compiles a dereferenced JSON schema into a flat node table the
    automaton walks by integer id (hashable states stay small)."""

    def __init__(self) -> None:
        self.nodes: list[dict[str, Any]] = []

    def add(self, node: dict[str, Any]) -> int:
        self.nodes.append(node)
        return len(self.nodes) - 1

    def anyobj(self) -> int:
        return self.add({"k": "anyobj", "depth": ANY_DEPTH})

    def build(self, schema: Any) -> int:
        if schema is True or schema == {}:
            return self.add({"k": "any", "depth": ANY_DEPTH})
        if not isinstance(schema, dict):
            raise JSONSchemaError(
                f"schema must be an object, got {type(schema).__name__}")
        unknown = sorted(set(schema) - _SUPPORTED_KEYS)
        if unknown:
            raise UnsupportedConstraintError(
                f"unsupported JSON-schema keyword(s) for constrained "
                f"decoding: {unknown}")
        if "allOf" in schema:
            v = schema["allOf"]
            if not isinstance(v, list) or len(v) != 1 \
                    or not isinstance(v[0], dict):
                raise UnsupportedConstraintError(
                    "allOf is supported only as a single-element wrapper")
            merged = {k: val for k, val in schema.items() if k != "allOf"}
            merged.update(v[0])
            return self.build(merged)
        if "const" in schema:
            return self.add({"k": "lits", "lits": (_dump(schema["const"]),)})
        if "enum" in schema:
            vals = schema["enum"]
            if not isinstance(vals, list) or not vals:
                raise JSONSchemaError("enum must be a non-empty array")
            return self.add(
                {"k": "lits", "lits": tuple(_dump(v) for v in vals)})
        if "anyOf" in schema:
            vals = schema["anyOf"]
            if not isinstance(vals, list) or not vals:
                raise JSONSchemaError("anyOf must be a non-empty array")
            alts = tuple(self.build(v) for v in vals)
            return self.add({"k": "union", "alts": alts})

        t = schema.get("type")
        nullable = bool(schema.get("nullable", False))
        if isinstance(t, list):
            non_null = [x for x in t if x != "null"]
            if len(non_null) != len(t):
                nullable = True
            if len(non_null) > 1:
                alts = tuple(
                    self.build(dict(schema, type=x, nullable=False))
                    for x in non_null)
                nid = self.add({"k": "union", "alts": alts})
                return self._maybe_null(nid, nullable)
            t = non_null[0] if non_null else "null"
        if t is None:  # infer
            if "properties" in schema:
                t = "object"
            elif "items" in schema or "minItems" in schema \
                    or "maxItems" in schema:
                t = "array"
            elif "minLength" in schema or "maxLength" in schema:
                t = "string"
            else:
                return self._maybe_null(
                    self.add({"k": "any", "depth": ANY_DEPTH}), nullable)
        if not isinstance(t, str):
            raise JSONSchemaError(
                f"'type' must be a string or list, got "
                f"{type(t).__name__}")
        nid = self._build_typed(t, schema)
        return self._maybe_null(nid, nullable)

    def _maybe_null(self, nid: int, nullable: bool) -> int:
        if not nullable:
            return nid
        null_id = self.add({"k": "lits", "lits": ("null",)})
        return self.add({"k": "union", "alts": (nid, null_id)})

    def _build_typed(self, t: str, schema: dict) -> int:
        if t == "object":
            props = schema.get("properties")
            if props is None or props == {}:
                return self.anyobj()
            if not isinstance(props, dict):
                raise JSONSchemaError("'properties' must be an object")
            req = schema.get("required", [])
            if not isinstance(req, list) or any(
                    not isinstance(r, str) for r in req):
                raise JSONSchemaError(
                    "'required' must be an array of strings")
            missing = [r for r in req if r not in props]
            if missing:
                raise JSONSchemaError(
                    f"required key(s) {missing} not in properties")
            segs: list[Any] = []
            cur = "{"
            for j, (key, sub) in enumerate(props.items()):
                if not isinstance(sub, dict) and sub is not True:
                    raise JSONSchemaError(
                        f"property {key!r} must be a schema object")
                cur += ("" if j == 0 else ",") + _dump(key) + ":"
                segs.append(cur)
                segs.append(self.build(sub))
                cur = ""
            segs.append(cur + "}")
            return self.add({"k": "seq", "segs": tuple(segs)})
        if t == "array":
            item = schema.get("items")
            item_id = (self.build(item) if item is not None
                       else self.add({"k": "any", "depth": ANY_DEPTH}))
            mn = int(schema.get("minItems", 0) or 0)
            mx = schema.get("maxItems")
            mx = int(mx) if mx is not None else (1 << 30)
            if mn < 0 or mx < mn:
                raise JSONSchemaError(
                    "minItems/maxItems must satisfy 0 <= min <= max")
            return self.add({"k": "array", "item": item_id,
                             "min": mn, "max": mx})
        if t == "string":
            mn = int(schema.get("minLength", 0) or 0)
            mx = schema.get("maxLength")
            mx = int(mx) if mx is not None else FREE_STR_MAX
            if mn < 0 or mx < mn:
                raise JSONSchemaError(
                    "minLength/maxLength must satisfy 0 <= min <= max")
            return self.add({"k": "string", "min": mn, "max": mx})
        if t == "integer":
            return self.add({"k": "int"})
        if t == "number":
            return self.add({"k": "number"})
        if t == "boolean":
            return self.add({"k": "lits", "lits": ("true", "false")})
        if t == "null":
            return self.add({"k": "lits", "lits": ("null",)})
        raise JSONSchemaError(f"unknown schema type {t!r}")


# ---------------------------------------------------------------------------
# character-level automaton
#
# A state is a frozenset of frame STACKS (tuples; stack[0] is the
# current frame). ε-frames expand in _closure; consuming frames advance
# one character in _step. The empty stack () is the accept state.
# ---------------------------------------------------------------------------

_POPPABLE = ("ndig", "nfracd")  # a complete number may end here


class _CharFSM:
    def __init__(self, nodes: list[dict[str, Any]], root: int):
        self.nodes = nodes
        self.root_state = frozenset(self._closure((("val", root),)))

    # -- ε-expansion ------------------------------------------------------
    def _expand_val(self, nid: int, rest: tuple) -> list[tuple]:
        node = self.nodes[nid]
        k = node["k"]
        if k == "seq":
            frames: list[tuple] = []
            for seg in node["segs"]:
                if isinstance(seg, str):
                    if seg:
                        frames.append(("lit", seg, 0))
                else:
                    frames.append(("val", seg))
            return [tuple(frames) + rest]
        if k == "lits":
            return [(("lit", s, 0),) + rest for s in node["lits"]]
        if k == "string":
            return [(("lit", '"', 0),
                     ("str", node["min"], node["max"])) + rest]
        if k == "int":
            return [(("nstart", "i", INT_DIGITS),) + rest]
        if k == "number":
            return [(("nstart", "f", INT_DIGITS),) + rest]
        if k == "array":
            return [(("lit", "[", 0),
                     ("arr0", node["item"], node["min"],
                      node["max"])) + rest]
        if k == "union":
            return [(("val", a),) + rest for a in node["alts"]]
        if k == "anyobj":
            return [(("lit", "{", 0), ("aobj0", node["depth"])) + rest]
        if k == "any":
            return [(("anyv", node["depth"]),) + rest]
        raise AssertionError(f"unknown node kind {k!r}")

    @staticmethod
    def _expand_anyv(d: int, rest: tuple) -> list[tuple]:
        alts = [(("lit", s, 0),) + rest for s in ("true", "false", "null")]
        alts.append((("lit", '"', 0), ("str", 0, FREE_STR_MAX)) + rest)
        alts.append((("nstart", "f", INT_DIGITS),) + rest)
        if d > 0:
            alts.append((("lit", "{", 0), ("aobj0", d)) + rest)
            alts.append((("lit", "[", 0), ("aarr0", d)) + rest)
        return alts

    @staticmethod
    def _aobj_entry(d: int, rest: tuple) -> tuple:
        return (("lit", '"', 0), ("str", 0, KEY_MAX), ("lit", ":", 0),
                ("anyv", d - 1), ("aobjsep", d)) + rest

    def _closure(self, stack: tuple) -> list[tuple]:
        """Stacks reachable by ε-moves whose head consumes a character —
        plus the empty stack when the value can complete here."""
        out: list[tuple] = []
        seen: set[tuple] = set()
        work = [stack]
        while work:
            st = work.pop()
            if st in seen:
                continue
            seen.add(st)
            if not st:
                out.append(st)
                continue
            f, rest = st[0], st[1:]
            k = f[0]
            if k == "val":
                work.extend(self._expand_val(f[1], rest))
            elif k == "anyv":
                work.extend(self._expand_anyv(f[1], rest))
            elif k == "arr0":
                _, nid, mn, mx = f
                if mn <= 0:
                    work.append((("lit", "]", 0),) + rest)
                if mx > 0:
                    work.append((("val", nid),
                                 ("arrsep", nid, 1, mn, mx)) + rest)
            elif k == "aobj0":
                d = f[1]
                work.append((("lit", "}", 0),) + rest)
                work.append(self._aobj_entry(d, rest))
            elif k == "aarr0":
                d = f[1]
                work.append((("lit", "]", 0),) + rest)
                work.append((("anyv", d - 1), ("aarrsep", d)) + rest)
            else:
                out.append(st)
                if k in _POPPABLE:
                    work.append(rest)
        return out

    # -- one-character step ----------------------------------------------
    def _step(self, st: tuple, ch: str) -> list[tuple]:
        f, rest = st[0], st[1:]
        k = f[0]
        if k == "lit":
            s, pos = f[1], f[2]
            if ch != s[pos]:
                return []
            return [rest if pos + 1 == len(s)
                    else (("lit", s, pos + 1),) + rest]
        if k == "str":
            mn, mx = f[1], f[2]
            if ch == '"':
                return [rest] if mn <= 0 else []
            if mx > 0 and ch in STR_CHARS:
                return [(("str", mn - 1 if mn > 0 else 0, mx - 1),)
                        + rest]
            return []
        if k == "nstart":
            kind, d = f[1], f[2]
            if ch == "-":
                return [(("nint0", kind, d),) + rest]
            if ch == "0":
                return [(("ndig", kind, 0),) + rest]
            if ch in _D19:
                return [(("ndig", kind, d - 1),) + rest]
            return []
        if k == "nint0":
            kind, d = f[1], f[2]
            if ch == "0":
                return [(("ndig", kind, 0),) + rest]
            if ch in _D19:
                return [(("ndig", kind, d - 1),) + rest]
            return []
        if k == "ndig":
            kind, remd = f[1], f[2]
            out = []
            if remd > 0 and ch in _D09:
                out.append((("ndig", kind, remd - 1),) + rest)
            if kind == "f" and ch == ".":
                out.append((("nfrac0", FRAC_DIGITS),) + rest)
            return out
        if k == "nfrac0":
            if ch in _D09:
                return [(("nfracd", f[1] - 1),) + rest]
            return []
        if k == "nfracd":
            if f[1] > 0 and ch in _D09:
                return [(("nfracd", f[1] - 1),) + rest]
            return []
        if k == "arrsep":
            _, nid, ndone, mn, mx = f
            out = []
            if ch == "," and ndone < mx:
                out.append((("val", nid),
                            ("arrsep", nid, ndone + 1, mn, mx)) + rest)
            if ch == "]" and ndone >= mn:
                out.append(rest)
            return out
        if k == "aobjsep":
            d = f[1]
            if ch == ",":
                return [self._aobj_entry(d, rest)]
            if ch == "}":
                return [rest]
            return []
        if k == "aarrsep":
            d = f[1]
            if ch == ",":
                return [(("anyv", d - 1), ("aarrsep", d)) + rest]
            if ch == "]":
                return [rest]
            return []
        return []

    def _stack_chars(self, st: tuple) -> Iterable[str]:
        """Characters the stack's head frame can consume (trie pruning +
        mask cross-checks)."""
        f = st[0]
        k = f[0]
        if k == "lit":
            return (f[1][f[2]],)
        if k == "str":
            mn, mx = f[1], f[2]
            chars: set[str] = set()
            if mn <= 0:
                chars.add('"')
            if mx > 0:
                chars |= STR_CHARS
            return chars
        if k == "nstart":
            return _D09 | {"-"}
        if k == "nint0":
            return _D09
        if k == "ndig":
            kind, remd = f[1], f[2]
            chars = set()
            if remd > 0:
                chars |= _D09
            if kind == "f":
                chars.add(".")
            return chars
        if k in ("nfrac0", "nfracd"):
            if k == "nfracd" and f[1] <= 0:
                return ()
            return _D09
        if k == "arrsep":
            _, _nid, ndone, mn, mx = f
            chars = set()
            if ndone < mx:
                chars.add(",")
            if ndone >= mn:
                chars.add("]")
            return chars
        if k == "aobjsep":
            return (",", "}")
        if k == "aarrsep":
            return (",", "]")
        return ()

    def advance_char(self, state: frozenset, ch: str) -> frozenset:
        nxt: set[tuple] = set()
        for st in state:
            if not st:
                continue  # accept state consumes nothing
            for raw in self._step(st, ch):
                nxt.update(self._closure(raw))
        return frozenset(nxt)

    def allowed_chars(self, state: frozenset) -> set[str]:
        chars: set[str] = set()
        for st in state:
            if st:
                chars.update(self._stack_chars(st))
        return chars


# ---------------------------------------------------------------------------
# tokenizer lifting: per-token strings + trie
# ---------------------------------------------------------------------------


class _TokenTable:
    """Per-tokenizer vocabulary view: token id → decoded string (None =
    never maskable: specials, empty, or undecodable) plus a character
    trie for mask construction."""

    def __init__(self, strs: list[str | None]):
        self.strs = strs
        # trie node: {char: child, None: [token ids ending here]}
        self.root: dict = {}
        for tid, s in enumerate(strs):
            if not s:
                continue
            node = self.root
            for ch in s:
                node = node.setdefault(ch, {})
            node.setdefault(None, []).append(tid)


def token_table(tokenizer: Any, vocab_size: int) -> _TokenTable:
    """Build (and cache on the tokenizer instance) its vocabulary
    table. One table per live tokenizer — the grammar/mask caches key on
    its identity."""
    cached = getattr(tokenizer, "_aigw_cn_table", None)
    if cached is not None and len(cached.strs) == vocab_size:
        return cached
    strs: list[str | None] = []
    for tid in range(vocab_size):
        try:
            s = tokenizer.decode([tid])
        except Exception:
            s = ""
        strs.append(s if s and "�" not in s else None)
    table = _TokenTable(strs)
    try:
        tokenizer._aigw_cn_table = table
    except Exception:  # exotic tokenizer without attribute support
        pass
    return table


# ---------------------------------------------------------------------------
# token-level FSM + per-slot cursor
# ---------------------------------------------------------------------------


class TokenFSM:
    """A compiled grammar over one tokenizer's vocabulary: char automaton
    + cached per-state token masks and transitions. Stateless and
    shared — per-slot position lives in :class:`ConstraintState`."""

    def __init__(self, table: _TokenTable, char_fsm: _CharFSM,
                 eos_ids: tuple[int, ...], vocab_size: int, key: tuple):
        self.table = table
        self.cf = char_fsm
        self.eos = frozenset(int(e) for e in eos_ids)
        self.V = int(vocab_size)
        self.key = key
        self.root = char_fsm.root_state
        self._masks: dict[frozenset, np.ndarray] = {}
        self._trans: dict[tuple[frozenset, int], frozenset | None] = {}
        # dead-end states whose mask was forced to EOS-only (no vocab
        # token fits the grammar): the forced EOS must then be ACCEPTED
        # by advance(), or the engine would roll the window back and
        # re-sample the same forced EOS forever
        self._forced_eos: set[frozenset] = set()
        self.dead_ends = 0

    def new_state(self) -> "ConstraintState":
        return ConstraintState(self)

    def accepting(self, state: frozenset) -> bool:
        return () in state

    def advance(self, state: frozenset, tok: int) -> frozenset | None:
        """State after consuming token ``tok``; None = grammar
        violation. EOS tokens are handled by the caller (valid iff
        accepting; they do not move the automaton)."""
        key = (state, tok)
        hit = self._trans.get(key, False)
        if hit is not False:
            return hit
        s = self.table.strs[tok] if 0 <= tok < len(self.table.strs) \
            else None
        out: frozenset | None
        if not s:
            out = None
        else:
            cur = state
            for ch in s:
                cur = self.cf.advance_char(cur, ch)
                if not cur:
                    break
            out = cur if cur else None
        self._trans[key] = out
        return out

    def mask(self, state: frozenset) -> np.ndarray:
        """The state's ``[V]`` float32 mask row (0 allowed / NEG_MASK
        disallowed). Cached; callers must treat it as read-only (the
        engine adds it into a fresh per-slot bias row)."""
        m = self._masks.get(state)
        if m is not None:
            return m
        arr = np.full((self.V,), NEG_MASK, np.float32)
        accepting = self.accepting(state)
        if accepting:
            for e in self.eos:
                if 0 <= e < self.V:
                    arr[e] = 0.0
        n_allowed = 0

        def walk(tnode: dict, sset: frozenset) -> None:
            nonlocal n_allowed
            ends = tnode.get(None)
            if ends:
                for tid in ends:
                    arr[tid] = 0.0
                n_allowed += len(ends)
            if len(tnode) <= (1 if ends else 0):
                return
            allowed = self.cf.allowed_chars(sset)
            for ch, child in tnode.items():
                if ch is None or ch not in allowed:
                    continue
                ns = self.cf.advance_char(sset, ch)
                if ns:
                    walk(child, ns)

        walk(self.table.root, state)
        if n_allowed == 0 and not accepting:
            # Dead end: the grammar needs a character no vocabulary
            # token can begin (or continue) with. Force a clean stop
            # instead of an unwinnable rollback loop; the response may
            # be invalid JSON but the request terminates.
            self._forced_eos.add(state)
            self.dead_ends += 1
            logger.warning(
                "constrained-decoding dead end: no vocab token fits the "
                "grammar state; forcing EOS")
            for e in self.eos:
                if 0 <= e < self.V:
                    arr[e] = 0.0
        arr.setflags(write=False)
        self._masks[state] = arr
        return arr


class ConstraintState:
    """Per-slot FSM cursor riding the continuous batch. The engine
    advances it on every emitted token and reads ``mask_row()`` into the
    slot's device bias row before each dispatch."""

    __slots__ = ("fsm", "state")

    def __init__(self, fsm: TokenFSM):
        self.fsm = fsm
        self.state = fsm.root

    @property
    def accepting(self) -> bool:
        return self.fsm.accepting(self.state)

    def advance(self, tok: int) -> bool:
        """Consume one sampled token. True = grammar-valid (state
        moved; EOS is valid exactly in accepting states — or dead-end
        states whose mask forced it — and does not move it). False =
        violation — the engine rolls the slot back."""
        if tok in self.fsm.eos:
            return self.accepting or self.state in self.fsm._forced_eos
        ns = self.fsm.advance(self.state, tok)
        if ns is None:
            return False
        self.state = ns
        return True

    def mask_row(self) -> np.ndarray:
        return self.fsm.mask(self.state)


# ---------------------------------------------------------------------------
# compiled-grammar cache
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ConstraintSpec:
    """Canonical description of one constraint (the grammar-cache key).

    kind: "json_object" | "json_schema" | "tool"
    payload: canonical-JSON of the schema (json_schema) or of the
    ``[[name, param_schema|None], …]`` tool list (tool)."""

    kind: str
    payload: str = ""

    @property
    def key(self) -> tuple:
        return (self.kind, self.payload)


_GRAMMARS: dict[tuple, TokenFSM] = {}


def grammar_cache_size() -> int:
    return len(_GRAMMARS)


def _tool_root(b: _NodeBuilder, tools: list) -> int:
    alts = []
    for name, schema in tools:
        args = b.build(schema) if schema else b.anyobj()
        segs = ('{"name":' + _dump(name) + ',"arguments":', args, "}")
        alts.append(b.add({"k": "seq", "segs": segs}))
    if len(alts) == 1:
        return alts[0]
    return b.add({"k": "union", "alts": tuple(alts)})


def compile_constraint(tokenizer: Any, vocab_size: int,
                       eos_ids: tuple[int, ...],
                       spec: ConstraintSpec) -> TokenFSM:
    """Compile (or fetch) the token FSM for ``spec`` against this
    tokenizer. Masks/transitions build lazily per visited state, so the
    call itself is cheap; raises JSONSchemaError /
    UnsupportedConstraintError for bad grammars (the 400 path)."""
    table = token_table(tokenizer, vocab_size)
    key = (id(table), tuple(sorted(eos_ids)), spec.key)
    fsm = _GRAMMARS.get(key)
    if fsm is not None:
        return fsm
    b = _NodeBuilder()
    if spec.kind == "json_object":
        root = b.anyobj()
    elif spec.kind == "json_schema":
        schema = json.loads(spec.payload)
        root = b.build(dereference(schema))
    elif spec.kind == "tool":
        root = _tool_root(b, json.loads(spec.payload))
    else:
        raise UnsupportedConstraintError(
            f"unknown constraint kind {spec.kind!r}")
    fsm = TokenFSM(table, _CharFSM(b.nodes, root), eos_ids, vocab_size,
                   key)
    _GRAMMARS[key] = fsm
    return fsm


def spec_for_response_format(kind: str,
                             schema: dict | None) -> ConstraintSpec:
    if kind == "json_object":
        return ConstraintSpec(kind="json_object")
    # no sort_keys: property DECLARATION order is part of the grammar
    # (objects emit their properties in schema order)
    return ConstraintSpec(
        kind="json_schema",
        payload=json.dumps(schema, separators=(",", ":")))


def spec_for_tools(tools: list[tuple[str, dict | None]]) -> ConstraintSpec:
    return ConstraintSpec(
        kind="tool",
        payload=json.dumps([[n, s] for n, s in tools],
                           separators=(",", ":")))


def parse_tools(tools: Any) -> list[tuple[str, dict | None]]:
    """Validate an OpenAI ``tools`` array for TPU-side enforcement →
    [(name, parameters|None)]. Raises UnsupportedConstraintError for
    tool types tpuserve cannot execute (built-in provider tools) and
    JSONSchemaError for malformed entries."""
    out: list[tuple[str, dict | None]] = []
    seen: set[str] = set()
    for i, t in enumerate(tools or ()):
        if not isinstance(t, dict):
            raise JSONSchemaError(f"tools[{i}] must be an object")
        if t.get("type") != "function":
            raise UnsupportedConstraintError(
                f"tools[{i}].type {t.get('type')!r} is not executable "
                "on tpuserve; only 'function' tools are supported")
        fn = t.get("function") or {}
        name = fn.get("name")
        if not isinstance(name, str) or not _TOOL_NAME_RE.match(name):
            raise JSONSchemaError(
                f"tools[{i}].function.name must match "
                f"{_TOOL_NAME_RE.pattern}")
        params = fn.get("parameters")
        if params is not None and not isinstance(params, dict):
            raise JSONSchemaError(
                f"tools[{i}].function.parameters must be an object")
        if name not in seen:  # duplicates collapse (OpenAI keeps first)
            seen.add(name)
            out.append((name, params))
    if not out:
        raise JSONSchemaError("tools must be a non-empty array")
    return out


# ---------------------------------------------------------------------------
# server-side streaming helpers: envelope splitting + auto detection
# ---------------------------------------------------------------------------


class ToolCallParser:
    """Incremental splitter of the generated tool envelope
    ``{"name":"X","arguments":{…}}`` into OpenAI streaming events:
    ("name", x) once, ("args", delta) for the raw arguments-object text,
    ("done",) when the envelope closes. The text is grammar-forced (or
    auto-detected against known names), so the scan is a fixed-shape
    match, not a general JSON parser."""

    def __init__(self) -> None:
        self._buf = ""
        self._phase = 0  # 0 = in prefix, 1 = in args, 2 = done
        self._depth = 0
        self._in_str = False
        self._esc = False
        self.name: str | None = None
        self.completed = False

    def feed(self, piece: str) -> list[tuple]:
        events: list[tuple] = []
        if self._phase == 2 or not piece:
            return events
        self._buf += piece
        if self._phase == 0:
            # '{"name":"NAME","arguments":'  (names never contain quotes
            # — parse_tools enforces the identifier charset)
            end = self._buf.find('","arguments":')
            if end < 0:
                return events
            if not self._buf.startswith('{"name":"'):
                # not an envelope (defensive — grammar-forced text
                # always matches); treat the rest as opaque args
                self._phase = 2
                return events
            self.name = self._buf[len('{"name":"'):end]
            events.append(("name", self.name))
            self._buf = self._buf[end + len('","arguments":'):]
            self._phase = 1
        if self._phase == 1 and self._buf:
            out, rest, closed = self._scan_args(self._buf)
            self._buf = rest
            if out:
                events.append(("args", out))
            if closed:
                events.append(("done",))
                self.completed = True
                self._phase = 2
        return events

    def _scan_args(self, text: str) -> tuple[str, str, bool]:
        """Consume argument-object characters; stop after the object
        closes (the remaining '}' is the envelope close, dropped)."""
        for i, ch in enumerate(text):
            if self._in_str:
                if self._esc:
                    self._esc = False
                elif ch == "\\":
                    self._esc = True
                elif ch == '"':
                    self._in_str = False
                continue
            if ch == '"':
                self._in_str = True
            elif ch in "{[":
                self._depth += 1
            elif ch in "}]":
                self._depth -= 1
                if self._depth == 0:
                    return text[: i + 1], text[i + 2:], True
        return text, "", False


class AutoToolDetector:
    """``tool_choice: auto`` — generation is unconstrained; streamed
    text buffers only while it is still a viable prefix of a tool-call
    envelope for one of the request's tools, then resolves to either
    ("content", buffered_text) or ("tool", parser_preloaded)."""

    def __init__(self, names: list[str]):
        self._prefixes = ['{"name":' + _dump(n) + ',"arguments":'
                          for n in names]
        self._buf = ""
        self.decided: str | None = None  # None | "content" | "tool"

    def feed(self, piece: str) -> tuple[str | None, str]:
        """Returns (decision, text): decision None while ambiguous
        (nothing to emit yet); "content" flushes the buffer as plain
        content; "tool" returns the full buffered envelope text so far
        (feed it to a ToolCallParser)."""
        self._buf += piece
        if self.decided is not None:
            return self.decided, piece
        for p in self._prefixes:
            if self._buf.startswith(p):
                self.decided = "tool"
                return "tool", self._buf
        if any(p.startswith(self._buf) for p in self._prefixes):
            return None, ""  # still ambiguous — keep buffering
        self.decided = "content"
        return "content", self._buf

    def finish(self) -> tuple[str, str]:
        """Stream ended. Returns the final decision plus any text still
        held back (non-empty only when the stream ended while the
        envelope prefix was still ambiguous — it was content)."""
        if self.decided is None:
            self.decided = "content"
            return "content", self._buf
        return self.decided, ""


def parse_tool_envelope(text: str,
                        names: list[str]) -> tuple[str, str] | None:
    """Non-streaming detection: the full response text is a tool-call
    envelope for one of ``names`` → (name, arguments_json_text)."""
    try:
        obj = json.loads(text)
    except ValueError:
        return None
    if (isinstance(obj, dict) and set(obj) == {"name", "arguments"}
            and obj["name"] in names
            and isinstance(obj["arguments"], (dict, list))):
        return str(obj["name"]), _dump(obj["arguments"])
    return None


# ---------------------------------------------------------------------------
# subset instance validator (bench + tests assert 100% schema validity
# without a jsonschema dependency)
# ---------------------------------------------------------------------------


def validate_instance(schema: Any, value: Any) -> bool:
    """True iff ``value`` satisfies the supported schema subset."""
    if schema is True or schema == {} or schema is None:
        return True
    if not isinstance(schema, dict):
        return False
    if "allOf" in schema:
        merged = {k: v for k, v in schema.items() if k != "allOf"}
        merged.update(schema["allOf"][0])
        return validate_instance(merged, value)
    if "const" in schema:
        return value == schema["const"]
    if "enum" in schema:
        return value in schema["enum"]
    if "anyOf" in schema:
        return any(validate_instance(s, value) for s in schema["anyOf"])
    t = schema.get("type")
    if isinstance(t, list):
        return any(validate_instance(dict(schema, type=x), value)
                   for x in t)
    if schema.get("nullable") and value is None:
        return True
    if t == "object" or (t is None and "properties" in schema):
        if not isinstance(value, dict):
            return False
        props = schema.get("properties") or {}
        for r in schema.get("required", []):
            if r not in value:
                return False
        if schema.get("additionalProperties") is False:
            if set(value) - set(props):
                return False
        return all(validate_instance(props[k], v)
                   for k, v in value.items() if k in props)
    if t == "array":
        if not isinstance(value, list):
            return False
        if len(value) < int(schema.get("minItems", 0) or 0):
            return False
        mx = schema.get("maxItems")
        if mx is not None and len(value) > int(mx):
            return False
        item = schema.get("items")
        return item is None or all(
            validate_instance(item, v) for v in value)
    if t == "string":
        if not isinstance(value, str):
            return False
        if len(value) < int(schema.get("minLength", 0) or 0):
            return False
        mx = schema.get("maxLength")
        return mx is None or len(value) <= int(mx)
    if t == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if t == "number":
        return isinstance(value, (int, float)) \
            and not isinstance(value, bool)
    if t == "boolean":
        return isinstance(value, bool)
    if t == "null":
        return value is None
    return True  # untyped: anything goes
