"""A standard-library reader for the block-YAML subset that go-vcr
cassettes are written in (the port imports no pyyaml).

Covers what a YAML emitter writes for a cassette: block mappings and
sequences (a sequence item may open a compact mapping, ``- id: 0``),
plain scalars (resolved as pyyaml's YAML 1.1 resolver does: null,
booleans, integers and floats, else strings; timestamps stay strings),
single- and double-quoted scalars (escapes, lines folded), literal and
folded block scalars with their chomping and indentation indicators,
flow collections on one line (``{}``, ``[]``, ``[gzip, br]``), comments
and document markers. Anchors, aliases, tags, complex keys and flow
collections over several lines are not read: they raise ``ValueError``.
``tests/test_torch_cassettes.py`` holds it against pyyaml's
``safe_load`` on documents of every scalar style.
"""

from __future__ import annotations

import re
from typing import Any

_KEY_RE = re.compile(
    r"""^(?P<key>"(?:[^"\\]|\\.)*"|'(?:[^']|'')*'"""
    r"""|[^\s'"#\-?:,\[\]{}&*!|>%@`][^#]*?|-[^\s#][^#]*?)"""
    r""":(?:\s+|$)(?P<rest>.*)$""")
# pyyaml's YAML 1.1 resolver
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off",
          "OFF"}
_INT_RE = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT_RE = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX = {"x": 2, "u": 4, "U": 8}


def loads(text: str) -> Any:
    """The first document of ``text``."""
    lines: list[str] = []
    for raw in text.split("\n"):
        line = raw.rstrip("\r")
        if line.startswith(("---", "...")) and line[3:4] in ("", " "):
            if line.startswith("...") or any(not _blank(x) for x in lines):
                break
            rest = line[3:].strip()
            if rest and not rest.startswith("#"):
                lines.append(rest)
            continue
        if line.startswith("%"):
            continue
        lines.append(line)
    p = _Parser(lines)
    i = p.skip(0)
    if i >= len(lines):
        return None
    value, i = p.node(i, -1)
    if p.skip(i) < len(lines):
        raise ValueError(f"line {p.skip(i) + 1}: unexpected text")
    return value


def _indent(line: str) -> int:
    return len(line) - len(line.lstrip(" "))


def _blank(line: str) -> bool:
    s = line.strip()
    return not s or s.startswith("#")


def _sixty(digits: str) -> int:
    value = 0
    for part in digits.split(":"):
        value = value * 60 + int(part)
    return value


def _plain(text: str) -> Any:
    """A plain scalar, resolved as pyyaml's ``safe_load`` resolves it."""
    s = text.strip()
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if _INT_RE.match(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if ":" in v:
            return sign * _sixty(v)
        if v.startswith("0"):
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT_RE.match(s):
        v = s.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        if ":" in v:
            whole, frac = v.rsplit(":", 1)
            return sign * (_sixty(whole) * 60 + float(frac))
        return sign * float(v)
    return s


def _strip_comment(text: str) -> str:
    """A plain scalar's text without a trailing `` # comment``."""
    m = re.search(r"\s#", text)
    return (text[:m.start()] if m else text).rstrip()


def _fold(pieces: list[str]) -> str:
    """Flow-scalar line folding over trimmed lines: a line break is a
    space, each blank line a newline."""
    out = pieces[0]
    blanks = 0
    last = len(pieces) - 1
    for n, piece in enumerate(pieces[1:], start=1):
        if not piece and n < last:
            blanks += 1
            continue
        out += "\n" * blanks if blanks else " "
        out += piece
        blanks = 0
    return out


def _close(buf: str, q: str) -> int:
    """The index of the closing quote ``q`` in ``buf``, or -1."""
    k = 0
    while k < len(buf):
        c = buf[k]
        if q == '"' and c == "\\":
            k += 2
            continue
        if c == q:
            if q == "'" and buf[k + 1:k + 2] == "'":
                k += 2
                continue
            return k
        k += 1
    return -1


def _double(s: str) -> str:
    """A double-quoted scalar's text with its escapes resolved."""
    out = []
    k = 0
    while k < len(s):
        c = s[k]
        if c != "\\":
            out.append(c)
            k += 1
            continue
        e = s[k + 1:k + 2]
        if e in _HEX:
            n = _HEX[e]
            out.append(chr(int(s[k + 2:k + 2 + n], 16)))
            k += 2 + n
        elif e in _ESCAPES:
            out.append(_ESCAPES[e])
            k += 2
        else:
            raise ValueError(f"unknown escape \\{e}")
    return "".join(out)


def _odd_backslashes(s: str) -> bool:
    return (len(s) - len(s.rstrip("\\"))) % 2 == 1


class _Parser:
    def __init__(self, lines: list[str]):
        self.lines = lines

    def skip(self, i: int) -> int:
        while i < len(self.lines) and _blank(self.lines[i]):
            i += 1
        return i

    def _dash(self, j: int, ind: int) -> bool:
        """``lines[j]`` is a sequence item at indentation ``ind``."""
        line = self.lines[j]
        body = line[ind:]
        return _indent(line) == ind and (body == "-"
                                         or body.startswith("- "))

    def node(self, i: int, parent: int) -> tuple[Any, int]:
        """The node whose first line is ``lines[i]`` (indented deeper
        than ``parent``); returns it and the next line's index."""
        line = self.lines[i]
        ind = _indent(line)
        body = line[ind:]
        if self._dash(i, ind):
            return self.sequence(i, ind)
        if body in ("?", ":") or body.startswith(("? ", ": ")):
            raise ValueError(f"line {i + 1}: complex keys are not read")
        if not body.startswith(("[", "{")) and _KEY_RE.match(body):
            return self.mapping(i, ind)
        return self.scalar(body, i, parent)

    def mapping(self, i: int, ind: int) -> tuple[dict, int]:
        out: dict = {}
        while i < len(self.lines):
            line = self.lines[i]
            if _indent(line) != ind:
                if _indent(line) > ind:
                    raise ValueError(f"line {i + 1}: bad indentation")
                break
            m = _KEY_RE.match(line[ind:])
            if m is None:
                break
            key = self.key(m.group("key").rstrip())
            rest = m.group("rest").strip()
            if rest and not rest.startswith("#"):
                value, i = self.scalar(rest, i, ind)
            else:
                j = self.skip(i + 1)
                if j < len(self.lines) and _indent(self.lines[j]) > ind:
                    value, i = self.node(j, ind)
                elif j < len(self.lines) and self._dash(j, ind):
                    value, i = self.sequence(j, ind)
                else:
                    value, i = None, i + 1
            out[key] = value
            i = self.skip(i)
        return out, i

    def sequence(self, i: int, ind: int) -> tuple[list, int]:
        out: list = []
        while i < len(self.lines) and self._dash(i, ind):
            body = self.lines[i][ind:]
            item = body[1:].lstrip()
            if not item or item.startswith("#"):
                j = self.skip(i + 1)
                if j < len(self.lines) and _indent(self.lines[j]) > ind:
                    value, i = self.node(j, ind)
                else:
                    value, i = None, i + 1
            else:
                # the item's own node starts at its column
                self.lines[i] = " " * (len(self.lines[i]) - len(item)) + item
                value, i = self.node(i, ind)
            out.append(value)
            i = self.skip(i)
        return out, i

    @staticmethod
    def key(text: str) -> Any:
        if text.startswith('"'):
            return _double(text[1:-1])
        if text.startswith("'"):
            return text[1:-1].replace("''", "'")
        return _plain(text)

    def scalar(self, text: str, i: int, parent: int) -> tuple[Any, int]:
        """A scalar starting with ``text`` on line ``i``, continued on
        lines indented deeper than ``parent``."""
        if text[0] in "|>":
            return self.block(text, i, parent)
        if text[0] in "&*!":
            raise ValueError(f"line {i + 1}: anchors, aliases and tags "
                             "are not read")
        if text[0] in "[{":
            value, end = _flow(text, 0)
            if _strip_comment(text[end:]).strip():
                raise ValueError(f"line {i + 1}: text after a flow node")
            return value, i + 1
        if text[0] in "\"'":
            return self.quoted(text, i)
        pieces = [_strip_comment(text)]
        j = i + 1
        end = j
        while j < len(self.lines):
            line = self.lines[j]
            if line.strip():
                if _indent(line) <= parent or line.strip().startswith("#"):
                    break
                end = j + 1
            pieces.append(_strip_comment(line.strip()))
            j += 1
        pieces = pieces[:end - i]
        if len(pieces) == 1:
            return _plain(pieces[0]), i + 1
        return _fold(pieces), end

    def quoted(self, text: str, i: int) -> tuple[str, int]:
        q = text[0]
        buf = text[1:]
        pieces: list[str] = []
        j = i
        while True:
            end = _close(buf, q)
            if end >= 0:
                pieces.append(buf[:end] if not pieces
                              else buf[:end].lstrip(" \t"))
                tail = buf[end + 1:].strip()
                if tail and not tail.startswith("#"):
                    raise ValueError(f"line {j + 1}: text after a quoted "
                                     "scalar")
                break
            pieces.append(buf if not pieces else buf.lstrip(" \t"))
            j += 1
            if j >= len(self.lines):
                raise ValueError(f"line {i + 1}: unterminated quoted "
                                 "scalar")
            buf = self.lines[j]
        if q == "'":
            trimmed = [p.rstrip(" \t") for p in pieces[:-1]] + pieces[-1:]
            return _fold(trimmed).replace("''", "'"), j + 1
        return _double_lines(pieces), j + 1

    def block(self, text: str, i: int, parent: int) -> tuple[str, int]:
        """A literal (``|``) or folded (``>``) block scalar, as pyyaml's
        scanner reads it."""
        header = _strip_comment(text)
        folded = header[0] == ">"
        increment, chomp = 0, ""
        for c in header[1:]:
            if c in "+-":
                chomp = c
            elif c.isdigit():
                increment = int(c)
        j = i + 1
        min_indent = max(parent + 1, 1)
        if increment:
            indent = min_indent + increment - 1
        else:
            indent = min_indent
            k = j
            while k < len(self.lines) and not self.lines[k].strip():
                indent = max(indent, len(self.lines[k]))
                k += 1
            if k < len(self.lines):
                indent = max(indent, _indent(self.lines[k]))
        # the scalar's lines: text (indent stripped) or None (empty)
        rows: list[str | None] = []
        while j < len(self.lines):
            line = self.lines[j]
            if line.strip() and _indent(line) < indent:
                break
            rows.append(line[indent:] if line.strip()
                        or len(line) > indent else None)
            j += 1
        chunks: list[str] = []
        breaks: list[str] = []
        k = 0
        while k < len(rows) and rows[k] is None:
            breaks.append("\n")
            k += 1
        line_break = ""
        while k < len(rows):
            chunks.extend(breaks)
            leading_non_space = rows[k][:1] not in (" ", "\t")
            chunks.append(rows[k])
            line_break = "\n"
            k += 1
            breaks = []
            while k < len(rows) and rows[k] is None:
                breaks.append("\n")
                k += 1
            if k < len(rows):
                if (folded and leading_non_space
                        and rows[k][:1] not in (" ", "\t")):
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(line_break)
        if chomp != "-":
            chunks.append(line_break)
        if chomp == "+":
            chunks.extend(breaks)
        # trailing empty lines belong to the scalar; the next node
        # starts after them
        return "".join(chunks), j


def _double_lines(pieces: list[str]) -> str:
    """A double-quoted scalar over its lines (leading whitespace of the
    later lines removed): folded, a line ending in an escaping ``\\``
    joined to the next with nothing between."""
    out = ""
    blanks = 0
    joined = False
    last = len(pieces) - 1
    for n, piece in enumerate(pieces):
        if n > 0:
            if not piece and n < last:
                blanks += 1
                continue
            if not joined:
                out += "\n" * blanks if blanks else " "
            blanks = 0
        if n < last and _odd_backslashes(piece):
            out += _double(piece[:-1])
            joined = True
        else:
            out += _double(piece if n == last else piece.rstrip(" \t"))
            joined = False
    return out


def _flow(s: str, k: int) -> tuple[Any, int]:
    """A flow node at ``s[k]``; returns it and the index after it."""
    while k < len(s) and s[k] == " ":
        k += 1
    if k >= len(s):
        raise ValueError("unterminated flow collection")
    c = s[k]
    if c in "[{":
        close = "]" if c == "[" else "}"
        items: list = []
        obj: dict = {}
        k += 1
        while True:
            while k < len(s) and s[k] == " ":
                k += 1
            if k >= len(s):
                raise ValueError("unterminated flow collection")
            if s[k] == close:
                return (items if c == "[" else obj), k + 1
            key, k = _flow(s, k)
            while k < len(s) and s[k] == " ":
                k += 1
            if k < len(s) and s[k] == ":":
                value, k = _flow(s, k + 1)
                if c == "[":
                    items.append({key: value})
                else:
                    obj[key] = value
            elif c == "[":
                items.append(key)
            else:
                obj[key] = None
            while k < len(s) and s[k] == " ":
                k += 1
            if k < len(s) and s[k] == ",":
                k += 1
            elif k < len(s) and s[k] != close:
                raise ValueError(f"unexpected {s[k]!r} in a flow "
                                 "collection")
    if c in "\"'":
        end = _close(s[k + 1:], c)
        if end < 0:
            raise ValueError("unterminated quoted scalar")
        raw = s[k + 1:k + 1 + end]
        value = _double(raw) if c == '"' else raw.replace("''", "'")
        return value, k + 2 + end
    m = re.compile(r"[^,\[\]{}]*?(?=\s*(?:[,\]}]|:\s|:$|$))").match(s, k)
    text = m.group(0) if m else ""
    return _plain(text), k + len(text)
