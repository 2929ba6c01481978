"""The port's grammar-constrained decoding modules against the JAX
package's (``tpuserve/constrain.py``, ``translate/structured.py``).

Each package compiles the same grammars against its own byte tokenizer,
at the tiny model's vocabulary (512) and at Llama-3's (128256). A seeded
random walk through both ``TokenFSM``s (allowed tokens, now and then a
disallowed one, EOS once the state accepts) must visit equal states with
mask rows equal byte for byte and equal ``advance`` and ``accepting``
results. Errors carry the same class name and message; the stream
parsers give equal events on the same pieces; ``parse_tool_envelope``,
``validate_instance`` and ``parse_response_format`` give equal results.
"""

import json

import numpy as np
import pytest

from aigw_tpu.tpuserve import constrain as jc
from aigw_tpu.tpuserve.tokenizer import ByteTokenizer as JTok
from aigw_tpu.translate import structured as js
from aigw_tpu_torch.tpuserve import constrain as tc
from aigw_tpu_torch.tpuserve.tokenizer import ByteTokenizer as TTok
from aigw_tpu_torch.translate import structured as ts

EOS = (257,)
VOCABS = [512, 128256]
#: one tokenizer instance per package and vocabulary (the token table is
#: cached on the instance)
TOKS = {(pkg, V): cls() for V in VOCABS
        for pkg, cls in (("ref", JTok), ("port", TTok))}

TOOL_X = {"type": "object", "properties": {"x": {"type": "integer"}},
          "required": ["x"], "additionalProperties": False}
#: the schemas of the reference's own compiler tests, and tool envelopes
SCHEMAS = {
    "nested_object": {"type": "object", "properties": {
        "b": {"type": "boolean"}, "a": {"type": "integer"},
        "s": {"type": "string", "maxLength": 4},
        "o": {"type": "object", "properties": {
            "k": {"type": "string", "minLength": 1, "maxLength": 3}},
            "required": ["k"]}},
        "required": ["a"], "additionalProperties": False},
    "enum": {"enum": ["x", "xy", 7, None, True]},
    "any_of": {"anyOf": [{"type": "null"}, {"enum": ["x", "xy", 7]},
                         {"type": "array", "items": {"type": "integer"},
                          "maxItems": 2}]},
    "bounded_array": {"type": "array", "items": {"type": "boolean"},
                      "minItems": 1, "maxItems": 3},
    "numbers": {"type": "object", "properties": {
        "i": {"type": "integer"}, "n": {"type": "number"}},
        "required": ["i", "n"], "additionalProperties": False},
    "nullable": {"type": "object", "properties": {
        "s": {"type": "string", "maxLength": 5, "nullable": True},
        "t": {"type": ["integer", "null"]}},
        "required": ["s", "t"]},
    "ref": {"type": "object",
            "properties": {"p": {"$ref": "#/$defs/point"},
                           "q": {"$ref": "#/$defs/point"}},
            "required": ["p", "q"], "additionalProperties": False,
            "$defs": {"point": {"type": "object", "properties": {
                "x": {"type": "integer"}, "y": {"type": "integer"}},
                "required": ["x", "y"]}}},
}
TOOLS = {
    "one_tool": [("get_weather", {
        "type": "object", "properties": {
            "city": {"type": "string", "maxLength": 6}},
        "required": ["city"], "additionalProperties": False})],
    "two_tools": [("alpha", TOOL_X), ("beta", None)],
}


def _spec(mod, case):
    if case == "json_object":
        return mod.spec_for_response_format("json_object", None)
    if case in TOOLS:
        return mod.spec_for_tools(TOOLS[case])
    return mod.spec_for_response_format("json_schema", SCHEMAS[case])


def _fsms(case, V):
    return tuple(mod.compile_constraint(TOKS[(pkg, V)], V, EOS,
                                        _spec(mod, case))
                 for pkg, mod in (("ref", jc), ("port", tc)))


CASES = sorted(SCHEMAS) + sorted(TOOLS) + ["json_object"]


@pytest.mark.parametrize("V", VOCABS)
@pytest.mark.parametrize("case", CASES)
def test_random_walk_masks_and_transitions_equal(case, V):
    rf, pf = _fsms(case, V)
    rng = np.random.default_rng(CASES.index(case) * 131 + V)
    for walk in range(3):
        rs, ps = rf.new_state(), pf.new_state()
        for step in range(200):
            assert ps.state == rs.state
            rm, pm = rs.mask_row(), ps.mask_row()
            assert pm.dtype == rm.dtype == np.float32 and pm.shape == (V,)
            assert pm.tobytes() == rm.tobytes(), (case, walk, step)
            assert not pm.flags.writeable
            assert ps.accepting == rs.accepting
            allowed = np.nonzero(pm == 0.0)[0]
            if rng.random() < 0.2:
                # a disallowed token: both refuse it and stay put
                bad = int(rng.integers(V))
                if pm[bad] != 0.0:
                    assert ps.advance(bad) is rs.advance(bad) is False
                    assert ps.state == rs.state
                    continue
            if ps.accepting and (rng.random() < 0.15 or len(allowed) == 1):
                assert ps.advance(EOS[0]) is rs.advance(EOS[0]) is True
                break
            body = [t for t in allowed if t not in EOS]
            tok = int(rng.choice(body))
            assert ps.advance(tok) is rs.advance(tok) is True
        assert pf.advance(ps.state, 300) == rf.advance(rs.state, 300)


def test_mask_constants_and_capabilities():
    assert tc.NEG_MASK == jc.NEG_MASK == -1.0e9
    assert tc.CAPABILITIES == jc.CAPABILITIES
    for name in ("INT_DIGITS", "FRAC_DIGITS", "FREE_STR_MAX", "KEY_MAX",
                 "ANY_DEPTH", "STR_CHARS"):
        assert getattr(tc, name) == getattr(jc, name), name


def test_forced_eos_dead_end_equal():
    """A state no vocabulary token can advance masks down to EOS, and
    that EOS is accepted, in both packages."""
    out = []
    for mod, base in ((jc, JTok), (tc, TTok)):
        class NoZ(base):
            def decode(self, ids):
                s = super().decode(ids)
                return "" if s == "z" else s

        fsm = mod.compile_constraint(NoZ(), 512, EOS,
                                     mod.spec_for_response_format(
                                         "json_schema", {"const": "z"}))
        st = fsm.new_state()
        assert st.advance(ord('"'))
        out.append((st.mask_row().tobytes(), fsm.dead_ends,
                    st.advance(EOS[0])))
    assert out[0] == out[1] and out[1][1:] == (1, True)


BAD_SCHEMAS = [
    {"type": "string", "pattern": "a+"},
    {"type": "integer", "minimum": 3},
    {"type": "object", "properties": {"a": {"type": "string"}},
     "required": ["zz"]},
    {"type": 7},
    {"type": "object", "properties": {"p": {"$ref": "#/$defs/nope"}}},
    {"type": "object", "properties": {"p": {"$ref": "#/$defs/a"}},
     "$defs": {"a": {"$ref": "#/$defs/a"}}},
    {"type": "array", "items": {"type": "string"}, "minItems": 3,
     "maxItems": 1},
    {"anyOf": "x"},
    {"type": "string", "maxLength": -1},
]
BAD_TOOLS = [
    [{"type": "google_search"}],
    [{"type": "function", "function": {"name": "bad name!"}}],
    [],
    ["x"],
    [{"type": "function", "function": {"name": "f", "parameters": 3}}],
]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — the error itself is compared
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("i", range(len(BAD_SCHEMAS)))
def test_schema_errors_equal(i):
    got = [_outcome(lambda m=mod, p=pkg: m.compile_constraint(
        TOKS[(p, 512)], 512, EOS,
        m.spec_for_response_format("json_schema", BAD_SCHEMAS[i])))
        for pkg, mod in (("ref", jc), ("port", tc))]
    assert got[0][0] in ("UnsupportedConstraintError", "JSONSchemaError")
    assert got[1] == got[0]


@pytest.mark.parametrize("i", range(len(BAD_TOOLS)))
def test_tool_errors_equal(i):
    got = [_outcome(mod.parse_tools, BAD_TOOLS[i]) for mod in (jc, tc)]
    assert got[0][0] != "ok" and got[1] == got[0]


def test_unknown_kind_and_tool_dedup_equal():
    for mod, pkg in ((jc, "ref"), (tc, "port")):
        with pytest.raises(mod.UnsupportedConstraintError,
                           match="unknown constraint kind"):
            mod.compile_constraint(TOKS[(pkg, 512)], 512, EOS,
                                   mod.ConstraintSpec(kind="xml"))
    tools = [{"type": "function", "function": {"name": "f"}},
             {"type": "function", "function": {"name": "f"}},
             {"type": "function", "function": {"name": "g", "parameters": {
                 "type": "object"}}}]
    assert tc.parse_tools(tools) == jc.parse_tools(tools)


ENVELOPES = [
    '{"name":"get_weather","arguments":{"city":"sf","n":2}}',
    '{"name":"t","arguments":{"s":"a}b{","l":[1,{"d":2}],"e":"q\\"}"}}',
    '{"name":"beta","arguments":{}}',
]


@pytest.mark.parametrize("seed", range(4))
def test_tool_call_parser_events_equal(seed):
    rng = np.random.default_rng(seed)
    for text in ENVELOPES:
        cuts = sorted(set(rng.integers(0, len(text), 6).tolist()))
        pieces = [text[a:b] for a, b in zip([0] + cuts, cuts + [len(text)])]
        rp, pp = jc.ToolCallParser(), tc.ToolCallParser()
        for piece in pieces + ["trailing"]:
            assert pp.feed(piece) == rp.feed(piece)
        assert (pp.name, pp.completed) == (rp.name, rp.completed)


AUTO_STREAMS = [
    ['{"name":', '"f2","arguments":{', '"a":1}}'],
    ['{"na', "I think…", " more"],
    ['{"'],
    ["plain ", "text"],
    ['{"name":"f1",', '"arguments":[1]}'],
]


@pytest.mark.parametrize("k", range(len(AUTO_STREAMS)))
def test_auto_detector_events_equal(k):
    rd, pd = (mod.AutoToolDetector(["f1", "f2"]) for mod in (jc, tc))
    for piece in AUTO_STREAMS[k]:
        assert pd.feed(piece) == rd.feed(piece)
        assert pd.decided == rd.decided
    assert pd.finish() == rd.finish()


def test_parse_tool_envelope_and_validate_instance_equal():
    for text, names in [(ENVELOPES[0], ["get_weather"]),
                        ('{"name":"f","arguments":{"a":1}}', ["f"]),
                        ("plain text", ["f"]),
                        ('{"name":"g","arguments":{}}', ["f"]),
                        ('{"name":"f","arguments":3}', ["f"]),
                        ('{"name":"f","arguments":[],"x":1}', ["f"])]:
        assert tc.parse_tool_envelope(text, names) == \
            jc.parse_tool_envelope(text, names)
    values = [{"a": 1, "b": [1, 2]}, {"a": "x"}, {"a": 1, "zz": 0},
              {"a": True}, None, "ab", "abc", 3, 2.5, [True], [],
              {"b": False, "a": 2, "s": "abcd", "o": {"k": "z"}}]
    for schema in list(SCHEMAS.values()) + [
            {"type": "string", "maxLength": 2}, TOOL_X, True, {},
            {"allOf": [{"type": "integer"}]}, {"const": 3}]:
        for v in values:
            assert tc.validate_instance(schema, v) == \
                jc.validate_instance(schema, v), (schema, v)


RESPONSE_FORMATS = [
    None, "json", {"type": "text"}, {"type": "json_object"},
    {"type": "xml"}, {"type": "json_schema"},
    {"type": "json_schema", "json_schema": {"name": "x"}},
    {"type": "json_schema", "json_schema": {"name": "x", "schema": 3}},
    {"type": "json_schema", "json_schema": {
        "name": "n", "strict": True, "schema": SCHEMAS["numbers"]}},
]


@pytest.mark.parametrize("k", range(len(RESPONSE_FORMATS)))
def test_parse_response_format_equal(k):
    body = ({} if RESPONSE_FORMATS[k] is None
            else {"response_format": RESPONSE_FORMATS[k]})
    want = _outcome(js.parse_response_format, body)
    got = _outcome(ts.parse_response_format, body)
    if want[0] == "ok" and want[1] is not None:
        want = ("ok", vars(want[1]))
        got = ("ok", vars(got[1]))
    assert got == want


def test_dereference_equal():
    schema = SCHEMAS["ref"]
    assert ts.dereference(schema) == js.dereference(schema)
    loop = {"$ref": "#/a", "a": {"$ref": "#/a"}}
    assert _outcome(ts.dereference, loop) == _outcome(js.dereference, loop)
    assert json.dumps(_outcome(ts.dereference, None)) == json.dumps(
        _outcome(js.dereference, None))
