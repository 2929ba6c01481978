"""The port's C++ SSE and AWS event-stream scanners
(``aigw_tpu_torch/native/sse_scan.cpp``, ``eventstream_scan.cpp``): the
build helper (g++ into ``build/native/``, named by a hash of sources and
flags, built once under a lock), the bindings (``utils/native.py``, the
reference's output caps and errors), and byte-exact parity of the
parsers with the scanner, without it, and the reference's parsers on the
reference's fuzz streams."""

import json
import random
import subprocess
import sys
from pathlib import Path

import pytest

from aigw_tpu_torch import native as nbuild
from aigw_tpu_torch.translate import eventstream as tes
from aigw_tpu_torch.translate import sse as tsse
from aigw_tpu_torch.utils import native

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def lib():
    """The scanner, loaded for this module's tests and unloaded after
    them: the other files a test worker runs keep the parsers' Python
    loops, as in a process that never called ``load()``."""
    yield native.load()
    native._LIB = None


def test_each_thread_scans_into_its_own_buffers(lib):
    """Parsers on several threads at once (the reference keeps one
    output buffer per process): every thread's events are its own."""
    import threading

    streams = {i: b"".join(b"data: t%d-%d\n\n" % (i, k)
                           for k in range(2000)) for i in range(4)}
    got: dict = {}

    def run(i):
        p = tsse.SSEParser()
        out = []
        for k in range(0, len(streams[i]), 97):
            out.extend(e.data for e in p.feed(streams[i][k:k + 97]))
        got[i] = out

    threads = [threading.Thread(target=run, args=(i,)) for i in streams]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    for i in streams:
        assert got[i] == [f"t{i}-{k}" for k in range(2000)]


@pytest.fixture
def python_only(monkeypatch):
    """The parsers' plain Python loops: the scanner unloaded."""
    monkeypatch.setattr(native, "_LIB", None)


def _reference_fuzz_stream(seed: int) -> bytes:
    """``tests/test_native.py``'s stream: data, event + CRLF, comments,
    multi-line data."""
    rng = random.Random(seed)
    pieces = []
    for i in range(200):
        kind = rng.randrange(4)
        if kind == 0:
            pieces.append(f"data: d{i}\n\n".encode())
        elif kind == 1:
            pieces.append(f"event: e{i}\r\ndata: x\r\n\r\n".encode())
        elif kind == 2:
            pieces.append(f": comment {i}\n\n".encode())
        else:
            pieces.append(f"data: multi\ndata: line{i}\n\n".encode())
    return b"".join(pieces)


def _chunks(stream: bytes, seed: int, hi: int = 37) -> list[bytes]:
    rng = random.Random(seed)
    out, i = [], 0
    while i < len(stream):
        n = rng.randrange(1, hi)
        out.append(stream[i:i + n])
        i += n
    return out


def _events(parser_cls, chunks) -> list[tuple]:
    p = parser_cls()
    out = []
    for c in chunks:
        out.extend(p.feed(c))
    out.extend(p.flush())
    return [(e.event, e.id, e.retry, e.data) for e in out]


def _messages(parser_cls, chunks) -> list[tuple]:
    p = parser_cls()
    out = []
    for c in chunks:
        out.extend(p.feed(c))
    return [(m.headers, m.payload) for m in out]


# -- the build ------------------------------------------------------------


def test_library_is_built_under_build_native_named_by_hash(lib):
    path = nbuild.output_path(nbuild.LIBRARY)
    assert path.parent == ROOT / "build" / "native"
    assert path.name.startswith("libaigw_native-") and path.suffix == ".so"
    assert path.exists() and nbuild.build(nbuild.LIBRARY) == path
    assert native.available()
    # the hash covers the flags: another flag set is another file
    other = nbuild.Target("libaigw_native", nbuild.LIBRARY.sources,
                          ("-shared", "-DX"), nbuild.LIBRARY.libs, ".so")
    assert nbuild.output_path(other) != path


def test_core_binary_builds_with_the_makefile_flags():
    path = nbuild.core_binary()
    assert path.parent == ROOT / "build" / "native"
    assert path.name.startswith("aigw-core-")
    assert nbuild.CXXFLAGS == ("-O3", "-fPIC", "-std=c++17", "-Wall")
    assert nbuild.CORE.libs == ("-lpthread",)
    assert nbuild.LIBRARY.libs == ("-lz",)
    proc = subprocess.run([str(path)], capture_output=True, text=True,
                          timeout=10)
    assert proc.returncode == 2 and "usage: aigw-core" in proc.stderr


def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                      monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("int main() { return undeclared_name; }\n")
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "out")
    bad = nbuild.Target("broken", (str(src),), (), ())
    with pytest.raises(RuntimeError, match="undeclared_name") as e:
        nbuild.build(bad)
    assert "broken: the build failed" in str(e.value)
    assert not list((tmp_path / "out").glob("broken-*"))


def test_processes_that_ask_at_once_build_once(tmp_path):
    """Three processes build one fresh target together: the lock makes
    one of them compile; the others find its output."""
    src = tmp_path / "one.cpp"
    src.write_text("int main() { return 0; }\n")
    code = (
        "import sys, json\n"
        "from pathlib import Path\n"
        "from aigw_tpu_torch import native as n\n"
        f"n.BUILD_DIR = Path({str(tmp_path / 'out')!r})\n"
        f"t = n.Target('one', ({str(src)!r},), (), ())\n"
        "p = n.build(t)\n"
        "print(json.dumps([str(p), 'one' in n.last_build_s]))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [json.loads(p.communicate(timeout=120)[0]) for p in procs]
    assert len({o[0] for o in outs}) == 1
    assert sum(o[1] for o in outs) == 1


def test_nothing_is_built_into_the_reference_native_dir(lib):
    assert not (ROOT / "native" / "libaigw_native.so").exists()
    assert not (ROOT / "native" / "aigw-core").exists()


def test_scanner_is_off_until_load():
    """Importing the parsers builds nothing and loads nothing: the
    scanner is in use once ``load()`` ran (the gateway's ``run``)."""
    code = (
        "from aigw_tpu_torch.translate.sse import SSEParser\n"
        "from aigw_tpu_torch.utils import native\n"
        "assert not native.available()\n"
        "assert native.sse_scan(b'data: a\\n\\n') is None\n"
        "assert native.es_scan(b'') is None\n"
        "native.load()\n"
        "assert native.available()\n"
        "assert native.sse_scan(b'data: a\\n\\n')[0] == [(7, 2)]\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# -- SSE ------------------------------------------------------------------


def test_sse_scan_basic(lib):
    buf = b"data: a\n\nevent: x\ndata: b\r\n\r\ndata: partial"
    boundaries, tail, truncated = native.sse_scan(buf)
    assert not truncated
    assert boundaries == [(7, 2), (25, 4)]
    assert buf[tail:] == b"data: partial"


def test_sse_scan_takes_the_earlier_separator(lib):
    # "\r\n\r\n" holds no "\n\n": each event ends at the earlier one
    assert native.sse_scan(b"a\r\n\r\nb\n\n")[0] == [(1, 4), (6, 2)]
    assert native.sse_scan(b"a\n\n\r\n\r\n")[0] == [(1, 2), (3, 4)]
    assert native.sse_scan(b"") == ([], 0, False)


def test_sse_scan_caps_events_and_the_parser_rescans(lib):
    stream = b"data: x\n\n" * (native._MAX_EVENTS + 5)
    boundaries, tail, truncated = native.sse_scan(stream)
    assert truncated and len(boundaries) == native._MAX_EVENTS
    assert tail == 9 * native._MAX_EVENTS
    events = tsse.SSEParser().feed(stream)
    assert len(events) == native._MAX_EVENTS + 5


@pytest.mark.parametrize("seed", [7, 11, 23])
def test_sse_parity_fuzz(lib, seed):
    """Random chunkings of the reference's fuzz stream: the port's parser
    on the scanner, on its Python loop, and the reference's parser emit
    the same events."""
    from aigw_tpu.translate import sse as jsse
    from aigw_tpu.utils import native as jnative

    chunks = _chunks(_reference_fuzz_stream(seed), seed)
    with_scanner = _events(tsse.SSEParser, chunks)
    old = native._LIB
    native._LIB = None
    try:
        plain = _events(tsse.SSEParser, chunks)
    finally:
        native._LIB = old
    assert jnative._LIB is None  # the reference's library is not built
    reference = _events(jsse.SSEParser, chunks)
    assert with_scanner == plain == reference
    assert len(with_scanner) >= 140  # ~1/4 are comments, dropped


def test_reference_parser_on_the_port_scanner(lib):
    """The reference's ``SSEParser.feed`` wired to the port's scanner
    (its own binding, the port's library) gives what its Python loop
    gives: the port's copy is the reference's C ABI, byte for byte."""
    from aigw_tpu.translate import sse as jsse
    from aigw_tpu.utils import native as jnative

    chunks = _chunks(_reference_fuzz_stream(5), 5, hi=300)
    plain = _events(jsse.SSEParser, chunks)
    saved = (jnative._LIB, jnative._TRIED)
    try:
        jnative._LIB, jnative._TRIED = lib, True
        scanned = _events(jsse.SSEParser, chunks)
        assert jnative.sse_scan(b"data: a\n\n")[0] == [(7, 2)]
    finally:
        jnative._LIB, jnative._TRIED = saved
    assert scanned == plain


def test_sse_flush_and_tail_with_scanner(lib):
    p = tsse.SSEParser()
    assert p.feed(b"data: one\n\ndata: tw") == [tsse.SSEEvent(data="one")]
    assert p.feed(b"o\nid: 7") == []
    assert p.flush() == [tsse.SSEEvent(data="two", id="7")]


# -- AWS event-stream -----------------------------------------------------


def _frames(n: int) -> bytes:
    return b"".join(
        tes.encode_message({":event-type": f"e{i}",
                            ":message-type": "event"},
                           json.dumps({"i": i}).encode())
        for i in range(n))


@pytest.mark.parametrize("step", [1, 37, 4096])
def test_es_parity_with_python_and_reference(lib, step):
    from aigw_tpu.translate import eventstream as jes

    frames = _frames(50)
    chunks = [frames[i:i + step] for i in range(0, len(frames), step)]
    scanned = _messages(tes.EventStreamParser, chunks)
    old = native._LIB
    native._LIB = None
    try:
        plain = _messages(tes.EventStreamParser, chunks)
    finally:
        native._LIB = old
    reference = _messages(jes.EventStreamParser, chunks)
    assert scanned == plain == reference
    assert len(scanned) == 50


def test_es_scan_frames_and_tail(lib):
    one = tes.encode_message({":event-type": "x"}, b"{}")
    buf = one + one + one[:10]
    frames, tail, truncated = native.es_scan(buf)
    assert not truncated
    assert frames == [(0, len(one), frames[0][2]),
                      (len(one), len(one), frames[0][2])]
    assert tail == 2 * len(one)


def test_es_scan_caps_frames(lib):
    frames = _frames(native._MAX_FRAMES + 3)
    got, _tail, truncated = native.es_scan(frames)
    assert truncated and len(got) == native._MAX_FRAMES
    assert len(tes.EventStreamParser().feed(frames)) == \
        native._MAX_FRAMES + 3


@pytest.mark.parametrize("where", ["message", "prelude"])
def test_es_crc_error_raised(lib, where):
    good = tes.encode_message({":event-type": "x"}, b"{}")
    k = len(good) - 1 if where == "message" else 9
    corrupted = good[:k] + bytes([good[k] ^ 0xFF]) + good[k + 1:]
    with pytest.raises(ValueError, match="CRC"):
        tes.EventStreamParser().feed(corrupted)
    with pytest.raises(ValueError, match="CRC"):
        native.es_scan(corrupted)


def test_es_crc_errors_on_the_python_loop_too(python_only):
    good = tes.encode_message({":event-type": "x"}, b"{}")
    corrupted = good[:-1] + bytes([good[-1] ^ 0xFF])
    with pytest.raises(ValueError, match="CRC"):
        tes.EventStreamParser().feed(corrupted)


def test_es_framing_error_raised(lib):
    # a total length under the 16-byte minimum is malformed framing
    bad = (8).to_bytes(4, "big") + bytes(12)
    with pytest.raises(ValueError, match="framing"):
        native.es_scan(bad)
