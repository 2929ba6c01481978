"""Replay stores for MCP streamable-HTTP resumption (Last-Event-Id; the
port's copy of ``aigw_tpu/mcp/replay.py``, whose spool format it shares:
port and reference gateways on one ``replay_dir`` replay each other's
events).

The encrypted composite session is stateless by design — any replica can
decode it — but the *stream events* a client may ask to replay have to
live somewhere. Two stores behind one interface:

- ``MemoryReplayStore`` — bounded per-session deques in process memory.
  Replica-local: resumption works against the replica that served the
  original stream.
- ``FileReplayStore`` — one fcntl-locked JSONL spool file per session in
  a shared directory. Gateway processes and replicas mounting the same
  volume then replay each other's events, so
  Last-Event-Id resumption survives a load balancer sending the
  reconnect to a different replica. Event-id allocation happens under
  the same lock, so ids stay unique across replicas sharing a session.

The reference keeps this seam open the same way (its event store is an
interface with an in-memory default; sse.go). Configure via
``mcp: {replay_dir: /shared/path}``.
"""

from __future__ import annotations

import base64
import collections
import fcntl
import hashlib
import os
import time
from typing import Callable, Protocol

_REPLAY_EVENTS = 256  # per session
_REPLAY_SESSIONS = 1024


class ReplayBuffer(Protocol):
    def append(self, encode: Callable[[int], bytes]) -> bytes:
        """Allocate the next event id, encode the event with it, durably
        record (id, bytes), and return the bytes to write to the wire."""
        ...

    def events_after(self, last_id: int) -> list[bytes]: ...


class ReplayStore(Protocol):
    #: True when buffer methods do blocking I/O and must be called off
    #: the event loop; False when they are loop-safe inline calls.
    blocking: bool

    def buffer(self, session_token: str) -> ReplayBuffer | None: ...


def _key(session_token: str) -> str:
    return hashlib.sha256(session_token.encode()).hexdigest()[:32]


class _MemoryBuffer:
    def __init__(self) -> None:
        self.events: collections.deque = collections.deque(
            maxlen=_REPLAY_EVENTS
        )
        self.next_id = 1

    def append(self, encode: Callable[[int], bytes]) -> bytes:
        event_id = self.next_id
        self.next_id += 1
        encoded = encode(event_id)
        self.events.append((event_id, encoded))
        return encoded

    def events_after(self, last_id: int) -> list[bytes]:
        return [e for i, e in list(self.events) if i > last_id]


class MemoryReplayStore:
    # deque appends are loop-safe inline: running them on the loop keeps
    # them race-free (single-threaded) and free of executor dispatch
    blocking = False

    def __init__(self) -> None:
        self._sessions: "collections.OrderedDict[str, _MemoryBuffer]" = (
            collections.OrderedDict()
        )

    def buffer(self, session_token: str) -> _MemoryBuffer | None:
        if not session_token:
            return None
        key = _key(session_token)
        buf = self._sessions.get(key)
        if buf is None:
            buf = _MemoryBuffer()
            self._sessions[key] = buf
            while len(self._sessions) > _REPLAY_SESSIONS:
                self._sessions.popitem(last=False)
        else:
            self._sessions.move_to_end(key)
        return buf


class _FileBuffer:
    """One JSONL-ish spool file: ``<id> <base64(event bytes)>`` lines.

    Appends lock the file and read only the TAIL line to allocate the
    next id (O(last event), not O(buffer)); the full read+trim runs on
    the first append and then every ``_TRIM_EVERY`` appends, bounding
    the spool at ``_REPLAY_EVENTS + _TRIM_EVERY`` events between trims.
    A cached id floor keeps ids monotonic for a live stream even if a
    GC (or operator) unlinks the spool mid-stream.

    All methods do blocking I/O — callers on an event loop must wrap
    them (the proxy uses ``asyncio.to_thread``)."""

    _TRIM_EVERY = 64

    def __init__(self, path: str, gc: Callable[[], None] | None = None):
        self._path = path
        self._last_id = 0  # monotonic floor for this buffer's lifetime
        self._appends = 0
        # store-level GC hook, run inside append (i.e. in the caller's
        # worker thread, never on the event loop)
        self._gc = gc

    def _read_locked(self, f) -> list[tuple[int, bytes]]:
        events = []
        f.seek(0)
        for line in f.read().decode("utf-8", "replace").splitlines():
            sid, _, b64 = line.partition(" ")
            try:
                payload = base64.b64decode(b64)
                # a healed torn line whose fragment is only an id decodes
                # to an empty payload (b64decode(b'') succeeds) — don't
                # replay it as a phantom empty event
                if not payload:
                    continue
                events.append((int(sid), payload))
            except ValueError:
                continue  # torn line (crash mid-write): skip
        return events

    @staticmethod
    def _tail_id(f) -> int:
        """Id of the last complete line, scanning backwards from EOF."""
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size == 0:
            return 0
        chunk = b""
        pos = size
        while pos > 0:
            step = min(65536, pos)
            pos -= step
            f.seek(pos)
            chunk = f.read(step) + chunk
            # a crash mid-write can leave a torn final line with no \n;
            # it must not be trusted as the tail id (a truncated "123" read
            # as "12" would hand out regressed/duplicate event ids)
            if not chunk.endswith(b"\n"):
                cut = chunk.rfind(b"\n")
                if cut == -1:
                    continue  # keep scanning back for a complete line
                chunk = chunk[:cut + 1]
            # last complete line = text between the last two newlines
            idx = chunk.rstrip(b"\n").rfind(b"\n")
            if idx != -1 or pos == 0:
                last = chunk.rstrip(b"\n")[idx + 1:]
                try:
                    return int(last.split(b" ", 1)[0])
                except ValueError:
                    return 0
        return 0

    def append(self, encode: Callable[[int], bytes]) -> bytes:
        if self._gc is not None:
            self._gc()
        with open(self._path, "a+b") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            self._appends += 1
            trim = self._appends % self._TRIM_EVERY == 1
            if trim:
                events = self._read_locked(f)
                tail = events[-1][0] if events else 0
            else:
                events = None
                tail = self._tail_id(f)
            # max() with the cached floor: another replica may be ahead
            # (tail), or the file may have been GC'd away (_last_id)
            event_id = max(tail, self._last_id) + 1
            self._last_id = event_id
            encoded = encode(event_id)
            if events is not None and len(events) >= _REPLAY_EVENTS:
                events = events[-(_REPLAY_EVENTS - 1):]
                events.append((event_id, encoded))
                f.seek(0)
                f.truncate()
                for i, e in events:
                    f.write(b"%d %s\n" % (i, base64.b64encode(e)))
            else:
                f.seek(0, os.SEEK_END)
                # heal a torn tail (crash mid-write): appending straight
                # after it would merge two lines and lose both events
                if f.tell() > 0:
                    f.seek(-1, os.SEEK_END)
                    if f.read(1) != b"\n":
                        f.write(b"\n")
                f.write(b"%d %s\n" % (event_id, base64.b64encode(encoded)))
            f.flush()
        return encoded

    def events_after(self, last_id: int) -> list[bytes]:
        try:
            with open(self._path, "rb") as f:
                fcntl.flock(f, fcntl.LOCK_SH)
                events = self._read_locked(f)
        except OSError:  # incl. FileNotFoundError: nothing buffered
            return []
        return [e for i, e in events if i > last_id]


class FileReplayStore:
    blocking = True  # flock'd spool I/O: callers must thread-hop

    def __init__(self, directory: str):
        self._dir = directory
        os.makedirs(directory, exist_ok=True)
        self._gc_tick = 0

    def buffer(self, session_token: str) -> _FileBuffer | None:
        if not session_token:
            return None
        return _FileBuffer(os.path.join(self._dir, _key(session_token)),
                           gc=self._maybe_gc)

    def _maybe_gc(self) -> None:
        """Bound the spool directory: every 64th append (running in the
        appender's worker thread, never on the event loop), delete
        oldest-by-mtime files beyond the session cap or older than a
        day. Files touched within the last hour are never deleted, even
        over the cap — unlinking a live session's spool would break its
        resumption."""
        self._gc_tick += 1
        if self._gc_tick % 64 != 1:
            return
        try:
            entries = [
                (e.stat().st_mtime, e.path)
                for e in os.scandir(self._dir) if e.is_file()
            ]
        except OSError:
            return
        now = time.time()
        stale = now - 86400
        active = now - 3600
        entries.sort()
        excess = len(entries) - _REPLAY_SESSIONS
        for i, (mtime, path) in enumerate(entries):
            if mtime >= active:
                continue
            if i < excess or mtime < stale:
                try:
                    os.unlink(path)
                except OSError:
                    pass


def make_store(replay_dir: str) -> ReplayStore:
    return FileReplayStore(replay_dir) if replay_dir else MemoryReplayStore()
