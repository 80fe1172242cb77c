"""Nestable spans written as crash-safe, per-process JSONL trace files.

Own copy of ``repro.obs.trace``, whole: the files it writes are the
reference's format, under the same ``REPRO_TRACE_DIR`` variable.

Layout: one trace *directory* per run, one ``spans-<tag>.jsonl`` file per
writing process (tag = hostname + pid + an inherited worker discriminator)
— concurrent fleet workers never contend on a file, and the merge happens
at read time (:func:`read_trace` unions every file, drops torn trailing
lines, and dedups by span id, so re-reading / re-copying files is
idempotent).

Crash safety: every span is one self-contained JSON line, flushed on span
end.  A process dying mid-write can tear at most the final line, which
the reader detects and skips — no span that *was* fully written is ever
lost, and side files (metric snapshots) go through the same
``os.replace`` discipline as :func:`repro_torch.library.store.atomic_write_json`
(see :func:`atomic_write_json` here; obs stays stdlib-only).

Span ids are **deterministic**: derived from ``(process tag, sequence
number, name, parent id)``, not the clock, so a test with an injected
clock and a fixed tag reproduces byte-identical traces.  Wall-clock never
leaks into ids — only into the ``t0``/``dur_s`` fields, via an injectable
``clock``.

Process-global use::

    configure("runs/trace")            # exports REPRO_TRACE_DIR for children
    with span("fleet.job", engine="muscat", bits=4):
        ...
    event("serve.swap", reason="qos-load")

``span()`` is a no-op (shared null context) when tracing was never
configured, so instrumented hot paths cost one attribute load when off.
Worker processes (fork *or* spawn) auto-configure from the inherited
``REPRO_TRACE_DIR`` environment variable on their first span.
"""

from __future__ import annotations

import contextlib
import json
import hashlib
import os
import socket
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Iterator

__all__ = [
    "TRACE_DIR_ENV",
    "DEFAULT_SEGMENT_BYTES",
    "Tracer",
    "SpanHandle",
    "atomic_write_json",
    "configure",
    "current_tracer",
    "tracing_enabled",
    "span",
    "event",
    "read_trace",
]

TRACE_DIR_ENV = "REPRO_TRACE_DIR"

# rotate a process's span file once it crosses this many bytes: a
# long-running serve keeps a bounded active segment, and the rotated
# segments still match the ``spans-*.jsonl`` read glob so the merge is
# unchanged.  0 disables rotation.
DEFAULT_SEGMENT_BYTES = 8 * 1024 * 1024


def atomic_write_json(path: Path | str, doc: dict) -> None:
    """The store's temp-file + ``os.replace`` discipline, duplicated here
    so the observability core imports nothing heavier than the stdlib."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.stem}.",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(json.dumps(doc, sort_keys=True, indent=1))
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class SpanHandle:
    """What ``with span(...) as sp`` yields: lets the body attach result
    attributes (status, counts) that are only known at span end."""

    __slots__ = ("name", "span_id", "parent_id", "attrs", "t0")

    def __init__(self, name: str, span_id: str, parent_id: str | None,
                 attrs: dict, t0: float) -> None:
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.t0 = t0

    def set(self, **attrs) -> "SpanHandle":
        self.attrs.update(attrs)
        return self


class Tracer:
    """One process's span writer.

    ``process_tag`` defaults to ``<hostname>-<pid>`` (file-per-process);
    tests pin it (plus ``clock``) for fully deterministic traces.  The
    tracer is fork-aware: a forked child detects the pid change on its
    first span and re-opens its own file with a fresh tag, so two
    processes never interleave writes into one JSONL file.
    """

    def __init__(self, root: str | os.PathLike, *,
                 clock: Callable[[], float] = time.time,
                 process_tag: str | None = None,
                 max_segment_bytes: int = DEFAULT_SEGMENT_BYTES) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._clock = clock
        self._fixed_tag = process_tag
        self._pid = os.getpid()
        self._tag = process_tag or self._default_tag()
        self._seq = 0
        self._fh = None
        self._local = threading.local()
        self._lock = threading.Lock()
        self.max_segment_bytes = int(max_segment_bytes)
        self._size = 0
        self._rot = 0

    def _default_tag(self) -> str:
        return f"{socket.gethostname()}-{os.getpid()}"

    @property
    def tag(self) -> str:
        """The process tag side files (e.g. the provenance ledger's
        ``prov-<tag>.jsonl``) share so one run's artifacts correlate."""
        return self._tag

    @property
    def path(self) -> Path:
        return self.root / f"spans-{self._tag}.jsonl"

    # ----------------------------------------------------------------- write
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _fork_check(self) -> None:
        pid = os.getpid()
        if pid != self._pid:   # forked child inherited the parent tracer
            self._pid = pid
            self._tag = (f"{self._fixed_tag}-f{pid}" if self._fixed_tag
                         else self._default_tag())
            self._seq = 0
            self._fh = None
            self._local = threading.local()
            self._size = 0
            self._rot = 0

    def _rotate_locked(self) -> None:
        """Seal the active segment under a numbered name (still matching
        the ``spans-*.jsonl`` read glob) and start a fresh one.  Rotation
        happens at line boundaries only, so a rotated segment is never
        torn — only a crashed writer's *active* tail can be."""
        self._fh.close()
        while True:
            rotated = self.root / f"spans-{self._tag}.{self._rot:04d}.jsonl"
            self._rot += 1
            if not rotated.exists():
                break
        os.replace(self.path, rotated)
        self._fh = open(self.path, "a")
        self._size = 0

    def _write(self, doc: dict) -> None:
        data = json.dumps(doc, sort_keys=True) + "\n"
        with self._lock:
            if self._fh is None:
                self._fh = open(self.path, "a")
                self._size = self.path.stat().st_size
            if (self.max_segment_bytes > 0 and self._size > 0
                    and self._size + len(data) > self.max_segment_bytes):
                self._rotate_locked()
            self._fh.write(data)
            self._fh.flush()
            self._size += len(data)

    def _next_id(self, name: str, parent_id: str | None) -> str:
        with self._lock:
            seq, self._seq = self._seq, self._seq + 1
        blob = f"{self._tag}|{seq}|{name}|{parent_id or ''}"
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[SpanHandle]:
        self._fork_check()
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        handle = SpanHandle(name, self._next_id(name, parent), parent,
                            dict(attrs), self._clock())
        stack.append(handle)
        try:
            yield handle
        finally:
            stack.pop()
            self._write({
                "name": handle.name,
                "id": handle.span_id,
                "parent": handle.parent_id,
                "t0": handle.t0,
                "dur_s": self._clock() - handle.t0,
                "attrs": handle.attrs,
            })

    def event(self, name: str, **attrs) -> str:
        """Zero-duration span: swap decisions, refreshes, cause markers.
        Returns the span id so callers (the health plane's anomaly
        attribution) can name the exact trace event later."""
        with self.span(name, **attrs) as handle:
            pass
        return handle.span_id

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# ---------------------------------------------------------------------------
# process-global tracer
# ---------------------------------------------------------------------------
_tracer: Tracer | None = None
_checked_env = False


def configure(root: str | os.PathLike, *,
              clock: Callable[[], float] = time.time,
              process_tag: str | None = None,
              export_env: bool = True,
              max_segment_bytes: int = DEFAULT_SEGMENT_BYTES) -> Tracer:
    """Install the process-global tracer.  ``export_env`` publishes the
    trace dir to child processes (fleet pool workers, spawned or forked)
    through :data:`TRACE_DIR_ENV`."""
    global _tracer, _checked_env
    _tracer = Tracer(root, clock=clock, process_tag=process_tag,
                     max_segment_bytes=max_segment_bytes)
    _checked_env = True
    if export_env:
        os.environ[TRACE_DIR_ENV] = str(Path(root))
    return _tracer


def current_tracer() -> Tracer | None:
    """The global tracer; lazily adopts :data:`TRACE_DIR_ENV` so worker
    processes trace into the dir their parent configured."""
    global _tracer, _checked_env
    if _tracer is None and not _checked_env:
        _checked_env = True
        env_root = os.environ.get(TRACE_DIR_ENV)
        if env_root:
            _tracer = Tracer(env_root)
    return _tracer


def reset(*, clear_env: bool = True) -> None:
    """Drop the global tracer (tests)."""
    global _tracer, _checked_env
    if _tracer is not None:
        _tracer.close()
    _tracer = None
    _checked_env = False
    if clear_env:
        os.environ.pop(TRACE_DIR_ENV, None)


def tracing_enabled() -> bool:
    return current_tracer() is not None


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[SpanHandle]:
    """Module-level span against the global tracer; cheap no-op when
    tracing is off (the yielded handle still accepts ``.set()``)."""
    t = current_tracer()
    if t is None:
        yield SpanHandle(name, "", None, dict(attrs), 0.0)
        return
    with t.span(name, **attrs) as handle:
        yield handle


def event(name: str, **attrs) -> str:
    """Emit a zero-duration span; returns its id ("" when tracing is
    off) so control-plane callers can hand the id to attribution."""
    t = current_tracer()
    if t is None:
        return ""
    return t.event(name, **attrs)


# ---------------------------------------------------------------------------
# read-time merge
# ---------------------------------------------------------------------------
def read_trace(root: str | os.PathLike) -> list[dict]:
    """Union every per-process span file under ``root`` — including
    rotated segments (``spans-<tag>.<n>.jsonl``), which the glob matches
    by construction.

    Skips torn (crash-truncated) lines, dedups by span id — so reading a
    dir whose files were re-copied or doubled is idempotent — and returns
    spans sorted by ``(t0, id)``."""
    root = Path(root)
    spans: dict[str, dict] = {}
    for path in sorted(root.glob("spans-*.jsonl")):
        for line in path.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except json.JSONDecodeError:
                continue   # torn tail of a crashed writer
            if isinstance(doc, dict) and "id" in doc:
                spans.setdefault(doc["id"], doc)
    return sorted(spans.values(), key=lambda s: (s.get("t0", 0.0), s["id"]))
