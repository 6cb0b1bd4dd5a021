"""Low-overhead span tracer with Chrome-trace-event export.

Spans wrap the pipeline's hot stages (batcher enqueue→flush→step→drain,
corpus plan→upload→device-step→score→feedback, dist RPCs, host-oracle
calls). Each span gets a COUNTER-KEYED id (a process-wide monotonic
counter, never wall clock or entropy — ids must be stable enough to
correlate with JSON log lines, not random) and monotonic-clock timing.

Disabled (the default), ``span()`` is one attribute read returning a
shared no-op context manager — the <1% overhead contract the bench
corpus stage pins. Enabled, completed spans append one small dict to a
bounded in-memory event list exported as Chrome trace events
(``{"traceEvents": [...]}``), loadable in Perfetto / chrome://tracing,
and are mirrored into the flight recorder ring (obs/flight.py) so a
crash dump carries the seconds of spans before the incident.

``--xprof DIR`` additionally runs ``torch.profiler`` (CPU activity, and
CUDA activity when the run is on the card) from configure() to export(),
enters every span as a ``record_function`` so host spans and device
kernels line up on one timeline, and writes the profiler's Chrome trace
into DIR at export. torch is imported lazily and only on that path —
this module stays stdlib-pure otherwise.
"""

from __future__ import annotations

import json
import os
import threading
import time

from . import flight

#: bounded event list: ~100 bytes/event, 500k events ~ 50MB worst case;
#: beyond it events are dropped and counted (never silently)
MAX_EVENTS = 500_000


class _NoopSpan:
    """The disabled-path singleton: every method is a no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **attrs):
        return self

    @property
    def span_id(self):
        return 0


_NOOP = _NoopSpan()


class Span:
    """One live span. Use as a context manager; timing is monotonic
    (perf_counter) and never feeds back into replay values — the
    fuzzlint no-wallclock rule enforces that spans stay write-only from
    replay paths."""

    __slots__ = ("tracer", "name", "attrs", "span_id", "parent_id",
                 "_t0", "_xprof_ctx", "_remote_parent")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict,
                 remote_parent: int = 0):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = 0
        self.parent_id = 0
        self._t0 = 0.0
        self._xprof_ctx = None
        self._remote_parent = remote_parent

    def annotate(self, **attrs):
        """Attach extra args to the span (merged into the trace event)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        tr = self.tracer
        self.span_id = tr._next_id()
        stack = tr._stack()
        # a carried remote parent (frame header / cross-thread work item)
        # only applies at the top of a thread's stack — nested spans keep
        # parenting locally so in-process structure stays intact
        self.parent_id = (stack[-1].span_id if stack
                          else self._remote_parent)
        stack.append(self)
        if tr._prof is not None:
            import torch

            self._xprof_ctx = torch.profiler.record_function(self.name)
            self._xprof_ctx.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        tr = self.tracer
        if self._xprof_ctx is not None:
            self._xprof_ctx.__exit__(*exc)
            self._xprof_ctx = None
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        tr._finish(self, self._t0, t1)
        return False


class Tracer:
    """Process-wide span collector. configure() arms it; span() is the
    one hot-path entry point."""

    def __init__(self):
        self._lock = threading.Lock()
        self._enabled = False
        self._path: str | None = None
        self._events: list[dict] = []
        self._dropped = 0
        self._id = 0
        self._t_base = time.perf_counter()
        self._tls = threading.local()
        self._atexit_installed = False
        self._exported_upto = -1
        self._trace_id = ""
        self._nodes: dict[int, str] = {}
        self._xprof: str | None = None
        self._prof = None  # the running torch.profiler.profile

    # -- configuration ----------------------------------------------------

    def configure(self, path: str | None = None, xprof: str | None = None,
                  trace_id: str | None = None, xprof_cuda: bool = False):
        """Arm tracing (``--trace FILE`` / ``--xprof DIR``). Either
        argument alone enables span collection; export() writes the
        Chrome trace when a path is set, and the profiler's trace into
        the xprof directory. `xprof_cuda` adds the profiler's CUDA
        activity (a run on the card; a host run asks for none, so the
        profiler never touches CUDA). Calling with neither disables
        tracing again. `trace_id` names the campaign-wide trace every
        propagated context carries; defaults to a pid-derived id (never
        wall clock or entropy — same no-wallclock contract as span ids)."""
        self._export_xprof()  # a profiler still running from before
        with self._lock:
            self._path = path
            self._xprof = xprof
            self._enabled = bool(path or xprof)
            self._events = []
            self._dropped = 0
            self._t_base = time.perf_counter()
            self._exported_upto = -1
            self._trace_id = ((trace_id or f"t{os.getpid():08x}")
                              if self._enabled else "")
            self._nodes = {}
        if xprof:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if xprof_cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(xprof, exist_ok=True)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
        if self._enabled and not self._atexit_installed:
            import atexit

            atexit.register(self.export)
            self._atexit_installed = True

    def enabled(self) -> bool:
        return self._enabled

    # -- hot path ---------------------------------------------------------

    def span(self, name: str, **attrs):
        """Open a span (context manager). Free when tracing is disabled."""
        if not self._enabled:
            return _NOOP
        return Span(self, name, attrs)

    def span_remote(self, name: str, trace_id: str = "", parent: int = 0,
                    **attrs):
        """Open a span whose parent arrived over the wire (or from
        another thread's work item). `parent` is the remote span id; it
        only takes effect when this thread has no live local span, so
        propagated context never rewires in-process nesting. A foreign
        `trace_id` is recorded as a span arg for cross-node correlation."""
        if not self._enabled:
            return _NOOP
        if trace_id and trace_id != self._trace_id:
            attrs["trace_id"] = trace_id
        return Span(self, name, attrs, remote_parent=int(parent or 0))

    def current_span_id(self) -> int:
        """Innermost live span id on this thread (0 = none) — the
        correlation key JSON log lines carry."""
        stack = getattr(self._tls, "stack", None)
        return stack[-1].span_id if stack else 0

    def current_context(self) -> tuple[str, int]:
        """The ``(trace_id, span_id)`` pair to stamp into an outgoing
        frame header. ``("", 0)`` when tracing is disabled — callers
        skip the header keys entirely so the wire bytes are identical
        with tracing off."""
        if not self._enabled:
            return ("", 0)
        return (self._trace_id, self.current_span_id())

    def trace_id(self) -> str:
        return self._trace_id if self._enabled else ""

    # -- federation --------------------------------------------------------

    def take_events(self, start: int = 0) -> tuple[list[dict], int]:
        """Copy out the event tail from index `start` for telemetry
        shipping; returns ``(events, next_start)``. The event list is
        append-only between configure() calls, so `next_start` is a
        stable resume cursor."""
        with self._lock:
            return (list(self._events[start:]), len(self._events))

    def ingest(self, events: list, node: str) -> int:
        """Fold a worker's shipped span events into this tracer so one
        export covers the fleet. Events stamped with this process's own
        pid are skipped — in-process loopback workers share GLOBAL and
        their spans are already here. Returns the number ingested."""
        if not self._enabled or not events:
            return 0
        own = os.getpid()
        n = 0
        with self._lock:
            for ev in events:
                if not isinstance(ev, dict) or ev.get("pid") == own:
                    continue
                try:
                    pid = int(ev.get("pid", 0))
                except (TypeError, ValueError):
                    continue
                self._nodes.setdefault(pid, node)
                if len(self._events) < MAX_EVENTS:
                    self._events.append(ev)
                    n += 1
                else:
                    self._dropped += 1
        return n

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _next_id(self) -> int:
        with self._lock:
            self._id += 1
            return self._id

    def _finish(self, span: Span, t0: float, t1: float):
        ts_us = (t0 - self._t_base) * 1e6
        dur_us = (t1 - t0) * 1e6
        ev = {
            "name": span.name, "ph": "X", "ts": round(ts_us, 1),
            "dur": round(dur_us, 1), "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": {"span_id": span.span_id,
                     "parent_id": span.parent_id, **span.attrs},
        }
        with self._lock:
            if len(self._events) < MAX_EVENTS:
                self._events.append(ev)
            else:
                self._dropped += 1
        flight.GLOBAL.note_span(span.name, span.span_id, span.parent_id,
                                t0 - self._t_base, t1 - t0, span.attrs)

    # -- export -----------------------------------------------------------

    def export(self, path: str | None = None) -> str | None:
        """Write the Chrome trace JSON to `path` (default: the configured
        ``--trace`` file). Idempotent — safe to call from finally blocks
        AND atexit; returns the path written, or None when there is
        nowhere to write. The profiler of ``--xprof`` stops here and its
        trace lands in the xprof directory, with or without a path."""
        self._export_xprof()
        path = path or self._path
        if not path:
            return None
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
            nodes = dict(self._nodes)
            trace_id = self._trace_id
            # atexit backstop after an explicit export with no new spans:
            # nothing to add, and the target dir may already be gone
            # (tests export into a tempdir they then remove)
            if path == self._path and len(events) == self._exported_upto:
                return path
        own = os.getpid()
        names = {}
        for ev in events:
            if ev.get("pid") == own:
                names.setdefault(ev["tid"], None)
        meta = [
            {"name": "thread_name", "ph": "M", "pid": own,
             "tid": tid, "args": {"name": f"thread-{i}"}}
            for i, tid in enumerate(sorted(names))
        ]
        meta += [
            {"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": f"worker:{node}"}}
            for pid, node in sorted(nodes.items())
        ]
        doc = {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"tool": "erlamsa_tpu_torch", "dropped_events": dropped,
                          "trace_id": trace_id},
        }
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except OSError as e:
            # export must never take the process down (it runs from
            # finally blocks and atexit); the spans stay in memory
            from ..services import logger

            logger.log("warning", "obs: trace export to %s failed: %s",
                       path, e)
            return None
        with self._lock:
            if path == self._path:
                self._exported_upto = len(events)
        return path

    def _export_xprof(self) -> None:
        """Stop the ``--xprof`` profiler and write its Chrome trace into
        the xprof directory (``torch_trace.<pid>.json``); once."""
        with self._lock:
            prof, self._prof = self._prof, None
        if prof is None:
            return
        out = os.path.join(self._xprof, f"torch_trace.{os.getpid()}.json")
        try:
            prof.stop()
            prof.export_chrome_trace(out)
        except (OSError, RuntimeError) as e:
            # like the trace file: an export never takes the process down
            from ..services import logger

            logger.log("warning", "obs: profiler export to %s failed: %s",
                       out, e)

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self._enabled, "events": len(self._events),
                    "dropped": self._dropped, "path": self._path}


GLOBAL = Tracer()

# flight entries carry the active trace_id (satellite of the fleet
# telemetry plane); registered as a callback because trace imports
# flight, so flight cannot import trace back
flight.set_context_source(lambda: GLOBAL.trace_id())


def configure(path: str | None = None, xprof: str | None = None,
              trace_id: str | None = None, xprof_cuda: bool = False):
    GLOBAL.configure(path=path, xprof=xprof, trace_id=trace_id,
                     xprof_cuda=xprof_cuda)


def span(name: str, **attrs):
    return GLOBAL.span(name, **attrs)


def span_remote(name: str, trace_id: str = "", parent: int = 0, **attrs):
    return GLOBAL.span_remote(name, trace_id=trace_id, parent=parent,
                              **attrs)


def enabled() -> bool:
    return GLOBAL.enabled()


def current_span_id() -> int:
    return GLOBAL.current_span_id()


def current_context() -> tuple[str, int]:
    return GLOBAL.current_context()


def trace_id() -> str:
    return GLOBAL.trace_id()


def take_events(start: int = 0) -> tuple[list[dict], int]:
    return GLOBAL.take_events(start)


def ingest(events: list, node: str) -> int:
    return GLOBAL.ingest(events, node)


def export(path: str | None = None) -> str | None:
    return GLOBAL.export(path)
