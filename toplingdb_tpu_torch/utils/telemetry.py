"""Request-scoped span tracing: the telemetry plane's core (copied from
toplingdb_tpu/utils/telemetry.py).

A low-overhead tracer in the dapper/opentelemetry shape, scoped to what the
engine needs:

  Tracer      per-process (one per DB; one per dcompact worker / follower)
              span factory with 1-in-N root sampling, an always-sample
              latency backstop (ops slower than `slow_usec` leave at least
              a root span even when the sampling die missed them), and a
              bounded ring of finished traces.
  Span        one timed region. Monotonic-clock durations; wall-clock only
              at the trace root (for display). Spans form a tree via
              parent_id and serialize to plain dicts so they can cross
              process boundaries in results.json / replication pulls.
  propagation inject() exports the current (trace_id, span_id, sampled)
              context; a remote process adopts it with start_from() and
              returns its finished spans, which attach_remote() stitches
              back into the originating trace — dcompact workers and
              replication followers both ride this.

Hot-path cost discipline: the root-sampling check is inlined at call sites
(`tr.sample_every and next(tr.counter) % tr.sample_every == 0` — one
attribute read, one C-level count, one mod); everything heavier runs only
on the sampled 1-in-N. Child-span helpers no-op from a ~single dict lookup
when the current thread carries no sampled trace.

Chrome trace-event JSON export (`chrome_trace`) renders in chrome://tracing
or Perfetto.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import OrderedDict, deque
from toplingdb_tpu_torch.utils import concurrency as ccy

_tls = threading.local()


class Span:
    """One timed region of one trace. `start_us` is the offset from the
    trace root's start (µs); `dur_us` is filled at finish."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_us",
                 "dur_us", "proc", "tags", "_t0", "_trace", "_tracer")

    def __init__(self, name, trace_id, span_id, parent_id, proc, tags):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.proc = proc
        self.tags = tags
        self.start_us = 0
        self.dur_us = 0
        self._t0 = 0.0
        self._trace = None
        self._tracer = None

    def tag(self, **kw) -> "Span":
        self.tags.update(kw)
        return self

    def finish(self) -> None:
        tr = self._tracer
        if tr is not None:
            tr._finish_span(self)

    # Context-manager protocol: `with tracer.span(...)` / module span().
    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is not None:
            self.tags["error"] = repr(ev)[:200]
        self.finish()
        return False

    def to_dict(self) -> dict:
        return {
            "name": self.name, "trace_id": self.trace_id,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "start_us": self.start_us, "dur_us": self.dur_us,
            "proc": self.proc, "tags": self.tags,
        }

    @staticmethod
    def from_dict(d: dict) -> "Span":
        s = Span(d.get("name", "?"), d.get("trace_id", ""),
                 d.get("span_id", 0), d.get("parent_id", 0),
                 d.get("proc", "remote"), dict(d.get("tags") or {}))
        s.start_us = int(d.get("start_us", 0))
        s.dur_us = int(d.get("dur_us", 0))
        return s


class _NoopSpan:
    """Shared do-nothing span: returned when no sampled trace is active so
    instrumentation sites never branch."""

    __slots__ = ()

    def tag(self, **kw):
        return self

    def finish(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


NOOP_SPAN = _NoopSpan()


class Trace:
    """One finished (or in-flight) trace: the root span plus every local
    and stitched-remote child."""

    __slots__ = ("trace_id", "root", "spans", "slow", "start_unix_us",
                 "_mono0")

    def __init__(self, trace_id, root, start_unix_us, mono0):
        self.trace_id = trace_id
        self.root = root
        self.spans = [root]
        self.slow = False
        self.start_unix_us = start_unix_us
        self._mono0 = mono0

    @property
    def name(self) -> str:
        return self.root.name

    @property
    def dur_us(self) -> int:
        return self.root.dur_us

    def summary(self) -> dict:
        return {
            "trace_id": self.trace_id, "name": self.root.name,
            "start_unix_us": self.start_unix_us, "dur_us": self.root.dur_us,
            "slow": self.slow, "n_spans": len(self.spans),
            "procs": sorted({s.proc for s in self.spans}),
            "tags": self.root.tags,
        }


class Tracer:
    """Span factory + finished-trace ring for one process role.

    sample_every  N: roots created by maybe_sample() fire 1-in-N (0 = off).
                  Forced roots (start()) ignore sampling — used for rare,
                  high-value ops (flush, compaction).
    slow_usec     ops slower than this always leave a (root-only) trace
                  via note_slow(), even when unsampled. 0 = off.
    ring          bound on retained finished traces (and the trace_id
                  index and the seq→context map: nothing here grows with
                  uptime).
    """

    def __init__(self, sample_every: int = 0, slow_usec: int = 0,
                 ring: int = 256, proc: str = "db"):
        self.sample_every = max(0, int(sample_every))
        self.slow_usec = max(0, int(slow_usec))
        self.proc = proc
        self.counter = itertools.count(1)
        self._span_ids = itertools.count(1)
        # Trace ids: one urandom read per TRACER, then a counter — an
        # os.urandom syscall per trace was the bulk of a sampled op's
        # cost.
        self._tid_base = os.urandom(6).hex()
        self._tid_n = itertools.count(1)
        self._mu = ccy.Lock("telemetry.Tracer._mu")
        self._ring: deque[Trace] = deque(maxlen=max(1, int(ring)))
        self._by_id: dict[str, Trace] = {}
        self._active: dict[str, Trace] = {}
        # seq → trace context of recent sampled writes (replication
        # propagation); bounded independently of the ring.
        self._seq_ctx: OrderedDict[int, dict] = OrderedDict()
        self._seq_cap = 1024
        self.traces_started = 0
        self.traces_dropped = 0  # remote spans whose trace was evicted

    @property
    def enabled(self) -> bool:
        return self.sample_every > 0 or self.slow_usec > 0

    # -- root spans ----------------------------------------------------

    def maybe_sample(self, name: str, **tags) -> Span | None:
        """1-in-N root decision + creation; None when the die missed.
        Hot call sites inline the check via `tr.sample_every` and
        `tr.counter` instead and call start() only on the hit."""
        if self.sample_every and next(self.counter) % self.sample_every == 0:
            return self.start(name, **tags)
        return None

    def _new_tid(self) -> str:
        return f"{self._tid_base}{next(self._tid_n):06x}"

    def start(self, name: str, **tags) -> Span:
        """Forced root span (no sampling): flush/compaction-grade ops."""
        return self._root(name, self._new_tid(), 0, tags)

    def start_from(self, ctx: dict | None, name: str, **tags) -> Span:
        """Adopt a propagated context (remote side of a cross-process
        hop): the new root parents under ctx['span_id'] within
        ctx['trace_id']. Falls back to a fresh root when ctx is None."""
        if not ctx or not ctx.get("trace_id"):
            return self.start(name, **tags)
        return self._root(name, str(ctx["trace_id"]),
                          int(ctx.get("span_id", 0)), tags)

    def _root(self, name, trace_id, parent_id, tags) -> Span:
        sp = Span(name, trace_id, next(self._span_ids), parent_id,
                  self.proc, tags)
        now = time.monotonic()
        sp._t0 = now
        tr = Trace(trace_id, sp, int(time.time() * 1e6), now)
        sp._trace = tr
        sp._tracer = self
        # Lock-free registration (dict set/del are GIL-atomic): the lock
        # is reserved for ring retirement, keeping a sampled op cheap.
        self.traces_started += 1
        self._active[trace_id] = tr
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(sp)
        return sp

    def note_slow(self, name: str, dur_us: float, **tags) -> None:
        """Always-sample backstop: record a root-only trace for an op the
        sampler skipped but whose latency crossed slow_usec."""
        sp = Span(name, self._new_tid(), next(self._span_ids), 0,
                  self.proc, tags)
        sp.dur_us = int(dur_us)
        tr = Trace(sp.trace_id, sp, int(time.time() * 1e6 - dur_us),
                   time.monotonic())
        tr.slow = True
        with self._mu:
            self._retire(tr)

    # -- child spans ---------------------------------------------------

    def _child(self, parent: Span, name: str, tags: dict) -> Span:
        trace = parent._trace
        sp = Span(name, parent.trace_id, next(self._span_ids),
                  parent.span_id, self.proc, tags)
        now = time.monotonic()
        sp._t0 = now
        sp.start_us = int((now - trace._mono0) * 1e6)
        sp._trace = trace
        sp._tracer = self
        trace.spans.append(sp)  # list.append: GIL-atomic
        return sp

    def _finish_span(self, sp: Span) -> None:
        sp.dur_us = int((time.monotonic() - sp._t0) * 1e6)
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is sp:
            stack.pop()
        elif stack is not None:
            try:
                stack.remove(sp)
            except ValueError:
                pass
        trace = sp._trace
        if trace is not None and trace.root is sp:
            if self.slow_usec and sp.dur_us >= self.slow_usec:
                trace.slow = True
            self._active.pop(trace.trace_id, None)
            with self._mu:
                self._retire(trace)

    def _retire(self, trace: Trace) -> None:
        # caller holds _mu
        if len(self._ring) == self._ring.maxlen:
            self._by_id.pop(self._ring[0].trace_id, None)
        self._ring.append(trace)
        self._by_id[trace.trace_id] = trace

    # -- cross-process stitching ---------------------------------------

    def attach_remote(self, spans) -> int:
        """Adopt finished remote span dicts (a dcompact worker's
        results.json, a follower's pull-time ack) into their originating
        traces. Unknown trace ids (ring already evicted) are dropped
        silently — a late ack must never error or leak. Returns the
        number of spans attached."""
        n = 0
        for d in spans or ():
            try:
                sp = Span.from_dict(d)
            except Exception:  # noqa: BLE001 - a malformed ack is dropped
                continue
            with self._mu:
                tr = self._active.get(sp.trace_id) \
                    or self._by_id.get(sp.trace_id)
                if tr is None:
                    self.traces_dropped += 1
                    continue
                tr.spans.append(sp)
                n += 1
        return n

    # -- replication seq → context map ---------------------------------

    def note_seq(self, seq: int, root: Span) -> None:
        """Remember a sampled write's context by its last sequence so WAL
        shipping can propagate it to followers."""
        with self._mu:
            self._seq_ctx[int(seq)] = {
                "seq": int(seq), "trace_id": root.trace_id,
                "span_id": root.span_id, "sampled": 1,
            }
            while len(self._seq_ctx) > self._seq_cap:
                self._seq_ctx.popitem(last=False)

    def ctxs_in_range(self, first_seq: int, last_seq: int) -> list[dict]:
        with self._mu:
            return [c for s, c in self._seq_ctx.items()
                    if first_seq <= s <= last_seq]

    # -- views ----------------------------------------------------------

    def finished(self, slow_only: bool = False, limit: int = 64):
        with self._mu:
            out = [t for t in reversed(self._ring)
                   if t.slow or not slow_only]
        return out[:limit]

    def get_trace(self, trace_id: str) -> Trace | None:
        with self._mu:
            return self._by_id.get(trace_id) or self._active.get(trace_id)

    def export_trace(self, trace_id: str) -> list[dict]:
        """Finished spans of one trace as plain dicts (the remote side's
        half of attach_remote)."""
        tr = self.get_trace(trace_id)
        return [s.to_dict() for s in tr.spans] if tr is not None else []

    def chrome_trace(self, trace_id: str) -> dict | None:
        """Chrome trace-event JSON (chrome://tracing / Perfetto)."""
        tr = self.get_trace(trace_id)
        if tr is None:
            return None
        events = []
        for s in tr.spans:
            events.append({
                "name": s.name, "ph": "X", "ts": s.start_us,
                "dur": max(1, s.dur_us), "pid": s.proc,
                "tid": s.proc, "args": dict(s.tags),
            })
        return {
            "traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {
                "trace_id": tr.trace_id, "slow": tr.slow,
                "start_unix_us": tr.start_unix_us,
            },
        }

    def status(self) -> dict:
        with self._mu:
            return {
                "sample_every": self.sample_every,
                "slow_usec": self.slow_usec,
                "traces_started": self.traces_started,
                "traces_retained": len(self._ring),
                "traces_active": len(self._active),
                "remote_spans_dropped": self.traces_dropped,
                "seq_ctx_entries": len(self._seq_ctx),
            }


# ---------------------------------------------------------------------------
# Module-level helpers: operate on the CALLING THREAD's active span, so
# instrumentation deep in the table/ops layers needs no tracer plumbing.
# ---------------------------------------------------------------------------


def current_span() -> Span | None:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def current_trace_id() -> str | None:
    sp = current_span()
    return sp.trace_id if sp is not None else None


def span(name: str, **tags):
    """Child span under the calling thread's active span; NOOP_SPAN when
    no sampled trace is active here."""
    stack = getattr(_tls, "stack", None)
    if not stack:
        return NOOP_SPAN
    parent = stack[-1]
    sp = parent._tracer._child(parent, name, tags)
    stack.append(sp)
    return sp


def span_event(name: str, dur_us, **tags) -> None:
    """Already-measured child span (native interiors, phase timers): no
    enter/exit pair, just the recorded duration attached under the calling
    thread's active span."""
    stack = getattr(_tls, "stack", None)
    if not stack:
        return
    parent = stack[-1]
    # _child pushes nothing onto the tls stack; just close the span out,
    # back-dating its start so the waterfall shows where the time went.
    sp = parent._tracer._child(parent, name, tags)
    sp.start_us = max(0, sp.start_us - int(dur_us))
    sp.dur_us = int(dur_us)


def current_handle():
    """Exportable handle of the calling thread's active span, for stages
    that run in OTHER threads (pipeline workers): pass it along and create
    children with span_under()/span_event_under(). None when untraced."""
    return current_span()


def span_under(parent: Span | None, name: str, **tags):
    """Cross-thread child span under an exported handle (NOT the calling
    thread's tls). NOOP_SPAN when the handle is None."""
    if parent is None:
        return NOOP_SPAN
    return parent._tracer._child(parent, name, tags)


def span_event_under(parent: Span | None, name: str, dur_us,
                     **tags) -> None:
    if parent is None:
        return
    sp = parent._tracer._child(parent, name, tags)
    sp.start_us = max(0, sp.start_us - int(dur_us))
    sp.dur_us = int(dur_us)


def inject() -> dict | None:
    """Export the calling thread's context for a process hop: {"trace_id",
    "span_id", "sampled"}. None when no trace is active (the remote side
    then runs untraced)."""
    sp = current_span()
    if sp is None:
        return None
    return {"trace_id": sp.trace_id, "span_id": sp.span_id, "sampled": 1}


def attach_current(spans) -> int:
    """attach_remote against the calling thread's active tracer."""
    sp = current_span()
    if sp is None or sp._tracer is None:
        return 0
    return sp._tracer.attach_remote(spans)


def tracer_from_options(options, proc: str = "db") -> Tracer | None:
    """The DB-side construction point: None unless a knob turns it on."""
    se = int(getattr(options, "trace_sample_every", 0) or 0)
    su = int(getattr(options, "trace_slow_usec", 0) or 0)
    if se <= 0 and su <= 0:
        return None
    return Tracer(sample_every=se, slow_usec=su,
                  ring=int(getattr(options, "trace_ring", 256) or 256),
                  proc=proc)
