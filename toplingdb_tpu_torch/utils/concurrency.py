"""Concurrency correctness plane (copied from
toplingdb_tpu/utils/concurrency.py, whole): named lock factories,
instrumented debug wrappers, and a ThreadRegistry.

Every lock and background thread of the package is created through this
module, so that each creation site carries a stable *lock class* and a
runtime debug mode can interpose on every acquisition.

Production mode (default): `Lock(name)` / `RLock(name)` / `Condition`
return **plain** `threading` primitives: the name argument costs one
function call at creation time and nothing per acquire.

Debug mode (`set_debug(True)` before the locks are created): the
factories return instrumented wrappers that keep a per-thread held-set
and a global lock-class acquisition-order graph. Acquiring B while
holding A records the edge A->B with the acquiring stack; if the reverse
path B~>A is already on record the acquisition raises
`LockInversionError` carrying BOTH stacks (ours and the recorded
witness). A hold longer than the watchdog threshold (`set_watchdog_ms`,
default 30000) reports through the watchdog handler at release time;
`scan_long_holds()` finds still-held offenders (a real deadlock) on
demand, with the holder's live stack via sys._current_frames().

The port reads no environment variable for either switch (toplingdb_tpu
reads TPULSM_LOCK_DEBUG and TPULSM_LOCK_WATCHDOG_MS at import): debug
mode and the watchdog are set only through `set_debug()` and
`set_watchdog_ms()`.

Threads: `spawn(name, target, ...)` creates a **named** thread,
registers it with the global `ThreadRegistry`, and deregisters it when
the target returns. `registry.check_leaks(owner)` backs the `DB.close()`
leak check and the tests' leak fixtures.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
import warnings
import weakref

__all__ = [
    "Lock", "RLock", "Condition", "spawn", "registry", "ThreadRegistry",
    "LockInversionError", "lock_debug_enabled", "set_debug",
    "reset_lock_graph", "lock_order_edges", "scan_long_holds",
    "set_watchdog_handler", "set_watchdog_ms", "held_lock_classes",
]

_DEBUG = False
_WATCHDOG_MS = 30000.0


def lock_debug_enabled() -> bool:
    return _DEBUG


def set_debug(on: bool) -> None:
    """Flip debug mode for locks created *after* this call (tests/bench).
    Already-created locks keep their mode."""
    global _DEBUG
    _DEBUG = bool(on)


def set_watchdog_ms(ms: float) -> None:
    global _WATCHDOG_MS
    _WATCHDOG_MS = float(ms)


class LockInversionError(RuntimeError):
    """Acquisition order cycle between lock classes — carries both the
    acquiring stack and the recorded witness stack of the reverse edge."""


def _snap_stack(skip: int = 2, limit: int = 16) -> list:
    """Cheap stack snapshot: (filename, lineno, funcname) per frame.
    Formatting (source-line lookup, string build) is what makes
    traceback.format_stack cost ~30µs per acquire; deferring it to
    _fmt_snap keeps the per-acquire debug tax at a frame walk."""
    try:
        f = sys._getframe(skip)
    except ValueError:
        return []
    out = []
    while f is not None and len(out) < limit:
        co = f.f_code
        out.append((co.co_filename, f.f_lineno, co.co_name))
        f = f.f_back
    out.reverse()
    return out


def _fmt_snap(snap: list) -> str:
    import linecache

    lines = []
    for fn, ln, name in snap:
        lines.append(f'  File "{fn}", line {ln}, in {name}\n')
        src = linecache.getline(fn, ln).strip()
        if src:
            lines.append(f"    {src}\n")
    return "".join(lines)


# ---------------------------------------------------------------------------
# Global acquisition-order graph (debug mode only)
# ---------------------------------------------------------------------------


class _LockGraph:
    """Lock-class level order graph.  Nodes are lock-class names; an edge
    A→B means some thread acquired a B-class lock while holding an
    A-class lock.  The graph only ever grows (edges are never removed on
    release): ordering is a global program property, not a per-moment
    one, which is exactly what makes inversions detectable before the
    interleaving that would actually deadlock."""

    def __init__(self):
        # The graph's own mutex stays a RAW threading lock: it must never
        # itself be tracked (that would recurse).
        self._mu = threading.Lock()
        # (from_class, to_class) -> witness dict
        self.edges: dict[tuple[str, str], dict] = {}
        self._adj: dict[str, set[str]] = {}

    def clear(self) -> None:
        with self._mu:
            self.edges.clear()
            self._adj.clear()

    def _path(self, src: str, dst: str) -> list[str] | None:
        """DFS path src ⇝ dst over current adjacency (caller holds _mu)."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._adj.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def note(self, held_class: str, new_class: str, snap: list,
             thread_name: str) -> None:
        """Record edge held→new; raise LockInversionError if the reverse
        path already exists."""
        if held_class == new_class:
            # Same lock class (lock striping / two instances of one
            # class): instance-level order is not statically nameable, so
            # class self-edges are ignored — mirrors the analyzer.
            return
        key = (held_class, new_class)
        if key in self.edges:
            return  # steady-state fast path: edges only ever grow
        with self._mu:
            if key in self.edges:
                return
            rev = self._path(new_class, held_class)
            if rev is not None:
                # Build the witness chain of the reverse path.
                parts = []
                for a, b in zip(rev, rev[1:]):
                    w = self.edges[(a, b)]
                    parts.append(
                        f"  edge {a} -> {b} (thread {w['thread']}):\n"
                        + _fmt_snap(w["snap"]))
                raise LockInversionError(
                    f"lock order inversion: acquiring {new_class!r} while "
                    f"holding {held_class!r} (thread {thread_name}), but "
                    f"the order {' -> '.join(rev)} is already on record.\n"
                    f"--- acquiring stack (this thread) ---\n"
                    f"{_fmt_snap(snap)}"
                    f"--- recorded witness path ---\n" + "\n".join(parts))
            self.edges[key] = {"snap": snap, "thread": thread_name,
                               "time": time.time()}
            self._adj.setdefault(held_class, set()).add(new_class)


_graph = _LockGraph()
_tls = threading.local()


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def held_lock_classes() -> list[str]:
    """Lock classes currently held by the calling thread (debug mode)."""
    return [e[1] for e in _held()]


def reset_lock_graph() -> None:
    _graph.clear()


def lock_order_edges() -> dict[tuple[str, str], dict]:
    return dict(_graph.edges)


# Watchdog: long holds report through this handler (default: RuntimeWarning).
def _default_watchdog(lock_class: str, held_s: float, stack: str) -> None:
    warnings.warn(
        f"lock {lock_class!r} held for {held_s:.3f}s (> watchdog "
        f"{_WATCHDOG_MS / 1000.0:.3f}s); acquired at:\n{stack}",
        RuntimeWarning, stacklevel=3)


_watchdog_handler = _default_watchdog


def set_watchdog_handler(fn) -> None:
    """fn(lock_class, held_seconds, acquire_stack) — None restores default."""
    global _watchdog_handler
    _watchdog_handler = fn or _default_watchdog


def scan_long_holds(threshold_ms: float | None = None) -> list[dict]:
    """Still-held locks exceeding the threshold, with the holder's LIVE
    stack — the on-demand probe for wedged threads (a deadlocked holder
    never reaches the release-time check)."""
    thr = (_WATCHDOG_MS if threshold_ms is None else threshold_ms) / 1000.0
    now = time.monotonic()
    out = []
    frames = sys._current_frames()
    for lock in list(_DebugLockBase._live):
        t0 = lock._acquired_at
        tid = lock._owner
        if t0 is None or tid is None or now - t0 < thr:
            continue
        fr = frames.get(tid)
        out.append({
            "lock_class": lock.lock_class,
            "held_s": now - t0,
            "thread_id": tid,
            "holder_stack": "".join(traceback.format_stack(fr))
            if fr is not None else "<thread gone>",
        })
    return out


# ---------------------------------------------------------------------------
# Debug wrappers
# ---------------------------------------------------------------------------


class _DebugLockBase:
    """Shared acquire/release bookkeeping.  Also implements the
    _release_save/_acquire_restore/_is_owned protocol so a
    threading.Condition built over a wrapper keeps the held-set honest
    across wait()."""

    _live: "weakref.WeakSet[_DebugLockBase]"

    __slots__ = ("lock_class", "_inner", "_owner", "_count",
                 "_acquired_at", "_acquire_snap", "__weakref__")

    def __init__(self, lock_class: str, inner):
        self.lock_class = lock_class
        self._inner = inner
        self._owner: int | None = None
        self._count = 0
        self._acquired_at: float | None = None
        self._acquire_snap: list | None = None
        _DebugLockBase._live.add(self)

    # -- tracking helpers ------------------------------------------------
    def _track_acquire(self) -> None:
        me = threading.get_ident()
        if self._owner == me:           # re-entrant (RLock only)
            self._count += 1
            return
        snap = _snap_stack(skip=3)
        held = _held()
        try:
            for _lk, held_class, _st in held:
                _graph.note(held_class, self.lock_class, snap,
                            threading.current_thread().name)
        except LockInversionError:
            # The acquisition SUCCEEDED at the threading layer; undo it so
            # the raise does not leave an orphaned hold.
            self._inner.release()
            raise
        self._owner = me
        self._count = 1
        self._acquired_at = time.monotonic()
        self._acquire_snap = snap
        held.append((self, self.lock_class, snap))

    def _track_release(self) -> None:
        me = threading.get_ident()
        if self._owner != me:
            return
        self._count -= 1
        if self._count > 0:
            return
        if self._acquired_at is not None and _WATCHDOG_MS > 0:
            held_s = time.monotonic() - self._acquired_at
            if held_s * 1000.0 > _WATCHDOG_MS:
                _watchdog_handler(self.lock_class, held_s,
                                  _fmt_snap(self._acquire_snap or []))
        self._owner = None
        self._acquired_at = None
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                del held[i]
                break

    # -- lock protocol ---------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._track_acquire()
        return ok

    def release(self) -> None:
        self._track_release()
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # -- Condition protocol (wait must drop the held-set entry too) ------
    def _release_save(self):
        count = self._count
        self._count = 1                 # _track_release drops it fully
        self._track_release()
        if hasattr(self._inner, "_release_save"):
            state = self._inner._release_save()
        else:
            self._inner.release()
            state = None
        return (count, state)

    def _acquire_restore(self, saved):
        count, state = saved
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        self._track_acquire()
        self._count = count

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def __repr__(self):
        return (f"<{type(self).__name__} {self.lock_class!r} "
                f"owner={self._owner}>")


_DebugLockBase._live = weakref.WeakSet()


class _DebugLock(_DebugLockBase):
    __slots__ = ()

    def __init__(self, lock_class: str):
        super().__init__(lock_class, threading.Lock())


class _DebugRLock(_DebugLockBase):
    __slots__ = ()

    def __init__(self, lock_class: str):
        super().__init__(lock_class, threading.RLock())


# ---------------------------------------------------------------------------
# Factories (the only lock constructors the package may use)
# ---------------------------------------------------------------------------


def Lock(name: str):
    """A mutex whose creation site carries a stable lock-class name.
    Plain threading.Lock in production; instrumented under debug."""
    if _DEBUG:
        return _DebugLock(name)
    return threading.Lock()


def RLock(name: str):
    if _DEBUG:
        return _DebugRLock(name)
    return threading.RLock()


def Condition(name: str | None = None, lock=None):
    """Condition over a named fresh lock, or over an existing (possibly
    wrapped) lock created by these factories — `Condition(lock=self._mu)`
    shares _mu's lock class."""
    if lock is not None:
        return threading.Condition(lock)
    if name is None:
        raise TypeError("Condition() needs a lock-class name or lock=")
    if _DEBUG:
        return threading.Condition(_DebugLock(name))
    return threading.Condition()


# ---------------------------------------------------------------------------
# ThreadRegistry + spawn
# ---------------------------------------------------------------------------


class ThreadRegistry:
    """Tracks every background thread the package starts.  Entries
    auto-deregister when the thread's target returns; whatever is still
    live and owned by X when `check_leaks(X)` runs is a lifecycle leak
    (e.g. the unstopped-scrubber case in DB.close())."""

    def __init__(self):
        self._mu = threading.Lock()     # raw: registry is infrastructure
        self._entries: dict[int, dict] = {}

    def register(self, thread: threading.Thread, owner=None,
                 stop=None) -> None:
        if not thread.name or thread.name.startswith("Thread-"):
            raise ValueError(
                f"refusing to register unnamed thread {thread!r}: every "
                f"package thread must carry a name=")
        with self._mu:
            self._entries[id(thread)] = {
                "thread": thread,
                "name": thread.name,
                "owner_id": id(owner) if owner is not None else None,
                "owner_repr": type(owner).__name__ if owner is not None
                else None,
                "stop": stop,
                "started_at": time.time(),
            }

    def deregister(self, thread: threading.Thread) -> None:
        with self._mu:
            self._entries.pop(id(thread), None)

    def _select(self, owner=None) -> list[dict]:
        with self._mu:
            entries = list(self._entries.values())
        out = []
        for e in entries:
            t = e["thread"]
            if t.ident is None:
                # Registered but not yet started (spawn(start=False)):
                # neither live nor reapable yet.
                continue
            if not t.is_alive():
                # Reap threads that exited without the spawn wrapper
                # running its deregister (e.g. killed interpreter-side).
                self.deregister(t)
                continue
            if owner is not None and e["owner_id"] != id(owner):
                continue
            out.append(e)
        return out

    def live(self, owner=None) -> list[threading.Thread]:
        return [e["thread"] for e in self._select(owner)]

    def check_leaks(self, owner=None) -> list[str]:
        """Names of still-live registered threads (for `owner`)."""
        return sorted(e["name"] for e in self._select(owner))

    def stop_all(self, owner=None, timeout: float = 5.0) -> list[str]:
        """Invoke each entry's stop callable (if any) then join; returns
        the names that survived anyway."""
        for e in self._select(owner):
            stop = e.get("stop")
            if stop is not None:
                try:
                    stop()
                except Exception as e:  # noqa: BLE001 — best-effort sweep
                    # Lazy: errors.py imports this module at module level.
                    from toplingdb_tpu_torch.utils import errors as _errors
                    _errors.swallow(reason="thread-stop-sweep", exc=e)
        return self.join_all(owner, timeout)

    def join_all(self, owner=None, timeout: float = 5.0) -> list[str]:
        deadline = time.monotonic() + timeout
        leaked = []
        for e in self._select(owner):
            t = e["thread"]
            t.join(max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                leaked.append(e["name"])
        return sorted(leaked)


registry = ThreadRegistry()


def spawn(name: str, target, *, args=(), kwargs=None, daemon: bool = True,
          owner=None, stop=None, start: bool = True) -> threading.Thread:
    """The package's only thread constructor: named, registered, and
    auto-deregistering.  `owner` ties the thread to a lifecycle scope
    (e.g. a DB) for leak checks; `stop` is an optional callable
    `registry.stop_all` can use to shut it down."""
    kwargs = kwargs or {}

    def _run():
        try:
            target(*args, **kwargs)
        finally:
            registry.deregister(t)

    t = threading.Thread(target=_run, name=name, daemon=daemon)
    registry.register(t, owner=owner, stop=stop)
    if start:
        t.start()
    return t
