"""Runtime lock-order tracking (the dynamic half of the lock-order checker).

The static pass (analysis/lockorder.py) only sees syntactic ``with``
nesting inside one function; real deadlocks come from cross-function,
cross-thread interleavings. This module patches ``threading.Lock`` /
``threading.RLock`` so every lock allocated *by coconut_tpu_torch code* while
tracking is enabled becomes a TrackedLock that records the global
acquisition-order graph as the process actually runs:

  - lock identity is the ALLOCATION SITE (file:line of the coconut_tpu_torch
    frame that constructed it) — every instance of ``RequestQueue`` maps
    to the same node, so orders learned from one instance apply to all;
  - holding A while acquiring B adds edge A -> B; an acquisition that
    would add B -> A when A -> B was already observed is an INVERSION —
    the two code paths can deadlock under the right interleaving — and
    is recorded with both stacks' evidence;
  - RLock re-entry and ``Condition.wait``'s release/reacquire are
    handled via per-thread depth counting and the ``_release_save`` /
    ``_acquire_restore`` / ``_is_owned`` protocol (``threading.Condition``
    picks these up from the wrapped lock automatically — patching the
    two factories covers Conditions too);
  - self-edges are ignored (re-entering the same allocation site is the
    RLock contract, not an ordering bug).

Wiring: the port's tests install the tracker from a fixture of their own
around a short service run and fail on any recorded inversion. Overhead is one dict touch per first-acquire,
zero for code outside coconut_tpu_torch (untracked locks are returned raw).
"""

import os
import sys
import threading

_ORIG_LOCK = threading.Lock
_ORIG_RLOCK = threading.RLock

ENV_KNOB = "COCONUT_LOCK_CHECK"


def _caller_site(track_all):
    """file:line of the frame that asked for the lock, or None when the
    allocation must stay untracked.

    Locks allocated by threading.py internals (Thread/Event bootstrap
    machinery) are NEVER tracked: wrapping them makes interpreter thread
    bootstrap re-enter the tracker (observed as infinite recursion via
    ``Event.set`` on a tracked Condition lock). The one exception is
    ``Condition.__init__`` allocating its default RLock — that frame is
    walked through so the lock is attributed to ``Condition()``'s caller
    and user Conditions stay covered."""
    f = sys._getframe(1)
    for _ in range(16):
        if f is None:
            return None
        fn = f.f_code.co_filename.replace(os.sep, "/")
        if fn.endswith("analysis/lockcheck.py"):
            f = f.f_back
            continue
        if fn.endswith("threading.py"):
            slf = f.f_locals.get("self")
            if (
                f.f_code.co_name == "__init__"
                and type(slf).__name__ == "Condition"
            ):
                f = f.f_back
                continue
            return None
        site = "%s:%d" % (fn, f.f_lineno)
        if track_all:
            return site
        if "/coconut_tpu_torch/" in fn and "/analysis/" not in fn:
            return site
        return None
    return None


class TrackedLock(object):
    """Proxy around a real Lock/RLock recording first-acquire order."""

    def __init__(self, inner, site, tracker):
        self._inner = inner
        self._site = site
        self._tracker = tracker
        self._depth = threading.local()

    # -- depth bookkeeping (first acquire / last release only) ----------

    def _inc(self):
        n = getattr(self._depth, "n", 0) + 1
        self._depth.n = n
        if n == 1:
            self._tracker.note_acquire(self._site)

    def _dec(self):
        n = getattr(self._depth, "n", 0) - 1
        self._depth.n = n
        if n <= 0:
            self._depth.n = 0
            self._tracker.note_release(self._site)

    # -- lock protocol --------------------------------------------------

    def acquire(self, blocking=True, timeout=-1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._inc()
        return ok

    def release(self):
        self._dec()
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # -- Condition.wait protocol ----------------------------------------

    def _release_save(self):
        n = getattr(self._depth, "n", 0)
        self._depth.n = 0
        if n > 0:
            self._tracker.note_release(self._site)
        save = getattr(self._inner, "_release_save", None)
        state = save() if save is not None else self._inner.release()
        return (state, n)

    def _acquire_restore(self, saved):
        state, n = saved
        restore = getattr(self._inner, "_acquire_restore", None)
        if restore is not None:
            restore(state)
        else:
            self._inner.acquire()
        self._depth.n = n
        if n > 0:
            self._tracker.note_acquire(self._site)

    def _is_owned(self):
        owned = getattr(self._inner, "_is_owned", None)
        if owned is not None:
            return owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __repr__(self):
        return "<TrackedLock %s of %r>" % (self._site, self._inner)


class LockOrderTracker(object):
    """Process-global acquisition-order graph + inversion log."""

    def __init__(self, track_all=False):
        self.track_all = track_all
        self.enabled = False
        self._mu = _ORIG_LOCK()  # raw: never track the tracker
        self._held = threading.local()
        self.edges = {}  # (a, b) -> {"thread", "count"}
        self.inversions = []  # {"held","acquiring","prior_edge","thread"}

    # -- recording ------------------------------------------------------

    def _stack(self):
        st = getattr(self._held, "stack", None)
        if st is None:
            st = self._held.stack = []
        return st

    def note_acquire(self, site):
        if not self.enabled:
            return
        st = self._stack()
        # get_ident() is a C-level call that cannot allocate a thread
        # object — current_thread() can (registering a _DummyThread takes
        # a threading-internal Condition), which must not re-enter here.
        tname = "tid:%d" % threading.get_ident()
        with self._mu:
            for h in st:
                if h == site:
                    continue
                if (site, h) in self.edges and (h, site) not in self.edges:
                    self.inversions.append(
                        {
                            "held": h,
                            "acquiring": site,
                            "prior_edge": "%s -> %s (seen in thread %s)"
                            % (site, h, self.edges[(site, h)]["thread"]),
                            "thread": tname,
                        }
                    )
                ev = self.edges.setdefault(
                    (h, site), {"thread": tname, "count": 0}
                )
                ev["count"] += 1
        st.append(site)

    def note_release(self, site):
        st = self._stack()
        # released out of order is legal (hand-over-hand); drop last match
        for i in range(len(st) - 1, -1, -1):
            if st[i] == site:
                del st[i]
                break

    # -- lifecycle ------------------------------------------------------

    def reset(self):
        with self._mu:
            self.edges.clear()
            self.inversions.clear()

    def drain_inversions(self):
        with self._mu:
            out = list(self.inversions)
            self.inversions.clear()
        return out

    # -- factory patching ----------------------------------------------

    def wrap_lock(self, *a, **kw):
        inner = _ORIG_LOCK(*a, **kw)
        if not self.enabled:
            return inner
        site = _caller_site(self.track_all)
        if site is None:
            return inner
        return TrackedLock(inner, site, self)

    def wrap_rlock(self, *a, **kw):
        inner = _ORIG_RLOCK(*a, **kw)
        if not self.enabled:
            return inner
        site = _caller_site(self.track_all)
        if site is None:
            return inner
        return TrackedLock(inner, site, self)


_installed = None


def install(track_all=False):
    """Patch threading.Lock/RLock; returns the (singleton) tracker.
    threading.Condition() picks the patched RLock up as its default lock
    and delegates the wait-protocol methods to the proxy."""
    global _installed
    if _installed is not None:
        _installed.enabled = True
        return _installed
    tracker = LockOrderTracker(track_all=track_all)
    tracker.enabled = True
    threading.Lock = tracker.wrap_lock
    threading.RLock = tracker.wrap_rlock
    _installed = tracker
    return tracker


def uninstall():
    global _installed
    threading.Lock = _ORIG_LOCK
    threading.RLock = _ORIG_RLOCK
    if _installed is not None:
        _installed.enabled = False
    _installed = None


def env_enabled():
    return os.environ.get(ENV_KNOB, "").strip() not in ("", "0", "false")
