"""Straggler-hedging policy for quorum fan-out — the port's copy of
`coconut_tpu/issue/hedge.py` (Dean & Barroso, "The Tail at Scale"): when
one authority's sign dispatch outlives k x its own latency EMA, send the
batch to a SPARE authority instead of waiting — first-t-wins means the
hedge and the straggler race, the quorum takes whichever t distinct
partials land first, and the loser's late partials are discarded by the
stale guard (quorum.py).

Two decide-only objects, mirroring serve/health.py's discipline (they
DECIDE, the service ACTS; everything fake-clock testable):

  HedgePolicy — per-authority EMA of sign latency and the hedge budget
    ``clamp(k * ema, min_delay_s, max_delay_s)`` derived from it
    (`initial_delay_s` covers an authority with no EMA yet — the first
    sign may pay cold comb tables and a kernel build; don't hedge around
    it). The hedge k is deliberately SMALLER than the watchdog's: hedging
    is a latency optimization that costs one duplicate dispatch, while a
    watchdog expiry condemns the authority — so the service hedges early
    and quarantines late.

  HedgeScheduler — the outstanding (fan-out, authority) sign dispatches
    and their hedge deadlines. `begin()` at dispatch, `end()` when the
    partial lands (or the target fails — a failed target is re-covered
    immediately, not hedged on a timer), `due(now)` pops every entry past
    its deadline exactly once — a straggler is hedged at most once per
    fan-out per authority. `cancel(fid)` drops a resolved fan-out's
    remaining entries: once the quorum is minted, nobody races for it.
"""

import threading
import time


class HedgePolicy:
    """Per-authority sign-latency EMA -> hedge-fire budget."""

    def __init__(
        self,
        k=3.0,
        alpha=0.25,
        initial_delay_s=30.0,
        min_delay_s=0.01,
        max_delay_s=60.0,
    ):
        if k <= 0 or alpha <= 0 or alpha > 1:
            raise ValueError("need k > 0 and 0 < alpha <= 1")
        self.k = k
        self.alpha = alpha
        self.initial_delay_s = initial_delay_s
        self.min_delay_s = min_delay_s
        self.max_delay_s = max_delay_s
        self._lock = threading.Lock()
        self._ema = {}  # label -> EMA of successful sign durations

    def observe(self, label, dur):
        """Fold one successful sign duration into `label`'s EMA."""
        with self._lock:
            prev = self._ema.get(label)
            self._ema[label] = (
                dur if prev is None else self.alpha * dur + (1 - self.alpha) * prev
            )

    def ema(self, label):
        with self._lock:
            return self._ema.get(label)

    def budget(self, label):
        """Seconds to wait on `label`'s next sign before hedging."""
        with self._lock:
            ema = self._ema.get(label)
        if ema is None:
            return self.initial_delay_s
        return min(self.max_delay_s, max(self.min_delay_s, self.k * ema))


class HedgeScheduler:
    """Deadline tracker for outstanding (fan-out, authority) dispatches.

    All state behind one lock: authority threads begin/end while the
    health tick pops due entries. Entries are keyed (fid, label); `due()`
    POPS, so each straggler fires its hedge exactly once."""

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self._lock = threading.Lock()
        self._deadlines = {}  # (fid, label) -> (deadline, fanout)

    def begin(self, fanout, label, budget_s, now=None):
        now = self.clock() if now is None else now
        with self._lock:
            self._deadlines[(fanout.fid, label)] = (now + budget_s, fanout)

    def end(self, fid, label):
        """The partial landed (or the target failed): stop the timer."""
        with self._lock:
            self._deadlines.pop((fid, label), None)

    def cancel(self, fid):
        """Fan-out resolved: drop every remaining timer it owns."""
        with self._lock:
            gone = [key for key in self._deadlines if key[0] == fid]
            for key in gone:
                del self._deadlines[key]
            return len(gone)

    def due(self, now=None):
        """Pop and return every straggler past its hedge deadline as
        ``(fanout, label, overdue_s)``."""
        now = self.clock() if now is None else now
        out = []
        with self._lock:
            late = [k for k, v in self._deadlines.items() if now >= v[0]]
            for key in late:
                deadline, fanout = self._deadlines.pop(key)
                out.append((fanout, key[1], now - deadline))
        return out

    def outstanding(self):
        with self._lock:
            return len(self._deadlines)
