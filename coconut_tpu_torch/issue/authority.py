"""SigningAuthority: one threshold key share's signing executor — the
port's copy of `coconut_tpu/issue/authority.py`.

Each authority owns exactly one Shamir share (a keygen.Signer: 1-based
id, Sigkey share, per-signer Verkey) and runs `batch_blind_sign` over
coalesced request batches on ITS backend/device — the issuance analog of
the engine's Executor, with the same worker discipline:

  - an inbox of fan-outs (quorum.Fanout) the service dispatched here,
    bounded by `can_accept()` (2 queued fan-outs: one signing + one
    waiting) so backlog stays in the bounded request queue;
  - DEVICE PINNING through the verify pool's seam
    (stream._pin_to_device, which enters `torch.cuda.device`): tensors
    created inside the sign dispatch land on this authority's card, and
    the backend's caches are keyed by the card;
  - GENERATIONS + `abandon()` for hang containment: the watchdog bumps
    the generation of a wedged worker, whose eventual return is discarded
    by the quorum tracker's stale guard; `start()` respawns a fresh
    worker for the probation probe;
  - loop-level crash containment: a BaseException escaping the per-batch
    handling (faults.InjectedCrash models it) lands in
    `service._authority_failed`, which quarantines ONLY this authority
    and re-covers its in-flight fan-outs from spares.

The sign dispatch goes THROUGH the backend object when it exposes
`batch_blind_sign` (faults.FaultyBackend always does — that is the chaos
seam; stub backends in tests too), else through the library entry point
`signature.batch_blind_sign` with this backend's MSM primitives.
`backend=None` is a TorchBackend on `cuda` (raises without a card).
"""

import threading
from collections import deque

from .. import metrics
from ..errors import GeneralError
from ..signature import batch_blind_sign as _batch_blind_sign
from ..stream import _pin_to_device


class SigningAuthority:
    """One key share's signing loop. `service` is the owning
    IssuanceService; `signer` a keygen.Signer; `backend` an instance or
    registry name (each authority may carry its own — chaos tests wrap
    one authority's backend without touching the others; None is a
    TorchBackend on `cuda`); `device` an optional `torch.device` to pin
    sign dispatches to."""

    def __init__(self, service, signer, backend=None, device=None, label=None):
        from ..backend import get_backend

        if backend is None or isinstance(backend, str):
            backend = get_backend(backend or "torch")
        self.service = service
        self.signer = signer
        self.id = signer.id
        self.sigkey = signer.sigkey
        self.verkey = signer.verkey
        self.backend = backend
        self.device = device
        self.label = str(signer.id) if label is None else label
        self.busy_timer = "issue_auth%s_busy_s" % self.label
        self._cond = threading.Condition()
        self._inbox = deque()
        self._closed = False
        self._gen = 0
        self._thread = None
        #: keylife share store: (epoch, gen) -> (Sigkey, Verkey). The
        #: boot `signer` share stays the keyset-less default, so the
        #: historical surface is untouched when no lifecycle runs.
        self._keys = {}

    # -- key lifecycle -------------------------------------------------------

    def install_keys(self, key, sigkey, verkey):
        """Install this authority's share for one KeySet — (epoch, gen)
        keyed, so a refresh's new shares and a reshare's new epoch both
        land without disturbing fan-outs pinned to older sets."""
        self._keys[key] = (sigkey, verkey)

    def _share_for(self, keyset):
        if keyset is None:
            return self.sigkey
        entry = self._keys.get(keyset.key)
        if entry is None:
            # surfaces as a sign FAULT: the service marks this target
            # failed and re-covers the fan-out from spares
            raise GeneralError(
                "authority %s has no key material for epoch %d gen %d"
                % (self.label, keyset.epoch, keyset.gen)
            )
        return entry[0]

    # -- sign dispatch -------------------------------------------------------

    def sign(self, sig_requests, params, keyset=None):
        """Blind-sign one coalesced batch under this share (the boot
        share, or `keyset`'s installed share), pinned to this authority's
        device when it has one."""
        sigkey = self._share_for(keyset)
        return _pin_to_device(self._sign_inner, self.device)(
            sig_requests, params, sigkey
        )

    def _sign_inner(self, sig_requests, params, sigkey):
        fn = getattr(self.backend, "batch_blind_sign", None)
        if fn is not None:
            return fn(sig_requests, sigkey, params)
        return _batch_blind_sign(
            sig_requests, sigkey, params, backend=self.backend
        )

    # -- dispatcher side -----------------------------------------------------

    def queued(self):
        with self._cond:
            return len(self._inbox)

    def can_accept(self):
        with self._cond:
            return len(self._inbox) < 2

    def submit(self, fanout):
        with self._cond:
            self._inbox.append(fanout)
            self._cond.notify_all()
        metrics.count("issue_auth%s_dispatches" % self.label)

    def cancel(self, fid):
        """First-t-wins: drop a resolved fan-out from the inbox (a sign
        not yet started never runs; one mid-dispatch finishes and its
        partials hit the stale guard instead). Returns how many queued
        entries were dropped."""
        with self._cond:
            kept = [f for f in self._inbox if f.fid != fid]
            dropped = len(self._inbox) - len(kept)
            if dropped:
                self._inbox.clear()
                self._inbox.extend(kept)
        return dropped

    def sweep_inbox(self):
        """Soft quarantine: pull every QUEUED (not yet signing) fan-out
        back out — the worker stays alive to finish what it's mid-sign
        on, but its backlog's quorum coverage moves to spares."""
        with self._cond:
            swept = list(self._inbox)
            self._inbox.clear()
            self._cond.notify_all()
        return swept

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        """Spawn the worker — no-op while one runs or after close(). Also
        the probation revival path after abandon()."""
        with self._cond:
            if self._closed or self._thread is not None:
                return
            gen = self._gen
            self._thread = threading.Thread(
                target=self._run,
                args=(gen,),
                name="coconut-issue-auth%s.g%d" % (self.label, gen),
                daemon=True,
            )
            thread = self._thread
        thread.start()

    def close(self):
        """Stop accepting; the loop still signs its inbox, then exits."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def join(self, timeout=None):
        """Wait for the current worker. The thread is read once, under the
        lock: abandon() may clear it while we wait (a watchdog expiry
        during a drain, or a park), and a worker abandoned meanwhile is
        done as far as the caller is concerned — its work was handed on.
        (The reference reads `_thread` again after the wait, which raises
        AttributeError when abandon() ran in between.)"""
        with self._cond:
            thread = self._thread
        if thread is None:
            return True
        thread.join(timeout)
        with self._cond:
            abandoned = self._thread is not thread
        return abandoned or not thread.is_alive()

    def has_worker(self):
        with self._cond:
            return self._thread is not None and self._thread.is_alive()

    def is_current(self, gen):
        with self._cond:
            return gen == self._gen

    def abandon(self):
        """Hang/crash containment: bump the generation (the stuck worker
        becomes stale — its eventual partials are discarded by the quorum
        stale guard) and sweep the inbox. Returns the swept fan-outs; the
        caller owns re-covering them. start() can respawn."""
        with self._cond:
            self._gen += 1
            self._thread = None
            swept = list(self._inbox)
            self._inbox.clear()
            self._cond.notify_all()
        return swept

    # -- worker loop ---------------------------------------------------------

    def _next(self, gen):
        with self._cond:
            while True:
                if self._gen != gen:
                    return None  # abandoned: this worker is stale — exit
                if self._inbox:
                    return self._inbox.popleft()
                if self._closed:
                    return None
                self._cond.wait()

    def _run(self, gen):
        svc = self.service
        current = None
        try:
            while True:
                current = self._next(gen)
                if current is None:
                    return
                svc._sign_fanout(self, current, gen)
                current = None
        except BaseException as e:  # loop-level crash (a code bug in the
            # sign path — faults.InjectedCrash models it): hand the
            # in-flight fan-out plus the swept inbox to the service for
            # quarantine + re-coverage from spare authorities
            svc._authority_failed(self, e, current, gen)
