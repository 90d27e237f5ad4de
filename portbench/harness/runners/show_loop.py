"""Bulk verification of selective-disclosure shows (PoKOfSignature::verify)
by the benchmark's own loop over `TorchBackend.batch_show_verify_async`:
it dispatches `ahead` batches beyond the one it settles, as the port's
stream pipelines verify batches, on one host thread. The benchmark's own
spans time each dispatch call (host encode and enqueue) and each settle.

Traffic keys: batch, batch_s (the nominal batch time that sets the
window's number of batches), pool, forge_every, ahead, spec_sample; the
configuration's `revealed` set is shared by every proof. A forged lane
changes one revealed attribute. The control verifies each batch with the
program's combined check (one pairing verdict a batch, per-lane Schnorr
bits) in place of the exact one.
"""

import collections
import time

from .. import bulk, convert, fixtures
from ..traffic import forge
from ...reference import checks


class Runner:
    def __init__(self, config, traffic, seed, device, control=False, wrap=None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.control, self.wrap = device, control, wrap
        self.attrs = sorted(config["revealed"])

    def setup(self):
        from coconut_tpu_torch.gpu.backend import TorchBackend

        t = self.traffic
        t0 = time.perf_counter()
        self.pool = fixtures.show_pool(self.seed, t["pool"], self.config["attributes"], self.config["revealed"])
        t1 = time.perf_counter()
        self.params, self.vk = convert.params(self.pool), convert.verkey(self.pool)
        self.proofs = [convert.show_proof(s, self.attrs)[0] for s in self.pool["shows"]]
        backend = TorchBackend(device=self.device)
        self.backend = self.wrap(backend) if self.wrap else backend
        # the cell's one shape, once
        self._loop(bulk.plans(self.seed, 1, t["pool"], t["batch"], t["forge_every"], self.attrs, start=-1))
        t2 = time.perf_counter()
        self.parts = {"pool_s": t1 - t0, "warm_s": t2 - t1}

    def _lanes(self, plan):
        shows = self.pool["shows"]
        return (
            [self.proofs[p] for p, _ in plan],
            [forge(shows[p][5], attr) for p, attr in plan],
            [shows[p][6] for p, _ in plan],
        )

    def _loop(self, plans):
        """Dispatch ahead, settle in order; {batch: [verdicts]}. The
        benchmark's own spans, "dispatch" and "settle", are kept on the
        epoch clock in self.spans."""
        be, ahead = self.backend, self.traffic["ahead"]
        lanes = [self._lanes(p) for p in plans]
        out, pending, self.spans = {}, collections.deque(), []

        def settle():
            j, f = pending.popleft()
            t0 = time.time_ns()
            out[j] = list(f())
            self.spans.append(("settle", t0, time.time_ns()))

        for i, (proofs, rms, chals) in enumerate(lanes):
            if self.control:
                bits, ok = be.batch_show_verify_combined(proofs, self.vk, self.params, rms, chals)
                out[i] = [b and ok for b in bits]
                continue
            t0 = time.time_ns()
            pending.append((i, be.batch_show_verify_async(proofs, self.vk, self.params, rms, chals)))
            self.spans.append(("dispatch", t0, time.time_ns()))
            if len(pending) > ahead:
                settle()
        while pending:
            settle()
        return out

    def window(self, seconds, probe):
        t = self.traffic
        n = bulk.batches_for(seconds, t["batch_s"])
        self.plans = bulk.plans(self.seed, n, t["pool"], t["batch"], t["forge_every"], self.attrs)
        probe.start()
        t0 = time.perf_counter()
        self.verdicts = self._loop(self.plans)
        window_s = time.perf_counter() - t0
        probe.stop()
        settled = sum(len(v) for v in self.verdicts.values())
        lanes = n * t["batch"]
        return {
            "attempted": lanes, "failed": lanes - settled, "settled": settled,
            "batches": len(self.verdicts), "window_s": window_s,
            "dispatch_s": [(e - s) / 1e9 for name, s, e in self.spans if name == "dispatch"],
            "host_spans": self.spans,
        }

    def release(self):
        import torch

        self.backend = None
        torch.cuda.empty_cache()

    def check(self):
        pool, hidden = self.pool, self.pool["hidden"]

        def show(p, attr):
            s1, s2, J, T, resp, rm, c = pool["shows"][p]
            return s1, s2, J, T, resp, forge(rm, attr), c

        def exp(p, attr):
            _, _, _, _, resp, rm, c = show(p, attr)
            return checks.show_verify_exp(pool["logs"][p], resp, rm, c, pool["sk"], hidden)

        return bulk.judge(
            self.seed, self.plans, self.verdicts, exp,
            lambda p, a: checks.show_verify(show(p, a), pool["vk"], pool["params"], hidden),
            self.traffic["spec_sample"],
        )
