"""Online verification of PS credentials through the port's service:
`coconut_tpu_torch.serve.CredentialService` over a `TorchBackend` (one
executor), each request one credential, submitted by the benchmark's
open loop (harness/loadgen.py) at the traffic's fixed Poisson rate and
timed from when it was due.

Traffic keys: rate (requests a second), pool, forge_every, max_batch,
max_wait_ms, max_depth, mode ("per_credential"), spec_sample. The pool's
forged entries change one attribute. The control runs the service's
"grouped" mode with its bisection ladder taken out, so every request of a
rejected batch is refused.
"""

import math
import time

from .. import convert, fixtures, loadgen, traffic as gen
from ...reference import checks

#: how long past the window's close an answer is waited for
ANSWER_WAIT_S = 60.0


class Runner:
    def __init__(self, config, traffic, seed, device, control=False, wrap=None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.control, self.wrap = device, control, wrap
        self.attrs = list(range(config["attributes"]))

    def setup(self):
        from coconut_tpu_torch.gpu.backend import TorchBackend
        from coconut_tpu_torch.serve import CredentialService

        t = self.traffic
        t0 = time.perf_counter()
        self.pool = fixtures.credential_pool(self.seed, t["pool"], self.config["attributes"])
        t1 = time.perf_counter()
        self.forged = gen.pool_forgeries(self.seed, t["pool"], t["forge_every"], self.attrs)
        self.params, self.vk = convert.params(self.pool), convert.verkey(self.pool)
        self.sigs = [convert.signature(s1, s2) for s1, s2, _ in self.pool["creds"]]
        self.msgs = [gen.forge(c[2], self.forged.get(p)) for p, c in enumerate(self.pool["creds"])]
        backend = TorchBackend(device=self.device)
        backend = self.wrap(backend) if self.wrap else backend
        self.service = CredentialService(
            backend, self.vk, self.params,
            mode="grouped" if self.control else t["mode"],
            max_batch=t["max_batch"], max_wait_ms=t["max_wait_ms"], max_depth=t["max_depth"],
        )
        if self.control:
            self.service._program._bisector = None
        self.service.start()
        # the cell's one shape: a full batch of max_batch lanes
        futs = [self.service.submit(self.sigs[p], self.msgs[p]) for p in range(min(t["max_batch"], t["pool"]))]
        for f in futs:
            f.result(ANSWER_WAIT_S * 5)
        t2 = time.perf_counter()
        self.parts = {"pool_s": t1 - t0, "warm_s": t2 - t1}

    def window(self, seconds, probe):
        t = self.traffic
        due = gen.arrivals(self.seed, t["rate"], seconds)
        self.order = gen.request_order(self.seed, t["pool"], len(due))
        svc, sigs, msgs, order = self.service, self.sigs, self.msgs, self.order
        probe.start()
        t0, self.requests = loadgen.run_open_loop(lambda k: svc.submit(sigs[order[k]], msgs[order[k]]), due)
        left = loadgen.wait(self.requests, t0 + seconds + ANSWER_WAIT_S)
        t1 = max([r.done for r in self.requests if r.done is not None] + [t0])
        probe.stop()
        late_max, late_p95 = loadgen.lateness(self.requests)
        print(
            "portbench: open loop %d requests at %s/s, generator lateness max %.6f s, p95 %.6f s"
            % (len(self.requests), t["rate"], late_max, late_p95),
            flush=True,
        )
        lat = sorted(
            (r.done - r.due) if r.error is None and r.done is not None else math.inf
            for r in self.requests
        )
        p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)] if lat else math.inf
        failed = sum(1 for r in self.requests if r.error is not None or r.done is None)
        return {
            "attempted": len(self.requests), "failed": failed, "unanswered": left,
            "settled": len(self.requests) - failed, "window_s": t1 - t0,
            "latency_p95_s": p95, "latencies": lat,
        }

    def release(self):
        import torch

        self.service.drain(timeout=ANSWER_WAIT_S)
        self.service = None
        torch.cuda.empty_cache()

    def check(self):
        pool = self.pool
        wrong, unanswered, lanes, forged, memo = 0, 0, [], [], {}
        for r in self.requests:
            p = self.order[r.k]
            if r.error is not None or r.done is None:
                unanswered += 1
                continue
            if p not in memo:
                memo[p] = checks.ps_verify_exp(pool["logs"][p], self.msgs[p], pool["sk"])
            wrong += bool(r.verdict) != memo[p]
            lanes.append(r.k)
            if p in self.forged:
                forged.append(r.k)
        disagree = 0
        for k in gen.sample(self.seed, lanes, forged, self.traffic["spec_sample"]):
            p = self.order[k]
            s1, s2, _ = pool["creds"][p]
            disagree += bool(self.requests[k].verdict) != checks.ps_verify(s1, s2, self.msgs[p], pool["vk"], pool["params"])
        return {
            "wrong_verdicts": (wrong, 0),
            "spec_disagreements": (disagree, 0),
            "unanswered": (unanswered, 0),
        }
