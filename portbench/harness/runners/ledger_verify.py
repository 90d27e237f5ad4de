"""A ledger of credentials from several issuers of different schemas,
verified in ledger order through the port's
`coconut_tpu_torch.stream.verify_ledger` over a `TorchBackend`: each record
routed into its issuer's batches, pipelined and prefetched as the traffic
says, the padding classes the program's own, the checkpoint in TMPDIR.

Traffic keys: segment (records a ledger segment), batch (lanes an issuer
batch), batch_s (the nominal seconds a segment, which sets the window's
number of segments), pool (credentials an issuer), forge_every,
pipeline_depth, prefetch_depth, spec_sample. The configuration's `schemas`
gives each issuer's attribute count. The window settles a whole ledger:
every issuer's tail at its end is dispatched too. The control runs the
ledger's "grouped" mode (one verdict an issuer batch, no bisection) and
gives every record its batch's verdict.
"""

import os
import shutil
import tempfile
import time

from coconut_tpu_torch.stream import verify_ledger

from .. import bulk, convert, ledger
from ..traffic import forge
from ...reference import ledger as reference


class Runner:
    def __init__(self, config, traffic, seed, device, control=False, wrap=None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.control, self.wrap = device, control, wrap
        self.mode = "grouped" if control else "per_credential"
        self.schemas = config["schemas"]

    def setup(self):
        from coconut_tpu_torch.gpu.backend import TorchBackend

        t = self.traffic
        t0 = time.perf_counter()
        self.pools = ledger.pools(self.seed, t["pool"], self.schemas)
        t1 = time.perf_counter()
        issuers = self.pools["issuers"]
        self.params = convert.params(self.pools)
        self.verkeys = {i: convert.verkey(iss) for i, iss in enumerate(issuers)}
        self.sigs = [[convert.signature(s1, s2) for s1, s2, _ in iss["creds"]] for iss in issuers]
        backend = TorchBackend(device=self.device)
        self.backend = self.wrap(backend) if self.wrap else backend
        self.tmp = tempfile.mkdtemp(prefix="portbench-ledger-")
        # one segment: each issuer's tables, and the padded tails run each
        # shape key eagerly, capture it and replay it
        self._ledger(self._plans(1, start=-1), "warm")
        t2 = time.perf_counter()
        self.parts = {"pool_s": t1 - t0, "warm_s": t2 - t1}

    def _plans(self, n, start=0):
        t = self.traffic
        return [
            ledger.segment_plan(self.seed, i, t["pool"], t["segment"], t["forge_every"], self.schemas)
            for i in range(start, start + n)
        ]

    def _records(self, plan):
        issuers = self.pools["issuers"]
        return [
            (self.sigs[i][p], forge(issuers[i]["creds"][p][2], attr), i)
            for (i, p), attr in plan
        ]

    def _ledger(self, plans, tag):
        """verify_ledger over the planned segments; {segment: [verdicts]}."""
        t = self.traffic
        out = {}
        verify_ledger(
            lambda i: self._records(plans[i]), len(plans), self.verkeys, self.params,
            self.backend, batch=t["batch"],
            state_path=os.path.join(self.tmp, "%s.json" % tag),
            on_segment=out.__setitem__, mode=self.mode,
            pipeline_depth=t["pipeline_depth"], prefetch_depth=t["prefetch_depth"],
        )
        return out

    def window(self, seconds, probe):
        t = self.traffic
        n = bulk.batches_for(seconds, t["batch_s"])
        self.plans = self._plans(n)
        probe.start()
        t0 = time.perf_counter()
        self.verdicts = self._ledger(self.plans, "window")
        window_s = time.perf_counter() - t0
        probe.stop()
        settled = sum(len(v) for v in self.verdicts.values())
        records = n * t["segment"]
        return {
            "attempted": records, "failed": records - settled, "settled": settled,
            "batches": len(self.verdicts), "window_s": window_s,
        }

    def release(self):
        import torch

        self.backend = None
        shutil.rmtree(self.tmp, ignore_errors=True)
        torch.cuda.empty_cache()

    def check(self):
        issuers = self.pools["issuers"]
        keys = {i: iss["sk"] for i, iss in enumerate(issuers)}
        verkeys = {i: iss["vk"] for i, iss in enumerate(issuers)}

        def exp_check(p, attr):
            i, k = p
            record = (i, issuers[i]["logs"][k], forge(issuers[i]["creds"][k][2], attr))
            return reference.verify_exp(record, keys)

        def spec_check(p, attr):
            i, k = p
            s1, s2, msgs = issuers[i]["creds"][k]
            return reference.verify((i, (s1, s2), forge(msgs, attr)), verkeys, self.pools["params"])

        return bulk.judge(
            self.seed, self.plans, self.verdicts, exp_check, spec_check, self.traffic["spec_sample"]
        )
