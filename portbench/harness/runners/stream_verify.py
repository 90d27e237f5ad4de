"""Bulk verification of PS credentials through the port's stream:
`coconut_tpu_torch.stream.verify_stream` over a `TorchBackend`, batches
of the traffic's size, pipelined and prefetched as the traffic says, with
its checkpoint in TMPDIR.

Traffic keys: batch, batch_s (the nominal batch time that sets the
window's number of batches), pool, forge_every, pipeline_depth,
prefetch_depth, mode ("per_credential"), spec_sample. The control runs the stream's
"grouped" mode (one verdict a batch, no bisection) and gives every lane
its batch's verdict.
"""

import os
import shutil
import tempfile
import time

from .. import bulk, convert, fixtures
from ..traffic import forge
from ...reference import checks


class Runner:
    def __init__(self, config, traffic, seed, device, control=False, wrap=None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.control, self.wrap = device, control, wrap
        self.mode = "grouped" if control else traffic["mode"]
        self.attrs = list(range(config["attributes"]))

    def setup(self):
        from coconut_tpu_torch.gpu.backend import TorchBackend

        t = self.traffic
        t0 = time.perf_counter()
        self.pool = fixtures.credential_pool(self.seed, t["pool"], self.config["attributes"])
        t1 = time.perf_counter()
        self.params, self.vk = convert.params(self.pool), convert.verkey(self.pool)
        self.sigs = [convert.signature(s1, s2) for s1, s2, _ in self.pool["creds"]]
        backend = TorchBackend(device=self.device)
        self.backend = self.wrap(backend) if self.wrap else backend
        self.tmp = tempfile.mkdtemp(prefix="portbench-stream-")
        # the cell's one shape, once: it builds the verkey's tables
        warm = bulk.plans(self.seed, 1, t["pool"], t["batch"], t["forge_every"], self.attrs, start=-1)
        self._stream(warm, "warm")
        t2 = time.perf_counter()
        self.parts = {"pool_s": t1 - t0, "warm_s": t2 - t1}

    def _lanes(self, plan):
        creds = self.pool["creds"]
        return [self.sigs[p] for p, _ in plan], [forge(creds[p][2], attr) for p, attr in plan]

    def _stream(self, plans, tag):
        """verify_stream over the planned batches; {batch: [verdicts]}."""
        from coconut_tpu_torch.stream import verify_stream

        t = self.traffic
        lanes = [self._lanes(p) for p in plans]
        out = {}

        def on_batch(i, result):
            out[i] = [bool(result)] * len(plans[i]) if self.mode != "per_credential" else list(result)

        verify_stream(
            lambda i: lanes[i], len(plans), self.vk, self.params, self.backend,
            state_path=os.path.join(self.tmp, "%s.json" % tag), on_batch=on_batch,
            mode=self.mode, pipeline_depth=t["pipeline_depth"],
            prefetch_depth=t["prefetch_depth"],
        )
        return out

    def window(self, seconds, probe):
        t = self.traffic
        n = bulk.batches_for(seconds, t["batch_s"])
        self.plans = bulk.plans(self.seed, n, t["pool"], t["batch"], t["forge_every"], self.attrs)
        probe.start()
        t0 = time.perf_counter()
        self.verdicts = self._stream(self.plans, "window")
        window_s = time.perf_counter() - t0
        probe.stop()
        settled = sum(len(v) for v in self.verdicts.values())
        lanes = n * t["batch"]
        return {
            "attempted": lanes, "failed": lanes - settled, "settled": settled,
            "batches": len(self.verdicts), "window_s": window_s,
        }

    def release(self):
        import torch

        self.backend = None
        shutil.rmtree(self.tmp, ignore_errors=True)
        torch.cuda.empty_cache()

    def check(self):
        pool, creds = self.pool, self.pool["creds"]
        return bulk.judge(
            self.seed, self.plans, self.verdicts,
            lambda p, a: checks.ps_verify_exp(pool["logs"][p], forge(creds[p][2], a), pool["sk"]),
            lambda p, a: checks.ps_verify(creds[p][0], creds[p][1], forge(creds[p][2], a), pool["vk"], pool["params"]),
            self.traffic["spec_sample"],
        )
