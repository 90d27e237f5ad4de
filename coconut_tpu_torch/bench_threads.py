"""Time host threads that each drive the card, with and without the
device lock.

    python3 -m coconut_tpu_torch.bench_threads [--threads 5] [--reps 2]

Each of `--threads` signing authorities runs `batch_blind_sign` on one
B = 1 request (the mint of one session), first one after another, then
all at once in threads: with `gpu/serial.DEVICE_LOCK` held by every
backend call, as the package runs, and with the lock replaced by a
no-op. Prints one JSON line a repetition with the four walls (s) and
the card's name and power limit. Needs a card."""

import argparse
import json
import threading
import time
import types

import torch

from . import bench_fp_mul as kb
from . import entry
from . import signature as sig
from .gpu import cuda_fp, serial
from .gpu.backend import TorchBackend

# What `serial.serialized` asks of DEVICE_LOCK, doing nothing.
_NO_LOCK = types.SimpleNamespace(acquire=lambda blocking=True: True, release=lambda: None)


def _wall(fn, args_list, threaded):
    t0 = time.perf_counter()
    if threaded:
        threads = [threading.Thread(target=fn, args=a) for a in args_list]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    else:
        for a in args_list:
            fn(*a)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=5)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    cuda_fp.build()
    be = TorchBackend()
    params, signers, _, epk, msgs = entry.issue_fixture(1)
    reqs = [r for r, _ in sig.batch_prepare_blind_sign(msgs, entry.ISSUANCE_HIDDEN, epk, params, be)]
    keys = [(s.sigkey,) for s in (signers * args.threads)[: args.threads]]

    def sign(sigkey):
        sig.batch_blind_sign(reqs, sigkey, params, be)

    sign(*keys[0])  # warm: tables and caches
    lock = serial.DEVICE_LOCK
    card = kb.card()
    for rep in range(args.reps):
        out = {"rep": rep, "threads": args.threads, "card": card}
        for mode in ("locked", "unlocked"):
            serial.DEVICE_LOCK = lock if mode == "locked" else _NO_LOCK
            try:
                out[mode + "_in_turn_s"] = _wall(sign, keys, threaded=False)
                out[mode + "_threads_s"] = _wall(sign, keys, threaded=True)
            finally:
                serial.DEVICE_LOCK = lock
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
