"""coconut_tpu_torch — the PyTorch/CUDA port of coconut_tpu.

The JAX package (`coconut_tpu/`) is the reference; this package mirrors its
layout and names and imports nothing from it:

  ops/     host copies of the spec: fields (to Fp12), curve ops and MSM,
           pairing, hashing to Fr, wire encoders (Python ints)
  gpu/     the device layer, module for module after coconut_tpu/tpu/:
           limbs, fp (+ cuda_fp: the CUDA Montgomery kernel and its plain
           PyTorch version), tower, curve, pairing, glv, backend
           (TorchBackend)
  csrc/    CUDA C++ sources, built with nvcc into build/ at first use
  params.py, entry.py, convert.py
           group contexts and data holders, the verify and show-verify
           fixtures and the entry point, and the bridge that carries
           JAX-encoded operands across for differential tests
  ps.py, pok_sig.py, pok_vc.py, signature.py, sss.py, batchverify.py,
  errors.py
           the protocol layer: the spec verifiers, the show prover (spec
           and batched), the issuance protocol and its request proof,
           Fiat-Shamir, the batch checks and ladders, their combiners, and
           the errors they raise
  backend.py
           the host spec backend (the services' fallback and bisection
           oracle) and the backend registry ("torch", "spec")
  keylife/ the dealerless key lifecycle: online DKG, proactive refresh and
           t/n reshare rounds, the epoch registry and the manager that
           rolls new key sets into live services (host spec)
  serve/, engine/, issue/, stream.py, retry.py, faults.py, metrics.py,
  obs/, state/
           the host layers: the online verify service CredentialService
           on its execution engine, the ProtocolEngine serving all five
           phases (prepare, mint, verify, show-prove, show-verify) on one
           pool with epoch-keyed verkeys, the threshold-issuance service
           IssuanceService (quorum fan-out over signing authorities,
           hedging, verify-before-release), load generation with the mixed
           verify + issue workload (serve/loadgen.py), the checkpointed
           verify_stream, the retry / fault / dead-letter supervision,
           metrics and tracing; serve/loadgen.py also drives full
           credential sessions (run_session_loadgen), directly or over
           the wire (transport="rpc")
  net/     the fleet gateway: the CTS-RPC/4 wire (byte for byte the JAX
           package's), Replica / GatewayClient over a socket or a
           loopback, tenant admission, health gossip and the
           session-affine ReplicaRouter (host code)

Entry points run on `cuda` unless the caller passes device="cpu".
"""
