"""The fleet gateway — the port's copy of `coconut_tpu/net/`: wire-format
RPC ingress, per-tenant admission, and a health-gossiping replica router.

One engine (engine/, serve/) serves one process; this package turns N
such engines into one fleet behind a front door:

  wire.py    CTS-RPC/4 — versioned length-prefixed frames, canonical
             payload encodings for all five program request/response
             pairs, the typed error envelope, the health beacon and the
             state pull / chunk. Byte for byte the JAX package's format:
             a frame either package encodes, the other decodes.
  rpc.py     Replica (an engine behind a serve loop), Socket/Loopback
             transports, and the typed GatewayClient mirroring
             ProtocolEngine's submit_* surface over the wire
  tenant.py  per-tenant API-key auth, token-bucket rate limits, and
             quota counters — enforced BEFORE engine admission
  gossip.py  HealthDirectory (UP/DEGRADED/DOWN per replica, fed by
             periodic beacons) + the GossipLoop poller
  router.py  ReplicaRouter — consistent-hash session affinity,
             least-loaded spill, beacon-driven demotion, and bounded
             failover retry on transport failure

The gateway is host code: it adds no device. A replica's engine runs on
whatever backend it was built with (TorchBackend on `cuda` unless the
caller asks for `cpu`). Every point a frame carries is decoded with its
subgroup check on the host, per frame, as the reference does.
"""

from .gossip import (
    DEGRADED,
    DOWN,
    DRAINING,
    UP,
    WARMING,
    GossipLoop,
    HealthDirectory,
)
from .rpc import (
    GatewayClient,
    LoopbackTransport,
    Replica,
    SocketTransport,
)
from .router import ReplicaRouter
from .tenant import Tenant, TenantTable, TokenBucket
from .wire import (
    MAX_FRAME_BYTES,
    MSG_STATE_CHUNK,
    MSG_STATE_PULL,
    WIRE_VERSION,
    Beacon,
    WireCodec,
    decode_frame,
    encode_frame,
)

__all__ = [
    "WIRE_VERSION",
    "MAX_FRAME_BYTES",
    "MSG_STATE_PULL",
    "MSG_STATE_CHUNK",
    "WireCodec",
    "Beacon",
    "encode_frame",
    "decode_frame",
    "Replica",
    "GatewayClient",
    "SocketTransport",
    "LoopbackTransport",
    "Tenant",
    "TenantTable",
    "TokenBucket",
    "HealthDirectory",
    "GossipLoop",
    "WARMING",
    "UP",
    "DEGRADED",
    "DRAINING",
    "DOWN",
    "ReplicaRouter",
]
