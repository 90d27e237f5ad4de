"""Versioned wire format for the fleet gateway (CTS-RPC/4) — the port's
copy of `coconut_tpu/net/wire.py`, byte for byte the same format.

Length-prefixed binary frames over a byte stream (loopback sockets in CI,
TCP in deployment). One frame:

    offset  size  field
    0       2     magic    0xC0C7 (big-endian) — stream resync guard
    2       1     version  WIRE_VERSION (decode REJECTS unknown versions)
    3       1     msg_type (request / response / error / beacon, below)
    4       4     seq      u32 request-correlation id (echoed by the
                           response/error frame; beacon sequence number)
    8       4     length   u32 payload byte count (bounded by
                           MAX_FRAME_BYTES — a corrupt length can never
                           make a reader allocate gigabytes)
    12      len   payload

Message types — one request/response pair per engine program, plus the
typed error envelope and the health beacon:

    request   response  program
    0x01      0x41      verify
    0x02      0x42      prepare
    0x03      0x43      mint
    0x04      0x44      show_prove
    0x05      0x45      show_verify
    0x20      0x60      (beacon poll -> health beacon)
    -         0x7F      error envelope (code / program / retry_after_s /
                        retryable / message — errors.WIRE_ERROR_CODES is
                        the 1:1 code <-> class map)

Payload encodings reuse the library's canonical CTS-v1 serializers
(Signature / SignatureRequest / PoKOfSignatureProof .to_bytes, Fr as
32-byte big-endian) via a `WireCodec` bound to the deployment's Params —
byte-for-byte deterministic, so the golden vectors pinned for the JAX
package come out of this one unchanged. Every decode is STRICT:
truncated frames, trailing bytes, bad magic, unknown versions,
non-canonical field encodings and points outside the subgroup all raise
DeserializationError (mapped to a non-retryable "bad_request" envelope
by the server) rather than producing a half-parsed request.
"""

import json
import struct

from ..errors import DeserializationError, error_from_wire
from ..keylife.epoch import EPOCH_STATE_CODES, EPOCH_STATE_OF_CODE
from ..ops import serialize as ser
from ..serve.queue import LANES

#: bump when the frame layout or any payload encoding changes; decoders
#: reject every version they were not built for (explicit skew failure
#: beats silent misparsing).
#: v2: mint epochs on the wire — verify/show_prove/show_verify
#: requests and the mint response carry a u32 epoch (0 = unpinned, the
#: pre-lifecycle boot verkey), and beacons advertise the replica's live
#: epoch window.
#: v3: the durable state plane — beacons additionally piggyback
#: the replica's per-keyspace state high-water marks (the anti-entropy
#: trigger), and MSG_STATE_PULL/MSG_STATE_CHUNK page replicated state
#: records between replicas.
#: v4: scenario nullifier scoping — the show_verify request
#: carries an application domain string ("" = unscoped) and an optional
#: 32-byte deterministic spend tag (petition campaigns, e-cash; see
#: state/nullifier.py).
WIRE_VERSION = 4

MAGIC = 0xC0C7

#: payload size cap — a corrupted/hostile length field fails loudly here
MAX_FRAME_BYTES = 1 << 24

HEADER = struct.Struct(">HBBII")
HEADER_BYTES = HEADER.size  # 12

_F64 = struct.Struct(">d")

# -- message types -----------------------------------------------------------

REQUEST_TYPES = {
    "verify": 0x01,
    "prepare": 0x02,
    "mint": 0x03,
    "show_prove": 0x04,
    "show_verify": 0x05,
}
RESPONSE_TYPES = {name: t | 0x40 for name, t in REQUEST_TYPES.items()}
PROGRAM_OF_REQUEST = {t: name for name, t in REQUEST_TYPES.items()}
PROGRAM_OF_RESPONSE = {t: name for name, t in RESPONSE_TYPES.items()}

MSG_BEACON_POLL = 0x20
MSG_BEACON = 0x60
#: anti-entropy state pull: request one page of replicated
#: state records from a peer's per-origin log
MSG_STATE_PULL = 0x21
MSG_STATE_CHUNK = 0x61
MSG_ERROR = 0x7F

#: request-header lane codes (serve.queue.LANES order)
_LANE_CODE = {lane: i for i, lane in enumerate(LANES)}
_LANE_OF_CODE = {i: lane for lane, i in _LANE_CODE.items()}


# -- framing -----------------------------------------------------------------


def encode_frame(msg_type, payload, seq=0, version=WIRE_VERSION):
    """One wire frame: 12-byte header + payload."""
    if len(payload) > MAX_FRAME_BYTES:
        raise ValueError(
            "frame payload %d bytes exceeds MAX_FRAME_BYTES" % len(payload)
        )
    return HEADER.pack(MAGIC, version, msg_type, seq, len(payload)) + payload


def parse_header(header):
    """(msg_type, seq, payload_length) from the 12 header bytes. Raises
    DeserializationError on truncation, bad magic, an unknown version, or
    an over-cap length — the stream-reader's validation seam."""
    if len(header) < HEADER_BYTES:
        raise DeserializationError(
            "truncated frame header: %d of %d bytes"
            % (len(header), HEADER_BYTES)
        )
    magic, version, msg_type, seq, length = HEADER.unpack(
        header[:HEADER_BYTES]
    )
    if magic != MAGIC:
        raise DeserializationError(
            "bad frame magic 0x%04X (want 0x%04X)" % (magic, MAGIC)
        )
    if version != WIRE_VERSION:
        raise DeserializationError(
            "unsupported wire version %d (this build speaks %d)"
            % (version, WIRE_VERSION)
        )
    if length > MAX_FRAME_BYTES:
        raise DeserializationError(
            "frame payload length %d exceeds cap %d"
            % (length, MAX_FRAME_BYTES)
        )
    return msg_type, seq, length


def decode_frame(buf):
    """(msg_type, seq, payload) from ONE complete frame; rejects trailing
    bytes (stream readers use parse_header + exact reads instead)."""
    msg_type, seq, length = parse_header(buf)
    if len(buf) != HEADER_BYTES + length:
        raise DeserializationError(
            "frame length mismatch: header says %d payload bytes, got %d"
            % (length, len(buf) - HEADER_BYTES)
        )
    return msg_type, seq, bytes(buf[HEADER_BYTES:])


# -- primitive fields --------------------------------------------------------


def _pack_str(s):
    b = s.encode("utf-8")
    if len(b) > 0xFFFF:
        raise ValueError("string field too long (%d bytes)" % len(b))
    return len(b).to_bytes(2, "big") + b


def _read_str(b, o):
    if len(b) < o + 2:
        raise DeserializationError("truncated string field")
    n = int.from_bytes(b[o : o + 2], "big")
    o += 2
    if len(b) < o + n:
        raise DeserializationError("truncated string field")
    try:
        return b[o : o + n].decode("utf-8"), o + n
    except UnicodeDecodeError:
        raise DeserializationError("non-UTF8 string field")


def _pack_blob(x):
    if len(x) > MAX_FRAME_BYTES:
        raise ValueError("blob field too long (%d bytes)" % len(x))
    return len(x).to_bytes(4, "big") + x


def _read_blob(b, o):
    if len(b) < o + 4:
        raise DeserializationError("truncated blob field")
    n = int.from_bytes(b[o : o + 4], "big")
    o += 4
    if n > MAX_FRAME_BYTES or len(b) < o + n:
        raise DeserializationError("truncated blob field")
    return bytes(b[o : o + n]), o + n


def _read_exact(b, o, n, what):
    if len(b) < o + n:
        raise DeserializationError("truncated %s" % what)
    return bytes(b[o : o + n]), o + n


def _pack_frs(msgs):
    if len(msgs) > 0xFFFF:
        raise ValueError("message vector too long (%d)" % len(msgs))
    return len(msgs).to_bytes(2, "big") + b"".join(
        ser.fr_to_bytes(m) for m in msgs
    )


def _read_frs(b, o):
    if len(b) < o + 2:
        raise DeserializationError("truncated Fr vector")
    n = int.from_bytes(b[o : o + 2], "big")
    o += 2
    out = []
    for _ in range(n):
        raw, o = _read_exact(b, o, 32, "Fr vector")
        out.append(ser.fr_from_bytes(raw))
    return out, o


def _pack_revealed(revealed):
    """Canonical {index: Fr} map: u16 count + sorted (u32 idx, 32B Fr)."""
    if len(revealed) > 0xFFFF:
        raise ValueError("revealed map too long (%d)" % len(revealed))
    out = [len(revealed).to_bytes(2, "big")]
    for idx in sorted(revealed):
        out.append(int(idx).to_bytes(4, "big"))
        out.append(ser.fr_to_bytes(revealed[idx]))
    return b"".join(out)


def _read_revealed(b, o):
    if len(b) < o + 2:
        raise DeserializationError("truncated revealed map")
    n = int.from_bytes(b[o : o + 2], "big")
    o += 2
    out = {}
    for _ in range(n):
        raw_i, o = _read_exact(b, o, 4, "revealed map")
        raw_m, o = _read_exact(b, o, 32, "revealed map")
        idx = int.from_bytes(raw_i, "big")
        if idx in out:
            raise DeserializationError("duplicate revealed index %d" % idx)
        out[idx] = ser.fr_from_bytes(raw_m)
    return out, o


def _pack_epoch(epoch):
    """u32 mint epoch; 0 encodes "unpinned" (None — the boot verkey of a
    deployment that never ran a key lifecycle). Real epochs are >= 1
    (EpochRegistry ids are monotonic from 1)."""
    e = 0 if epoch is None else int(epoch)
    if not 0 <= e <= 0xFFFFFFFF:
        raise ValueError("epoch %r out of u32 range" % (epoch,))
    return e.to_bytes(4, "big")


def _read_epoch(b, o):
    raw, o = _read_exact(b, o, 4, "epoch")
    e = int.from_bytes(raw, "big")
    return (e if e else None), o


def _done(b, o, what):
    if o != len(b):
        raise DeserializationError(
            "trailing bytes in %s (%d extra)" % (what, len(b) - o)
        )


# -- error envelope (program-agnostic, no params needed) ---------------------


def encode_error(exc, program=None):
    """Error-envelope payload for any exception: its stable `code`
    (errors.py; "general" for classes without one), the refusing program,
    the retry-after hint, a retryable flag, and the human message."""
    code = getattr(exc, "code", "general")
    prog = getattr(exc, "program", None) or program
    retry_after = getattr(exc, "retry_after_s", None)
    retryable = retry_after is not None or code == "transient"
    return b"".join(
        (
            _pack_str(code),
            _pack_str(prog or ""),
            _F64.pack(float(retry_after or 0.0)),
            bytes([1 if retryable else 0]),
            _pack_str(str(exc)),
        )
    )


def decode_error(payload):
    """Rebuild the typed exception an error envelope describes (via
    errors.error_from_wire; unknown codes degrade to GeneralError)."""
    code, o = _read_str(payload, 0)
    prog, o = _read_str(payload, o)
    raw, o = _read_exact(payload, o, 8, "error envelope")
    (retry_after,) = _F64.unpack(raw)
    flag, o = _read_exact(payload, o, 1, "error envelope")
    message, o = _read_str(payload, o)
    _done(payload, o, "error envelope")
    err = error_from_wire(
        code, message, program=prog or None, retry_after_s=retry_after
    )
    err.wire_retryable = bool(flag[0])
    return err


# -- health beacon -----------------------------------------------------------


class Beacon:
    """One replica's periodic health self-report: the engine health-ladder
    summary (admissible executors / capacity fraction), queue depth,
    brownout flag the router's gossip directory routes by, and — since
    wire v2 — the live key-epoch window (sorted (epoch_id, state) pairs
    from keylife.EpochRegistry.live_epochs()) so routers know which mint
    epochs each replica can still serve, and — since wire v3 — the
    durable state plane's per-keyspace high-water marks
    ((keyspace, origin, seq) triples from StateStore.marks()) that
    trigger anti-entropy pulls for any replica lagging them."""

    __slots__ = (
        "replica_id",
        "state",
        "capacity_fraction",
        "queue_depth",
        "brownout",
        "healthy_executors",
        "executors",
        "t",
        "epochs",
        "state_marks",
    )

    def __init__(
        self,
        replica_id,
        state,
        capacity_fraction,
        queue_depth,
        brownout,
        healthy_executors,
        executors,
        t,
        epochs=(),
        state_marks=(),
    ):
        self.replica_id = replica_id
        self.state = state
        self.capacity_fraction = capacity_fraction
        self.queue_depth = queue_depth
        self.brownout = brownout
        self.healthy_executors = healthy_executors
        self.executors = executors
        self.t = t
        self.epochs = tuple(epochs)
        self.state_marks = tuple(state_marks)

    def admissible(self):
        """May the router route NEW sessions here? Mirrors the engine's
        executor-admission rule one level up: a replica reporting zero
        admissible executors is demoted exactly like a quarantined
        executor. Lifecycle states are equally inadmissible: a
        "warming" replica is still replaying its shape manifest and a
        "draining" one is mid-graceful-shutdown — both refuse or stall
        new work."""
        return self.state not in ("quarantined", "down", "warming", "draining")

    def as_dict(self):
        return {k: getattr(self, k) for k in self.__slots__}


def _pack_epoch_window(epochs):
    """u16 count + per-entry (u32 epoch, u8 state code); canonical order
    is ascending epoch id (live_epochs() already sorts)."""
    entries = list(epochs)
    if len(entries) > 0xFFFF:
        raise ValueError("epoch window too long (%d)" % len(entries))
    out = [len(entries).to_bytes(2, "big")]
    for epoch, state in entries:
        code = EPOCH_STATE_CODES.get(state)
        if code is None:
            raise ValueError("unknown epoch state %r" % (state,))
        out.append(int(epoch).to_bytes(4, "big"))
        out.append(bytes([code]))
    return b"".join(out)


def _read_epoch_window(b, o):
    if len(b) < o + 2:
        raise DeserializationError("truncated epoch window")
    n = int.from_bytes(b[o : o + 2], "big")
    o += 2
    out = []
    for _ in range(n):
        raw_e, o = _read_exact(b, o, 4, "epoch window")
        raw_s, o = _read_exact(b, o, 1, "epoch window")
        state = EPOCH_STATE_OF_CODE.get(raw_s[0])
        if state is None:
            raise DeserializationError(
                "unknown epoch state code %d" % raw_s[0]
            )
        out.append((int.from_bytes(raw_e, "big"), state))
    return tuple(out), o


def _pack_state_marks(marks):
    """u16 count + per-entry (str keyspace, str origin, u32 seq);
    canonical order is the store's (sorted by keyspace then origin)."""
    entries = list(marks)
    if len(entries) > 0xFFFF:
        raise ValueError("state-mark set too long (%d)" % len(entries))
    out = [len(entries).to_bytes(2, "big")]
    for ks, origin, seq in entries:
        out.append(_pack_str(ks))
        out.append(_pack_str(origin))
        out.append(int(seq).to_bytes(4, "big"))
    return b"".join(out)


def _read_state_marks(b, o):
    if len(b) < o + 2:
        raise DeserializationError("truncated state marks")
    n = int.from_bytes(b[o : o + 2], "big")
    o += 2
    out = []
    for _ in range(n):
        ks, o = _read_str(b, o)
        origin, o = _read_str(b, o)
        raw, o = _read_exact(b, o, 4, "state marks")
        out.append((ks, origin, int.from_bytes(raw, "big")))
    return tuple(out), o


def encode_beacon(beacon):
    return b"".join(
        (
            _pack_str(beacon.replica_id),
            _pack_str(beacon.state),
            _F64.pack(float(beacon.capacity_fraction)),
            int(beacon.queue_depth).to_bytes(4, "big"),
            bytes([1 if beacon.brownout else 0]),
            int(beacon.healthy_executors).to_bytes(4, "big"),
            int(beacon.executors).to_bytes(4, "big"),
            _F64.pack(float(beacon.t)),
            _pack_epoch_window(getattr(beacon, "epochs", ()) or ()),
            _pack_state_marks(
                getattr(beacon, "state_marks", ()) or ()
            ),
        )
    )


def decode_beacon(payload):
    replica_id, o = _read_str(payload, 0)
    state, o = _read_str(payload, o)
    raw, o = _read_exact(payload, o, 8, "beacon")
    (capacity,) = _F64.unpack(raw)
    raw, o = _read_exact(payload, o, 4, "beacon")
    depth = int.from_bytes(raw, "big")
    raw, o = _read_exact(payload, o, 1, "beacon")
    brownout = bool(raw[0])
    raw, o = _read_exact(payload, o, 4, "beacon")
    healthy = int.from_bytes(raw, "big")
    raw, o = _read_exact(payload, o, 4, "beacon")
    executors = int.from_bytes(raw, "big")
    raw, o = _read_exact(payload, o, 8, "beacon")
    (t,) = _F64.unpack(raw)
    epochs, o = _read_epoch_window(payload, o)
    state_marks, o = _read_state_marks(payload, o)
    _done(payload, o, "beacon")
    return Beacon(
        replica_id, state, capacity, depth, brownout, healthy, executors, t,
        epochs=epochs, state_marks=state_marks,
    )


# -- anti-entropy state transfer -------------------------------------
#
# MSG_STATE_PULL asks a peer for one page of its per-origin state log
# (state/store.py records_after); MSG_STATE_CHUNK answers with the raw
# record dicts. Values travel as JSON blobs: the state plane treats
# them as opaque (LWW metadata — keyspace/origin/seq/epoch — is what
# the wire frames natively), so new keyspaces need no wire bump.


def encode_state_pull(keyspace, origin, after_seq, limit):
    return b"".join(
        (
            _pack_str(keyspace),
            _pack_str(origin),
            int(after_seq).to_bytes(4, "big"),
            int(limit).to_bytes(2, "big"),
        )
    )


def decode_state_pull(payload):
    keyspace, o = _read_str(payload, 0)
    origin, o = _read_str(payload, o)
    raw, o = _read_exact(payload, o, 4, "state pull")
    after_seq = int.from_bytes(raw, "big")
    raw, o = _read_exact(payload, o, 2, "state pull")
    limit = int.from_bytes(raw, "big")
    _done(payload, o, "state pull")
    return keyspace, origin, after_seq, limit


def encode_state_chunk(records):
    """u16 count + per-record (str ks, str key, blob json-value,
    str origin, u32 seq, u32 epoch (0 = None), u8 tombstone)."""
    records = list(records)
    if len(records) > 0xFFFF:
        raise ValueError("state chunk too long (%d)" % len(records))
    out = [len(records).to_bytes(2, "big")]
    for rec in records:
        out.append(_pack_str(rec["ks"]))
        out.append(_pack_str(rec["k"]))
        out.append(
            _pack_blob(json.dumps(rec["v"], sort_keys=True).encode())
        )
        out.append(_pack_str(rec["o"]))
        out.append(int(rec["s"]).to_bytes(4, "big"))
        out.append(_pack_epoch(rec["e"]))
        out.append(bytes([1 if rec["t"] else 0]))
    return b"".join(out)


def decode_state_chunk(payload):
    if len(payload) < 2:
        raise DeserializationError("truncated state chunk")
    n = int.from_bytes(payload[:2], "big")
    o = 2
    out = []
    for _ in range(n):
        ks, o = _read_str(payload, o)
        key, o = _read_str(payload, o)
        blob, o = _read_blob(payload, o)
        origin, o = _read_str(payload, o)
        raw, o = _read_exact(payload, o, 4, "state chunk")
        seq = int.from_bytes(raw, "big")
        epoch, o = _read_epoch(payload, o)
        raw, o = _read_exact(payload, o, 1, "state chunk")
        try:
            value = json.loads(blob.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            raise DeserializationError("malformed state-record value")
        out.append(
            {
                "ks": ks,
                "k": key,
                "v": value,
                "o": origin,
                "s": seq,
                "e": epoch,
                "t": int(raw[0] != 0),
            }
        )
    _done(payload, o, "state chunk")
    return out


# -- program request/response codec ------------------------------------------


class WireCodec:
    """Encode/decode the five program request+response payloads against
    ONE deployment's Params (the group context fixes every point size, so
    each encoding is canonical and byte-exact)."""

    def __init__(self, params):
        self.params = params
        self.ctx = params.ctx

    # request payload: u8 lane | str api_key | str session | program body
    def encode_request(
        self, program, args, lane="interactive", api_key="", session=""
    ):
        if lane not in _LANE_CODE:
            raise ValueError("unknown lane %r" % (lane,))
        body = getattr(self, "_enc_req_%s" % program)(*args)
        return b"".join(
            (
                bytes([_LANE_CODE[lane]]),
                _pack_str(api_key),
                _pack_str(session),
                body,
            )
        )

    def decode_request(self, msg_type, payload):
        """(program, lane, api_key, session, args) — `args` is the exact
        positional tuple the engine's submit_<program> takes."""
        program = PROGRAM_OF_REQUEST.get(msg_type)
        if program is None:
            raise DeserializationError(
                "unknown request type 0x%02X" % msg_type
            )
        raw, o = _read_exact(payload, 0, 1, "request header")
        lane = _LANE_OF_CODE.get(raw[0])
        if lane is None:
            raise DeserializationError("unknown lane code %d" % raw[0])
        api_key, o = _read_str(payload, o)
        session, o = _read_str(payload, o)
        args, o = getattr(self, "_dec_req_%s" % program)(payload, o)
        _done(payload, o, "%s request" % program)
        return program, lane, api_key, session, args

    def encode_response(self, program, result):
        return getattr(self, "_enc_resp_%s" % program)(result)

    def decode_response(self, program, payload):
        result, o = getattr(self, "_dec_resp_%s" % program)(payload, 0)
        _done(payload, o, "%s response" % program)
        return result

    # -- verify: (sig, messages) -> bool ------------------------------------

    def _enc_req_verify(self, sig, messages):
        # trailing u32: the credential's mint epoch (0 = unpinned) — the
        # replica resolves its verkey from the keychain by this id
        return (
            sig.to_bytes(self.ctx)
            + _pack_frs(messages)
            + _pack_epoch(getattr(sig, "epoch", None))
        )

    def _dec_req_verify(self, b, o):
        from ..signature import Signature

        raw, o = _read_exact(b, o, 2 * self.ctx.sig_nbytes, "Signature")
        sig = Signature.from_bytes(raw, self.ctx)
        msgs, o = _read_frs(b, o)
        epoch, o = _read_epoch(b, o)
        if epoch is not None:
            sig.epoch = epoch
        return (sig, msgs), o

    def _enc_resp_verify(self, verdict):
        return bytes([1 if verdict else 0])

    def _dec_resp_verify(self, b, o):
        raw, o = _read_exact(b, o, 1, "verify response")
        return bool(raw[0]), o

    # -- prepare: (messages, elgamal_pk) -> (SignatureRequest, randomness) --

    def _enc_req_prepare(self, messages, elgamal_pk):
        return _pack_frs(messages) + self.ctx.sig_to_bytes(elgamal_pk)

    def _dec_req_prepare(self, b, o):
        msgs, o = _read_frs(b, o)
        raw, o = _read_exact(b, o, self.ctx.sig_nbytes, "ElGamal pk")
        return (msgs, self.ctx.sig_from_bytes(raw)), o

    def _enc_resp_prepare(self, result):
        sig_req, randomness = result
        return _pack_blob(sig_req.to_bytes(self.ctx)) + _pack_frs(randomness)

    def _dec_resp_prepare(self, b, o):
        from ..signature import SignatureRequest

        raw, o = _read_blob(b, o)
        sig_req = SignatureRequest.from_bytes(raw, self.ctx)
        randomness, o = _read_frs(b, o)
        return (sig_req, randomness), o

    # -- mint: (sig_request, messages, elgamal_sk) -> Signature -------------

    def _enc_req_mint(self, sig_request, messages, elgamal_sk):
        return (
            _pack_blob(sig_request.to_bytes(self.ctx))
            + _pack_frs(messages)
            + ser.fr_to_bytes(elgamal_sk)
        )

    def _dec_req_mint(self, b, o):
        from ..signature import SignatureRequest

        raw, o = _read_blob(b, o)
        sig_req = SignatureRequest.from_bytes(raw, self.ctx)
        msgs, o = _read_frs(b, o)
        raw, o = _read_exact(b, o, 32, "ElGamal sk")
        return (sig_req, msgs, ser.fr_from_bytes(raw)), o

    def _enc_resp_mint(self, sig):
        # trailing u32: the epoch this credential was minted under (the
        # keychain-pinned fan-out stamped it in issue._release); clients
        # carry it into every later verify/show of the credential
        return sig.to_bytes(self.ctx) + _pack_epoch(
            getattr(sig, "epoch", None)
        )

    def _dec_resp_mint(self, b, o):
        from ..signature import Signature

        raw, o = _read_exact(b, o, 2 * self.ctx.sig_nbytes, "Signature")
        sig = Signature.from_bytes(raw, self.ctx)
        epoch, o = _read_epoch(b, o)
        if epoch is not None:
            sig.epoch = epoch
        return sig, o

    # -- show_prove: (sig, messages) -> (proof, challenge, revealed) --------

    _enc_req_show_prove = _enc_req_verify
    _dec_req_show_prove = _dec_req_verify

    def _enc_resp_show_prove(self, result):
        proof, challenge, revealed = result
        return (
            _pack_blob(proof.to_bytes(self.ctx))
            + ser.fr_to_bytes(challenge)
            + _pack_revealed(revealed)
        )

    def _dec_resp_show_prove(self, b, o):
        from ..ps import PoKOfSignatureProof

        raw, o = _read_blob(b, o)
        proof = PoKOfSignatureProof.from_bytes(raw, self.ctx)
        raw, o = _read_exact(b, o, 32, "challenge")
        challenge = ser.fr_from_bytes(raw)
        revealed, o = _read_revealed(b, o)
        return (proof, challenge, revealed), o

    # -- show_verify: (proof, revealed, challenge, epoch, domain, tag)
    #    -> bool ------------------------------------------------------------

    def _enc_req_show_verify(
        self, proof, revealed_msgs, challenge=None, epoch=None,
        domain=None, tag=None,
    ):
        has = challenge is not None
        has_tag = tag is not None
        return b"".join(
            (
                _pack_blob(proof.to_bytes(self.ctx)),
                _pack_revealed(revealed_msgs),
                bytes([1 if has else 0]),
                ser.fr_to_bytes(challenge) if has else b"",
                # the shown credential's mint epoch (0 = unpinned): a
                # proof is only sound against the verkey it was built for
                _pack_epoch(epoch),
                # v4: scenario nullifier scope — domain ("" = unscoped)
                # and optional 32-byte deterministic spend tag
                _pack_str(domain or ""),
                bytes([1 if has_tag else 0]),
                bytes(tag) if has_tag else b"",
            )
        )

    def _dec_req_show_verify(self, b, o):
        from ..ps import PoKOfSignatureProof

        raw, o = _read_blob(b, o)
        proof = PoKOfSignatureProof.from_bytes(raw, self.ctx)
        revealed, o = _read_revealed(b, o)
        raw, o = _read_exact(b, o, 1, "show_verify request")
        challenge = None
        if raw[0]:
            raw, o = _read_exact(b, o, 32, "challenge")
            challenge = ser.fr_from_bytes(raw)
        epoch, o = _read_epoch(b, o)
        domain, o = _read_str(b, o)
        raw, o = _read_exact(b, o, 1, "show_verify request")
        tag = None
        if raw[0]:
            raw, o = _read_exact(b, o, 32, "spend tag")
            tag = bytes(raw)
        return (proof, revealed, challenge, epoch, domain or None, tag), o

    _enc_resp_show_verify = _enc_resp_verify
    _dec_resp_show_verify = _dec_resp_verify
