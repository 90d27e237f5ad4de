"""The port's CTS-RPC/4 wire (`coconut_tpu_torch.net.wire`), the protocol
objects' strict `from_bytes`, the compressed point encodings and the error
envelope's code map, against the JAX package's, on the CPU.

- Golden vectors: the frame header, an error envelope, two beacons and a
  verify request's digest pinned by tests/test_gateway.py come out of the
  port byte for byte.
- Cross-package round trips: every program's request and response payload
  (one credential session's objects, drawn from one seed on the port's
  host spec), the beacon with its epoch window and state marks, the state
  pull and chunk, and the envelope of every error class: what one package
  encodes, the other decodes and re-encodes to the same bytes.
- Strict decode: unknown version, bad magic, a truncated header, a length
  mismatch, an over-cap length, trailing bytes, a truncated request, a
  non-canonical Fr, a duplicate revealed index and a point outside the
  subgroup all raise DeserializationError.
- `WIRE_ERROR_CODES` equals the reference's code by code (the reference's
  own table in tests/test_gateway.py predates the tenant codes).
- The health beacon: the port's ExecutionEngine, CredentialService and
  ProtocolEngine carry every attribute `Replica.beacon` reads, and their
  beacons equal the reference's for the same engine state.

Tolerance: exact — bytes, digests, classes, codes and fields.
"""

import hashlib
import importlib
import random
import secrets
import struct
from types import SimpleNamespace

import pytest
import torch

from coconut_tpu_torch import entry
from torch_show_helpers import as_jax

MSGS = 3
REVEALED = [1, 2]
SEED = 0x3A7E


def _pkg(name):
    imp = lambda mod: importlib.import_module("%s.%s" % (name, mod))
    return SimpleNamespace(
        name=name,
        wire=imp("net.wire"),
        rpc=imp("net.rpc"),
        errors=imp("errors"),
        serialize=imp("ops.serialize"),
        signature=imp("signature"),
        ps=imp("ps"),
        params=imp("params"),
        keygen=imp("keygen"),
        engine=imp("engine"),
        core=imp("engine.core"),
        service=imp("serve.service"),
        epoch=imp("keylife.epoch"),
        store=imp("state.store"),
    )


REF, PORT = _pkg("coconut_tpu"), _pkg("coconut_tpu_torch")


@pytest.fixture(scope="module")
def world():
    """One credential session's objects on the port's host spec, every
    draw from SEED, and both packages' codecs over the same params."""
    from coconut_tpu_torch import pok_sig
    from coconut_tpu_torch.elgamal import elgamal_keygen
    from coconut_tpu_torch.keygen import trusted_party_SSS_keygen
    from coconut_tpu_torch.params import Params
    from coconut_tpu_torch.signature import BlindSignature, Signature, SignatureRequest, Verkey
    from coconut_tpu_torch.sss import rand_fr

    with entry.seeded_draws(SEED):
        params = Params.new(MSGS, b"test-torch-wire")
        _, _, signers = trusted_party_SSS_keygen(2, 3, params)
        vk = Verkey.aggregate(2, [(s.id, s.verkey) for s in signers])
        esk, epk = elgamal_keygen(params.ctx.sig, params.g)
        msgs = [rand_fr() for _ in range(MSGS)]
        sig_req, randomness = SignatureRequest.new(msgs, 1, epk, params)
        partials = [
            (s.id, BlindSignature.new(sig_req, s.sigkey, params).unblind(esk, params.ctx))
            for s in signers[:2]
        ]
        cred = Signature.aggregate(2, partials)
        proof, challenge, revealed = pok_sig.show(cred, vk, params, msgs, REVEALED)
    stamped = Signature(cred.sigma_1, cred.sigma_2)
    stamped.epoch = 5  # a credential minted under key epoch 5
    jparams, jvk, _ = as_jax(params, vk, [])
    return SimpleNamespace(
        params=params, jparams=jparams, vk=vk, jvk=jvk, signers=signers, esk=esk,
        epk=epk, msgs=msgs, sig_req=sig_req, randomness=randomness, cred=cred,
        stamped=stamped, proof=proof, challenge=challenge, revealed=revealed,
        codec=PORT.wire.WireCodec(params), ref_codec=REF.wire.WireCodec(jparams),
    )


# --- golden vectors (tests/test_gateway.py) -------------------------------------


def test_frame_header_golden():
    wire = PORT.wire
    frame = wire.encode_frame(0x01, b"abc", seq=7)
    assert frame.hex() == "c0c704010000000700000003616263"
    assert wire.decode_frame(frame) == (0x01, 7, b"abc")


def test_error_envelope_golden():
    e = PORT.errors.ServiceBrownoutError(
        "bulk", 0.5, depth=3, capacity_fraction=0.25, program="prepare"
    )
    env = PORT.wire.encode_error(e)
    assert env.hex() == (
        "000862726f776e6f75740007707265706172653fe00000000000000100"
        "4e736572766963652062726f776e6f757420286361706163697479203235"
        "252c2064657074682033293a2062756c6b206c616e65207368656420"
        "e28094207265747279206166746572207e302e3573"
    )
    d = PORT.wire.decode_error(env)
    assert type(d) is PORT.errors.ServiceBrownoutError
    assert (d.code, d.program, d.retry_after_s, d.wire_retryable) == (
        "brownout", "prepare", 0.5, True,
    )


def test_beacon_golden():
    wire = PORT.wire
    b = wire.Beacon("r2", "brownout", 0.5, 17, True, 2, 4, 12.25)
    assert wire.encode_beacon(b).hex() == (
        "00027232000862726f776e6f75743fe000000000000000000011"
        "01000000020000000440288000"
        "00000000"
        "0000"
        "0000"
    )
    d = wire.decode_beacon(wire.encode_beacon(b))
    assert d.as_dict() == b.as_dict()
    assert d.admissible()
    assert not wire.Beacon("r2", "quarantined", 0.0, 0, False, 0, 4, 0.0).admissible()


def test_beacon_epoch_window_golden():
    wire = PORT.wire
    b = wire.Beacon(
        "r2", "healthy", 1.0, 0, False, 1, 1, 0.0,
        epochs=((1, "retiring"), (2, "active")),
    )
    enc = wire.encode_beacon(b)
    assert enc.hex().endswith("0002" "0000000102" "0000000201" "0000")
    assert wire.decode_beacon(enc).as_dict() == b.as_dict()
    bad = bytearray(enc)
    bad[-3] = 0xEE
    with pytest.raises(PORT.errors.DeserializationError, match="epoch state"):
        wire.decode_beacon(bytes(bad))


def test_verify_request_golden_digest():
    from coconut_tpu_torch.params import Params
    from coconut_tpu_torch.signature import Signature

    params = Params.new(3, b"gateway-golden")
    codec = PORT.wire.WireCodec(params)
    payload = codec.encode_request(
        "verify", (Signature(params.g, params.g), [1, 2, 3]), lane="interactive",
        api_key="k", session="s",
    )
    assert len(payload) == 301
    assert hashlib.sha256(payload).hexdigest() == (
        "c1f36595386d398c6b73b84d97c5c78a1a7a1a4cb0ba68b26adfc1e7c4e30ba5"
    )
    assert codec.encode_response("verify", True).hex() == "01"
    assert codec.encode_response("verify", False).hex() == "00"


# --- cross-package round trips --------------------------------------------------


def _requests(w):
    return {
        "verify": (w.stamped, w.msgs),
        "prepare": (w.msgs, w.epk),
        "mint": (w.sig_req, w.msgs, w.esk),
        "show_prove": (w.cred, w.msgs),
        "show_verify": (w.proof, w.revealed, w.challenge, 5, "ecash", bytes(range(32))),
    }


def _responses(w):
    return {
        "verify": True,
        "prepare": (w.sig_req, w.randomness),
        "mint": w.stamped,
        "show_prove": (w.proof, w.challenge, w.revealed),
        "show_verify": False,
    }


@pytest.mark.parametrize("program", ["verify", "prepare", "mint", "show_prove", "show_verify"])
def test_request_payload_crosses_both_ways(world, program):
    """Port encode -> reference decode -> reference encode (same bytes) ->
    port decode -> port encode (same bytes); the decoded header fields and
    the epoch stamp survive each hop."""
    args = _requests(world)[program]
    msg_type = PORT.wire.REQUEST_TYPES[program]
    assert msg_type == REF.wire.REQUEST_TYPES[program]
    payload = world.codec.encode_request(
        program, args, lane="bulk", api_key="ak", session="sess-9"
    )
    prog, lane, key, sess, ref_args = world.ref_codec.decode_request(msg_type, payload)
    assert (prog, lane, key, sess) == (program, "bulk", "ak", "sess-9")
    again = world.ref_codec.encode_request(program, ref_args, lane=lane, api_key=key, session=sess)
    assert again == payload
    _, _, _, _, port_args = world.codec.decode_request(msg_type, again)
    assert world.codec.encode_request(
        program, port_args, lane="bulk", api_key="ak", session="sess-9"
    ) == payload
    if program == "verify":
        assert ref_args[0].epoch == port_args[0].epoch == 5
        assert (port_args[0].sigma_1, port_args[0].sigma_2) == (
            world.cred.sigma_1, world.cred.sigma_2,
        )
    if program == "show_verify":
        assert port_args[1:] == ref_args[1:] == (
            world.revealed, world.challenge, 5, "ecash", bytes(range(32)),
        )


@pytest.mark.parametrize("program", ["verify", "prepare", "mint", "show_prove", "show_verify"])
def test_response_payload_crosses_both_ways(world, program):
    result = _responses(world)[program]
    payload = world.codec.encode_response(program, result)
    ref_result = world.ref_codec.decode_response(program, payload)
    again = world.ref_codec.encode_response(program, ref_result)
    assert again == payload
    port_result = world.codec.decode_response(program, again)
    assert world.codec.encode_response(program, port_result) == payload
    if program == "mint":
        assert port_result == world.stamped and port_result.epoch == 5


def test_show_verify_request_none_challenge(world):
    payload = world.codec.encode_request("show_verify", (world.proof, world.revealed, None))
    _, _, _, _, args = world.codec.decode_request(PORT.wire.REQUEST_TYPES["show_verify"], payload)
    assert args[2:] == (None, None, None, None)
    assert world.ref_codec.encode_request(
        "show_verify",
        world.ref_codec.decode_request(REF.wire.REQUEST_TYPES["show_verify"], payload)[4],
    ) == payload


@pytest.mark.parametrize("first,second", [(PORT, REF), (REF, PORT)], ids=["port_to_ref", "ref_to_port"])
def test_beacon_and_state_transfer_cross(first, second):
    b = first.wire.Beacon(
        "r1", "draining", 0.75, 9, False, 3, 4, 99.5,
        epochs=((3, "pending"), (4, "active"), (5, "retiring")),
        state_marks=(("nullifier/0", "rA", 12), ("tenant_quota", "rB", 3)),
    )
    enc = first.wire.encode_beacon(b)
    d = second.wire.decode_beacon(enc)
    assert d.as_dict() == b.as_dict()
    assert second.wire.encode_beacon(d) == enc
    pull = first.wire.encode_state_pull("nullifier/0", "rA", 41, 512)
    assert second.wire.decode_state_pull(pull) == ("nullifier/0", "rA", 41, 512)
    assert second.wire.encode_state_pull("nullifier/0", "rA", 41, 512) == pull
    recs = [
        {"ks": "nullifier/0", "k": "ab" * 32, "v": {"d": None, "n": [1, 2]}, "o": "rA",
         "s": 42, "e": None, "t": 0},
        {"ks": "tenant_quota", "k": "greedy", "v": 7, "o": "rB", "s": 3, "e": 2, "t": 1},
    ]
    chunk = first.wire.encode_state_chunk(recs)
    assert second.wire.decode_state_chunk(chunk) == recs
    assert second.wire.encode_state_chunk(recs) == chunk


def test_wire_constants_equal():
    for name in ("WIRE_VERSION", "MAGIC", "MAX_FRAME_BYTES", "HEADER_BYTES", "MSG_BEACON_POLL",
                 "MSG_BEACON", "MSG_STATE_PULL", "MSG_STATE_CHUNK", "MSG_ERROR",
                 "REQUEST_TYPES", "RESPONSE_TYPES"):
        assert getattr(PORT.wire, name) == getattr(REF.wire, name), name


def test_protocol_objects_from_bytes_match_the_reference(world):
    """Verkey, BlindSignature, Params and the compressed points: the port's
    decoders give the reference's objects' bytes back."""
    p, ctx = world.params, world.params.ctx
    vk_bytes = world.vk.to_bytes(ctx)
    vk = PORT.signature.Verkey.from_bytes(vk_bytes, ctx)
    assert vk == world.vk and vk.to_bytes(ctx) == world.jvk.to_bytes(world.jparams.ctx)
    assert REF.signature.Verkey.from_bytes(vk_bytes, world.jparams.ctx).to_bytes(
        world.jparams.ctx) == vk_bytes
    bs = PORT.signature.BlindSignature.new(world.sig_req, world.signers[0].sigkey, p)
    raw = bs.to_bytes(ctx)
    assert PORT.signature.BlindSignature.from_bytes(raw, ctx).to_bytes(ctx) == raw
    assert REF.signature.BlindSignature.from_bytes(raw, world.jparams.ctx).to_bytes(
        world.jparams.ctx) == raw
    praw = p.to_bytes()
    assert praw == world.jparams.to_bytes()
    assert PORT.params.Params.from_bytes(praw) == p
    assert PORT.params.Params.from_bytes(praw) != PORT.params.Params.from_bytes(
        PORT.params.Params.new(MSGS, b"other").to_bytes())
    ser, rser = PORT.serialize, REF.serialize
    for pt in (world.cred.sigma_1, None):
        c = ser.g1_to_compressed(pt)
        assert c == rser.g1_to_compressed(pt)
        assert ser.g1_from_compressed(c) == pt
    for pt in (world.vk.X_tilde, None):
        c = ser.g2_to_compressed(pt)
        assert c == rser.g2_to_compressed(pt)
        assert ser.g2_from_compressed(c) == pt
    with pytest.raises(PORT.errors.DeserializationError, match="compression flag"):
        ser.g1_from_compressed(bytes(48))
    with pytest.raises(PORT.errors.DeserializationError, match="identity"):
        ser.g2_from_compressed(bytes([0xC0]) + b"\x01" * 95)
    with pytest.raises(PORT.errors.DeserializationError, match="malformed"):
        PORT.params.Params.from_bytes(praw[:-1])


# --- strict decode --------------------------------------------------------------


def test_decode_rejects_unknown_version():
    wire = PORT.wire
    with pytest.raises(PORT.errors.DeserializationError, match="version"):
        wire.parse_header(wire.encode_frame(0x01, b"", version=wire.WIRE_VERSION + 1))


def test_decode_rejects_bad_magic():
    frame = bytearray(PORT.wire.encode_frame(0x01, b""))
    frame[0] ^= 0xFF
    with pytest.raises(PORT.errors.DeserializationError, match="magic"):
        PORT.wire.parse_header(bytes(frame))


def test_decode_rejects_truncated_header():
    with pytest.raises(PORT.errors.DeserializationError, match="truncated"):
        PORT.wire.parse_header(PORT.wire.encode_frame(0x01, b"")[:11])


def test_decode_rejects_length_mismatch():
    frame = PORT.wire.encode_frame(0x01, b"abcdef")
    for bad in (frame[:-2], frame + b"zz"):
        with pytest.raises(PORT.errors.DeserializationError, match="mismatch"):
            PORT.wire.decode_frame(bad)


def test_decode_rejects_over_cap_length():
    wire = PORT.wire
    header = struct.pack(">HBBII", wire.MAGIC, wire.WIRE_VERSION, 0x01, 0, wire.MAX_FRAME_BYTES + 1)
    with pytest.raises(PORT.errors.DeserializationError, match="cap"):
        wire.parse_header(header)
    with pytest.raises(ValueError, match="MAX_FRAME_BYTES"):
        wire.encode_frame(0x01, bytes(wire.MAX_FRAME_BYTES + 1))


def test_decode_rejects_trailing_bytes(world):
    wire, errors = PORT.wire, PORT.errors
    with pytest.raises(errors.DeserializationError, match="trailing"):
        wire.decode_error(wire.encode_error(errors.GeneralError("x")) + b"\x00")
    beacon = wire.encode_beacon(wire.Beacon("r", "healthy", 1.0, 0, False, 1, 1, 0.0))
    with pytest.raises(errors.DeserializationError, match="trailing"):
        wire.decode_beacon(beacon + b"\x00")
    req = world.codec.encode_request("verify", (world.cred, [1, 2]))
    with pytest.raises(errors.DeserializationError, match="trailing"):
        world.codec.decode_request(wire.REQUEST_TYPES["verify"], req + b"\x00")
    with pytest.raises(errors.DeserializationError, match="trailing"):
        wire.decode_state_pull(wire.encode_state_pull("k", "o", 1, 2) + b"\x00")


def test_decode_rejects_truncated_request(world):
    req = world.codec.encode_request("mint", (world.sig_req, world.msgs, world.esk))
    for cut in (1, 5, 33, len(req) - 8):
        with pytest.raises(PORT.errors.DeserializationError):
            world.codec.decode_request(PORT.wire.REQUEST_TYPES["mint"], req[:cut])
    with pytest.raises(PORT.errors.DeserializationError, match="unknown request type"):
        world.codec.decode_request(0x3F, req)


def test_decode_rejects_noncanonical_fr(world):
    from coconut_tpu_torch.ops.fields import R

    req = bytearray(world.codec.encode_request("verify", (world.cred, [R - 1])))
    req[-36:-4] = b"\xff" * 32  # the message, before the trailing u32 epoch
    with pytest.raises(PORT.errors.DeserializationError, match="non-canonical"):
        world.codec.decode_request(PORT.wire.REQUEST_TYPES["verify"], bytes(req))


def test_decode_rejects_duplicate_revealed_index():
    payload = (
        (2).to_bytes(2, "big")
        + (1).to_bytes(4, "big") + (5).to_bytes(32, "big")
        + (1).to_bytes(4, "big") + (6).to_bytes(32, "big")
    )
    with pytest.raises(PORT.errors.DeserializationError, match="duplicate"):
        PORT.wire._read_revealed(payload, 0)


def _off_subgroup_g1():
    """A point on E(Fp) outside the r-torsion subgroup: the first x >= 2
    whose x^3 + 4 is a square."""
    from coconut_tpu_torch.ops.curve import g1
    from coconut_tpu_torch.ops.fields import P, fp_sqrt

    x = 2
    while True:
        y = fp_sqrt((x * x * x + 4) % P)
        if y is not None and not g1.in_subgroup((x, y)):
            return x, y
        x += 1


def test_decode_rejects_point_outside_the_subgroup(world):
    """A verify request whose sigma_1 is on the curve but not in G1, and a
    show proof whose J is off the curve, both refuse in either package."""
    wire, ser = PORT.wire, PORT.serialize
    x, y = _off_subgroup_g1()
    raw = ser.fp_to_bytes(x) + ser.fp_to_bytes(y)
    req = bytearray(world.codec.encode_request("verify", (world.cred, world.msgs)))
    o = 1 + 2 + 2  # lane, empty api key, empty session
    req[o : o + 96] = raw
    for codec in (world.codec, world.ref_codec):
        with pytest.raises((PORT.errors.DeserializationError, REF.errors.DeserializationError),
                           match="subgroup"):
            codec.decode_request(wire.REQUEST_TYPES["verify"], bytes(req))
    proof = bytearray(world.proof.to_bytes(world.params.ctx))
    proof[192 + 100] ^= 0x01  # J's x, off the curve
    for cls, ctx in ((PORT.ps.PoKOfSignatureProof, world.params.ctx),
                     (REF.ps.PoKOfSignatureProof, world.jparams.ctx)):
        with pytest.raises((PORT.errors.DeserializationError, REF.errors.DeserializationError)):
            cls.from_bytes(bytes(proof), ctx)


# --- error codes and envelopes --------------------------------------------------


def test_wire_error_codes_equal_the_reference():
    # sorted: the registry is looked up by code, and tests/test_analysis.py
    # deletes and restores a reference entry (monkeypatch.delitem), which
    # moves it to the end of the dict in that worker
    port = sorted((code, cls.__name__) for code, cls in PORT.errors.WIRE_ERROR_CODES.items())
    ref = sorted((code, cls.__name__) for code, cls in REF.errors.WIRE_ERROR_CODES.items())
    assert port == ref
    assert len(port) == 19
    for code, cls in PORT.errors.WIRE_ERROR_CODES.items():
        assert cls.code == code
        assert issubclass(cls, PORT.errors.ServiceRetryableError) == issubclass(
            REF.errors.WIRE_ERROR_CODES[code], REF.errors.ServiceRetryableError
        ), code


def _instances(errors):
    return {
        "general": errors.GeneralError("boom"),
        "bad_request": errors.DeserializationError("garbage"),
        "unsupported_messages": errors.UnsupportedNoOfMessages(6, 5),
        "unequal_bases_exponents": errors.UnequalNoOfBasesExponents(4, 3),
        "ps_error": errors.PSError("revealed messages do not match"),
        "transient": errors.TransientBackendError("hiccup"),
        "retryable": errors.ServiceRetryableError("later", program="mint", retry_after_s=0.2),
        "overloaded": errors.ServiceOverloadedError(4, 4, program="verify", retry_after_s=0.1),
        "brownout": errors.ServiceBrownoutError("bulk", 0.7, program="prepare"),
        "quorum_unreachable": errors.QuorumUnreachableError(3, 1, live=1, program="mint"),
        "closed": errors.ServiceClosedError("drained"),
        "tenant_auth": errors.TenantAuthError("unknown API key: no provisioned tenant"),
        "tenant_quota": errors.TenantQuotaError("acme", 10, 10),
        "tenant_rate_limited": errors.TenantRateLimitError("acme", 0.5, program="verify"),
        "share_rejected": errors.ShareVerificationError(
            "dealer 2 share for recipient 4 failed Pedersen check", dealer_id=2, round="dkg"),
        "dkg_aborted": errors.DkgAbortedError(3, 2, excluded=(1,), program="mint",
                                              retry_after_s=0.5),
        "epoch_unknown": errors.EpochUnknownError(9, live=(1, 2)),
        "epoch_retired": errors.EpochRetiredError(1, live=(2, 3)),
        "double_spend": errors.DoubleSpendError("cd" * 32, epoch=3, domain="ecash"),
    }


@pytest.mark.parametrize("code", list(_instances(REF.errors)))
def test_error_envelope_crosses_both_ways(code):
    """Each package's instance of the class encodes to the same envelope;
    each package decodes the other's to the same class, message, program,
    retry hint and restored fields."""
    port_err, ref_err = _instances(PORT.errors)[code], _instances(REF.errors)[code]
    env = PORT.wire.encode_error(port_err, program="verify")
    assert env == REF.wire.encode_error(ref_err, program="verify")
    for dec, orig in ((REF.wire.decode_error(env), ref_err), (PORT.wire.decode_error(env), port_err)):
        assert type(dec) is type(orig)
        assert (dec.code, str(dec), dec.wire_retryable) == (code, str(orig), bool(
            getattr(orig, "retry_after_s", None) is not None or code == "transient"))
        if isinstance(orig, (PORT.errors.ServiceRetryableError, REF.errors.ServiceRetryableError)):
            # the envelope names the refusing program, the caller's where
            # the error carries none
            assert (dec.retry_after_s, dec.program) == (
                orig.retry_after_s, orig.program or "verify")
        for field in ("expected", "given", "bases", "exponents", "nullifier", "epoch", "domain"):
            if code in ("epoch_unknown", "epoch_retired") and field == "epoch":
                continue  # not restored from the message, in either package
            assert getattr(dec, field, None) == getattr(orig, field, None), field


def test_double_spend_fields_restored_without_epoch_or_domain():
    err = PORT.errors.DoubleSpendError("0f" * 32)
    dec = PORT.wire.decode_error(REF.wire.encode_error(err))
    assert type(dec) is PORT.errors.DoubleSpendError
    assert (dec.nullifier, dec.epoch, dec.domain) == ("0f" * 32, None, None)


def test_error_from_wire_unknown_code_degrades():
    err = PORT.errors.error_from_wire("flux_capacitor", "future error", program="verify")
    assert type(err) is PORT.errors.GeneralError
    assert err.code == "flux_capacitor"
    assert PORT.errors.GeneralError.code == "general"


def test_retry_after_always_finite():
    for hint, want in ((None, 0.0), (-1.0, 0.0), (float("nan"), 0.0), (float("inf"), 0.0),
                       (0.25, 0.25), (3, 3.0)):
        for err in (PORT.errors.ServiceOverloadedError(1, 1, retry_after_s=hint),
                    PORT.errors.TenantRateLimitError("t", hint)):
            assert isinstance(err.retry_after_s, float) and err.retry_after_s == want


# --- the health beacon over real engines -----------------------------------------

#: every attribute Replica.beacon reads from its engine (net/rpc.py)
BEACON_READS = ("depth", "_capacity_fraction", "_all_executors", "_health_of", "_brownout",
                "_order", "keychain", "state_store", "_crashed")


def _spec_backend(pkg):
    """The host spec backend; the port's nullifier guard takes its device
    from the backend, which must then say cpu."""
    if pkg is REF:
        return "python"
    from coconut_tpu_torch.backend import SpecBackend

    be = SpecBackend()
    be.device = torch.device("cpu")
    return be


def _engines(pkg, root):
    """A bare ExecutionEngine, a CredentialService and a ProtocolEngine
    (with a keychain of two epochs and a StateStore holding three records)
    of `pkg`, over its host spec backend, keys drawn from one seed."""
    saved = secrets.randbelow
    secrets.randbelow = random.Random(SEED).randrange
    try:
        params = pkg.params.Params.new(MSGS, b"test-torch-wire-beacon")
        _, _, signers = pkg.keygen.trusted_party_SSS_keygen(2, 3, params)
    finally:
        secrets.randbelow = saved
    vk = pkg.signature.Verkey.aggregate(2, [(s.id, s.verkey) for s in signers])
    registry = pkg.epoch.EpochRegistry(window=3)
    for e in (1, 2):
        registry.register(pkg.epoch.KeySet(e, 0, 2, signers, vk))
    registry.activate(1)
    store = pkg.store.StateStore(str(root / pkg.name), replica_id="rX")
    store.put_many("nullifier/1", [("aa", 1), ("bb", 1)])
    store.put("tenant_quota", "greedy", 2, fsync=False)
    bare = pkg.core.ExecutionEngine(watchdog_interval_s=None)
    svc = pkg.service.CredentialService(
        "python", vk, params, max_batch=4, watchdog_interval_s=None)
    eng = pkg.engine.ProtocolEngine(
        signers, params, 2, count_hidden=1, revealed_msg_indices=REVEALED, vk=vk,
        backend=_spec_backend(pkg), devices=1, max_batch=4, watchdog_interval_s=None,
        keychain=registry, state_store=store,
    )
    return params, {"bare": bare, "service": svc, "protocol": eng}, store


def test_beacon_reads_every_engine_attribute_and_equals_the_reference(tmp_path):
    port_params, port_engines, port_store = _engines(PORT, tmp_path)
    ref_params, ref_engines, ref_store = _engines(REF, tmp_path)
    try:
        for kind in ("bare", "service", "protocol"):
            missing = {a for a in BEACON_READS if not hasattr(port_engines[kind], a)}
            ref_missing = {a for a in BEACON_READS if not hasattr(ref_engines[kind], a)}
            # the port's CredentialService also keeps its keychain, which
            # the reference's hands to its program alone
            assert missing <= ref_missing, kind
            assert not missing or kind == "bare", (kind, missing)

        def beacons(pkg, engines, params):
            codec = pkg.wire.WireCodec(params)
            out = {}
            for kind in ("service", "protocol"):  # a bare engine has no queue
                eng = engines[kind]
                rep = pkg.rpc.Replica(eng, codec, replica_id="r-" + kind, clock=lambda: 7.0)
                out[kind + "_idle"] = rep.beacon().as_dict()
                eng.start()
                out[kind + "_started"] = rep.beacon().as_dict()
                rep._draining = True
                out[kind + "_draining"] = rep.beacon().as_dict()
                rep._draining = False
                eng._crashed = RuntimeError("executor crashed")
                out[kind + "_crashed"] = rep.beacon().as_dict()
                eng._crashed = None
                # the frame the beacon poll answers decodes in the other package
                out[kind + "_frame"] = rep.handle_frame(
                    pkg.wire.encode_frame(pkg.wire.MSG_BEACON_POLL, b"", seq=3))
            return out

        port, ref = beacons(PORT, port_engines, port_params), beacons(REF, ref_engines, ref_params)
        assert port == ref
        assert port["protocol_started"]["epochs"] == ((1, "active"), (2, "pending"))
        assert port["protocol_started"]["state_marks"] == port_store.marks() == ref_store.marks()
        assert port["protocol_started"]["state"] == "healthy"
        assert port["protocol_started"]["executors"] == 1
        assert port["protocol_draining"]["state"] == "draining"
        assert port["protocol_crashed"]["state"] == "down"
        _, seq, payload = REF.wire.decode_frame(port["protocol_frame"])
        assert seq == 3 and REF.wire.decode_beacon(payload).as_dict() == port["protocol_started"]
    finally:
        for engines in (port_engines, ref_engines):
            for kind in ("service", "protocol"):
                engines[kind].drain(timeout=30.0)
        port_store.close()
        ref_store.close()
