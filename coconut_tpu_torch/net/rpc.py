"""RPC ingress: the Replica server wrapper, client transports, and the
typed GatewayClient.

One Replica wraps one engine (a ProtocolEngine, or anything exposing
`submit_<program>` futures — a bare CredentialService's `submit` serves
the "verify" program) behind the CTS-RPC/1 wire format (net/wire.py):

  request frame in -> decode -> tenant admission (net/tenant.py, BEFORE
  the engine sees the request) -> engine submit -> response frame out
  the moment the engine future settles (ServeFuture.add_done_callback —
  no parked thread per in-flight request). EVERY failure on that path
  becomes a typed MSG_ERROR envelope carrying the request's own seq, so
  a client future always settles: wire garbage, auth/quota/rate-limit
  refusals, brownout/overload shedding, and engine-side exceptions all
  travel the same way.

Two transports share one client:

  SocketTransport    real length-prefixed frames over a TCP connection;
                     a reader thread correlates responses to in-flight
                     futures by seq and fails ALL pending futures with
                     TransientBackendError when the peer dies (the
                     router's failover trigger).
  LoopbackTransport  in-memory, synchronous, zero sockets — the
                     deterministic fake-clock path chaos tests and CI
                     run on.

GatewayClient mirrors ProtocolEngine's submit_* surface 1:1 and
re-raises decoded error envelopes as the ORIGINAL typed exceptions
(errors.error_from_wire), so retry/backoff code written against the
engine — including serve/loadgen.py — runs unchanged over RPC.

Counters: "gateway_requests" / "gateway_responses" / "gateway_errors"
(engine-side failures) / "gateway_refusals" (admission refusals) /
"gateway_wire_errors" (undecodable frames).
"""

import socket
import threading
import time

from .. import metrics
from ..errors import (
    DeserializationError,
    GeneralError,
    ServiceClosedError,
    TransientBackendError,
)
from ..serve.queue import ServeFuture
from . import wire
from .wire import (
    HEADER_BYTES,
    MSG_BEACON,
    MSG_BEACON_POLL,
    MSG_ERROR,
    PROGRAM_OF_REQUEST,
    REQUEST_TYPES,
    RESPONSE_TYPES,
    decode_frame,
    encode_frame,
    parse_header,
)

#: default cap a synchronous handle_frame waits for the engine future
DEFAULT_RESULT_TIMEOUT_S = 60.0


def _recv_exact(conn, n):
    """Read exactly n bytes or raise ConnectionError on EOF."""
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf += chunk
    return buf


class Replica:
    """One engine behind the wire protocol: a serve loop (real sockets)
    plus a synchronous `handle_frame` seam (loopback transports, golden
    tests). Stateless per request — all session state lives client-side
    in the credential flow itself, which is what makes router failover
    a plain resubmit."""

    def __init__(
        self,
        engine,
        codec,
        tenants=None,
        replica_id="r0",
        clock=time.monotonic,
        result_timeout_s=DEFAULT_RESULT_TIMEOUT_S,
        lifecycle=None,
    ):
        self.engine = engine
        self.codec = codec
        self.tenants = tenants
        self.replica_id = replica_id
        self.clock = clock
        self.result_timeout_s = result_timeout_s
        #: optional engine.lifecycle.LifecycleController: when present,
        #: the beacon reports "warming" until boot() finished its
        #: manifest replay and begin_drain() routes through it
        self.lifecycle = lifecycle
        self.address = None
        self._srv = None
        self._accept_thread = None
        self._closed = False
        self._draining = False
        self._conns_lock = threading.Lock()
        self._conns = set()

    # -- health beacon -------------------------------------------------------

    def beacon(self, now=None):
        """Self-report engine health as a wire.Beacon. Computed from the
        ENGINE OBJECT, not the process-global metrics module — several
        replicas sharing one test process must not read each other's
        gauges. Works for any engine; non-ExecutionEngine services
        (e.g. a bare CredentialService in the bench) report healthy
        with their queue depth."""
        eng = self.engine
        now = self.clock() if now is None else now
        depth = eng.depth() if hasattr(eng, "depth") else 0
        capacity = (
            eng._capacity_fraction()
            if hasattr(eng, "_capacity_fraction")
            else 1.0
        )
        executors = []
        if hasattr(eng, "_all_executors"):
            executors = eng._all_executors()
        healthy = len(executors)
        if executors and hasattr(eng, "_health_of"):
            healthy = sum(
                1
                for ex in executors
                if eng._health_of(ex.label).admissible()
            )
        brownout = False
        if hasattr(eng, "_brownout") and hasattr(eng, "_order"):
            primary = eng._order[0]
            # BrownoutPolicy.check is pure — probing it here sheds nothing
            brownout, _ = eng._brownout.check(
                "bulk", depth, primary.queue.max_depth, capacity
            )
        # wire v2: advertise the live key-epoch window when the engine
        # runs a key lifecycle (routers learn which mint epochs verify
        # here); a keychain-less engine advertises the empty window
        keychain = getattr(eng, "keychain", None)
        epochs = (
            tuple(keychain.live_epochs()) if keychain is not None else ()
        )
        # wire v3: piggyback the durable state plane's per-keyspace
        # high-water marks — peers compare them with their own store
        # and anti-entropy-pull any gap (state/replicate.py); an engine
        # without a StateStore advertises the empty mark set
        store = getattr(eng, "state_store", None)
        state_marks = store.marks() if store is not None else ()
        crashed = getattr(eng, "_crashed", None) is not None
        lc_state = (
            self.lifecycle.state if self.lifecycle is not None else None
        )
        if self._closed or crashed:
            state = "down"
        elif self._draining or lc_state in ("draining", "closed"):
            # still answering polls — gossip must see DRAINING (settle
            # in-flight, route new sessions elsewhere), not a miss that
            # reads as a crash
            state = "draining"
        elif lc_state == "warming":
            state = "warming"
        elif capacity <= 0.0 or (executors and healthy == 0):
            state = "quarantined"
        elif brownout:
            state = "brownout"
        else:
            state = "healthy"
        return wire.Beacon(
            replica_id=self.replica_id,
            state=state,
            capacity_fraction=capacity,
            queue_depth=depth,
            brownout=bool(brownout),
            healthy_executors=healthy,
            executors=len(executors),
            t=now,
            epochs=epochs,
            state_marks=state_marks,
        )

    # -- request handling ----------------------------------------------------

    def _error_frame(self, exc, seq, program=None):
        return encode_frame(
            MSG_ERROR, wire.encode_error(exc, program=program), seq=seq
        )

    def _submit(self, program, args, lane):
        m = getattr(self.engine, "submit_" + program, None)
        if m is None and program == "verify":
            # a bare verify service (CredentialService) exposes submit()
            m = getattr(self.engine, "submit", None)
        if m is None:
            raise GeneralError(
                "replica %r does not serve program %r"
                % (self.replica_id, program)
            )
        return m(*args, lane=lane)

    def handle_message(self, msg_type, seq, payload, send):
        """Process one decoded frame; `send(frame_bytes)` is called
        exactly once — immediately for beacons and refusals, or from the
        engine thread that settles the request's future. `send` must be
        safe to call from another thread (the socket path serializes
        writes under a per-connection lock)."""
        metrics.count("gateway_requests")
        if msg_type == MSG_BEACON_POLL:
            if self._closed:
                metrics.count("gateway_refusals")
                send(
                    self._error_frame(
                        ServiceClosedError("replica closed"), seq
                    )
                )
                return
            send(
                encode_frame(
                    MSG_BEACON, wire.encode_beacon(self.beacon()), seq=seq
                )
            )
            return
        if msg_type == wire.MSG_STATE_PULL:
            # anti-entropy page: serve replicated state records
            # from the engine's StateStore per-origin log. Served even
            # while draining — state transfer is how facts escape a
            # replica on its way down — but not once closed.
            if self._closed:
                metrics.count("gateway_refusals")
                send(
                    self._error_frame(
                        ServiceClosedError("replica closed"), seq
                    )
                )
                return
            store = getattr(self.engine, "state_store", None)
            try:
                ks, origin, after_seq, limit = wire.decode_state_pull(
                    payload
                )
                records = (
                    store.records_after(ks, origin, after_seq, limit)
                    if store is not None
                    else ()
                )
                metrics.count("gateway_state_pulls")
                send(
                    encode_frame(
                        wire.MSG_STATE_CHUNK,
                        wire.encode_state_chunk(records),
                        seq=seq,
                    )
                )
            except Exception as e:
                metrics.count("gateway_wire_errors")
                send(self._error_frame(e, seq))
            return
        program = PROGRAM_OF_REQUEST.get(msg_type)
        if program is None:
            metrics.count("gateway_wire_errors")
            send(
                self._error_frame(
                    DeserializationError(
                        "unknown request type 0x%02x" % msg_type
                    ),
                    seq,
                )
            )
            return
        try:
            program, lane, api_key, _session, args = (
                self.codec.decode_request(msg_type, payload)
            )
        except DeserializationError as e:
            metrics.count("gateway_wire_errors")
            send(self._error_frame(e, seq, program))
            return
        try:
            if self._closed or self._draining:
                # retryable over the wire: the router fails this
                # over to a ring successor instead of surfacing it
                raise ServiceClosedError(
                    "replica %r is %s: resubmit elsewhere"
                    % (
                        self.replica_id,
                        "draining" if self._draining else "closed",
                    )
                )
            if self.tenants is not None:
                self.tenants.admit(api_key, program=program)
            fut = self._submit(program, args, lane)
        except Exception as e:
            metrics.count("gateway_refusals")
            send(self._error_frame(e, seq, program))
            return

        def _respond(f):
            exc = f.exception()
            if exc is not None:
                metrics.count("gateway_errors")
                send(self._error_frame(exc, seq, program))
                return
            try:
                frame = encode_frame(
                    RESPONSE_TYPES[program],
                    self.codec.encode_response(program, f.result()),
                    seq=seq,
                )
            except Exception as e:
                metrics.count("gateway_errors")
                send(self._error_frame(e, seq, program))
                return
            metrics.count("gateway_responses")
            send(frame)

        fut.add_done_callback(_respond)

    def handle_frame(self, data, timeout=None):
        """Synchronous request/response: one encoded frame in, one
        encoded response frame out (the loopback-transport data path).
        Blocks until the engine settles, bounded by `timeout`."""
        if self._closed:
            raise ConnectionError(
                "replica %r is closed" % (self.replica_id,)
            )
        try:
            msg_type, seq, payload = decode_frame(data)
        except DeserializationError as e:
            metrics.count("gateway_wire_errors")
            return self._error_frame(e, seq=0)
        box = []
        done = threading.Event()

        def send(frame):
            box.append(frame)
            done.set()

        self.handle_message(msg_type, seq, payload, send)
        if not done.wait(
            self.result_timeout_s if timeout is None else timeout
        ):
            raise TimeoutError(
                "replica %r: no response within timeout"
                % (self.replica_id,)
            )
        return box[0]

    # -- socket serve loop ---------------------------------------------------

    def serve(self, host="127.0.0.1", port=0):
        """Bind, listen, and serve on a daemon accept thread; returns
        the bound (host, port). port=0 picks a free port."""
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(64)
        self._srv = srv
        self._closed = False
        self.address = srv.getsockname()
        self._accept_thread = threading.Thread(
            target=self._accept_loop,
            name="replica-%s-accept" % self.replica_id,
            daemon=True,
        )
        self._accept_thread.start()
        return self.address

    def _accept_loop(self):
        while True:
            try:
                conn, _peer = self._srv.accept()
            except OSError:
                return  # listener closed
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(
                target=self._conn_loop,
                args=(conn,),
                name="replica-%s-conn" % self.replica_id,
                daemon=True,
            ).start()

    def _conn_loop(self, conn):
        wlock = threading.Lock()

        def send(frame):
            try:
                with wlock:
                    conn.sendall(frame)
            except OSError:
                pass  # peer gone; its client-side futures fail there

        try:
            while True:
                header = _recv_exact(conn, HEADER_BYTES)
                try:
                    msg_type, seq, length = parse_header(header)
                except DeserializationError as e:
                    # framing is lost — answer once and drop the
                    # connection rather than stream garbage
                    metrics.count("gateway_wire_errors")
                    send(self._error_frame(e, seq=0))
                    return
                payload = _recv_exact(conn, length)
                self.handle_message(msg_type, seq, payload, send)
        except (ConnectionError, OSError):
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def begin_drain(self, timeout=None):
        """Graceful drain-and-handoff: flip the beacon to
        DRAINING and stop admitting program requests (each refusal is a
        RETRYABLE ServiceClosedError the router resubmits on a ring
        successor), keep ANSWERING beacon polls so gossip sees an
        orderly shutdown rather than a crash, settle every in-flight
        future via the engine drain (response frames go out as futures
        settle), then close the listener. `timeout` is ONE deadline
        shared across the whole drain. Returns True iff the engine
        drained in time."""
        self._draining = True
        if self.lifecycle is not None:
            ok = self.lifecycle.begin_drain(timeout=timeout)
        else:
            drain = getattr(self.engine, "drain", None)
            ok = bool(drain(timeout=timeout)) if callable(drain) else True
        self.close()
        return ok

    def close(self):
        """Stop serving: refuse new frames, close the listener and every
        live connection. The wrapped engine is NOT drained — the probe's
        kill/rejoin cycle closes and re-serves the same engine.

        Each socket is shut down before it is closed: on Linux a close()
        alone neither wakes a thread blocked in accept() or recv() on it
        nor sends the peer its FIN until that call returns, so a client
        with requests parked on the engine would not see the kill until
        it sent again. The shutdown ends both at once."""
        self._closed = True
        socks = [self._srv] if self._srv is not None else []
        self._srv = None
        with self._conns_lock:
            socks += list(self._conns)
            self._conns = set()
        for sock in socks:
            for end in (lambda: sock.shutdown(socket.SHUT_RDWR), sock.close):
                try:
                    end()
                except OSError:
                    pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
            self._accept_thread = None


class LoopbackTransport:
    """In-memory transport calling a Replica's handle_frame directly on
    the submitting thread — fully deterministic (no sockets, no reader
    threads), which is what lets the chaos tests run on a fake clock.
    `kill()` simulates a dead peer: every subsequent request raises
    TransientBackendError, exactly like a torn TCP connection."""

    def __init__(self, replica, timeout_s=DEFAULT_RESULT_TIMEOUT_S):
        self.replica = replica
        self.timeout_s = timeout_s
        self._dead = None

    def request(self, msg_type, payload, timeout=None):
        if self._dead is not None:
            raise TransientBackendError(
                "loopback to %r is down: %s"
                % (self.replica.replica_id, self._dead)
            )
        try:
            resp = self.replica.handle_frame(
                encode_frame(msg_type, payload, seq=1),
                timeout=self.timeout_s if timeout is None else timeout,
            )
        except (ConnectionError, OSError) as e:
            raise TransientBackendError(
                "loopback to %r failed: %s"
                % (self.replica.replica_id, e)
            )
        resp_type, _seq, resp_payload = decode_frame(resp)
        return resp_type, resp_payload

    def request_async(self, msg_type, payload):
        """Future-shaped request (the client's submit path). Loopback
        resolves it inline — synchronous under the hood, so tests see
        every effect the moment submit returns."""
        fut = ServeFuture()
        try:
            fut.set_result(self.request(msg_type, payload))
        except Exception as e:
            fut.set_exception(e)
        return fut

    @property
    def dead(self):
        return self._dead is not None

    def kill(self):
        self._dead = "killed"

    def revive(self):
        self._dead = None

    def close(self):
        self._dead = "closed"


class SocketTransport:
    """One TCP connection multiplexing concurrent requests by seq. The
    reader thread settles each response onto its pending future; a torn
    connection fails EVERY pending future with TransientBackendError so
    no client ever dangles on a dead socket."""

    def __init__(self, address, connect_timeout_s=5.0):
        host, port = address
        self._sock = socket.create_connection(
            (host, port), timeout=connect_timeout_s
        )
        self._sock.settimeout(None)
        self._wlock = threading.Lock()
        self._lock = threading.Lock()
        self._pending = {}
        self._next_seq = 1
        self._dead = None
        self._reader = threading.Thread(
            target=self._reader_loop,
            name="gateway-reader-%s:%s" % (host, port),
            daemon=True,
        )
        self._reader.start()

    @property
    def dead(self):
        return self._dead is not None

    def request_async(self, msg_type, payload):
        fut = ServeFuture()
        with self._lock:
            if self._dead is not None:
                fut.set_exception(
                    TransientBackendError(
                        "gateway connection down: %s" % (self._dead,)
                    )
                )
                return fut
            seq = self._next_seq
            self._next_seq += 1
            self._pending[seq] = fut
        frame = encode_frame(msg_type, payload, seq=seq)
        try:
            with self._wlock:
                self._sock.sendall(frame)
        except OSError as e:
            self._fail(e)  # fails every pending future, ours included
        return fut

    def request(self, msg_type, payload, timeout=None):
        return self.request_async(msg_type, payload).result(timeout)

    def _reader_loop(self):
        try:
            while True:
                header = _recv_exact(self._sock, HEADER_BYTES)
                msg_type, seq, length = parse_header(header)
                payload = _recv_exact(self._sock, length)
                with self._lock:
                    fut = self._pending.pop(seq, None)
                if fut is not None:
                    fut.set_result((msg_type, payload))
        except (ConnectionError, OSError, DeserializationError) as e:
            self._fail(e)

    def _fail(self, e):
        with self._lock:
            if self._dead is None:
                self._dead = e
            pending, self._pending = self._pending, {}
        if pending:
            metrics.count("gateway_conn_failures")
        err = TransientBackendError(
            "gateway connection lost: %s" % (e,)
        )
        for fut in pending.values():
            fut.set_exception(err)
        try:
            self._sock.close()
        except OSError:
            pass

    def close(self):
        self._fail(ConnectionError("closed by client"))


class RpcFuture:
    """Client-side future mapping a transport response onto the engine
    API's result shape — or re-raising the decoded typed exception, so
    `except ServiceBrownoutError` works identically over the wire."""

    def __init__(self, inner, program, codec):
        self._inner = inner
        self._program = program
        self._codec = codec
        #: parity with ServeFuture's tracing field (no trace over RPC)
        self.trace_id = None

    def done(self):
        return self._inner.done()

    def add_done_callback(self, fn):
        self._inner.add_done_callback(lambda _f: fn(self))

    def result(self, timeout=None):
        msg_type, payload = self._inner.result(timeout)
        if msg_type == MSG_ERROR:
            raise wire.decode_error(payload)
        want = RESPONSE_TYPES[self._program]
        if msg_type != want:
            raise DeserializationError(
                "response type 0x%02x for %r (want 0x%02x)"
                % (msg_type, self._program, want)
            )
        return self._codec.decode_response(self._program, payload)

    def exception(self, timeout=None):
        try:
            self.result(timeout)
            return None
        except TimeoutError:
            raise
        except Exception as e:
            return e


class GatewayClient:
    """ProtocolEngine's submit_* surface over one transport. Stamps the
    caller's API key and session id onto every request frame; the
    session id is ONLY routing affinity (net/router.py hashes it) —
    replicas themselves stay stateless."""

    def __init__(self, transport, codec, api_key="", session=""):
        self.transport = transport
        self.codec = codec
        self.api_key = api_key
        self.session = session

    def _submit(self, program, args, lane, session):
        payload = self.codec.encode_request(
            program,
            args,
            lane=lane,
            api_key=self.api_key,
            session=self.session if session is None else session,
        )
        inner = self.transport.request_async(
            REQUEST_TYPES[program], payload
        )
        return RpcFuture(inner, program, self.codec)

    # max_wait_ms rides for API compat with the engine surface; the
    # replica applies each program's own coalescing default server-side

    def submit_verify(self, sig, messages, lane="interactive",
                      max_wait_ms=None, session=None):
        return self._submit("verify", (sig, messages), lane, session)

    #: CredentialService-shaped alias (bench + verify loadgen)
    def submit(self, sig, messages, lane="interactive", max_wait_ms=None):
        return self.submit_verify(
            sig, messages, lane=lane, max_wait_ms=max_wait_ms
        )

    def submit_prepare(self, messages, elgamal_pk, lane="bulk",
                       max_wait_ms=None, session=None):
        return self._submit(
            "prepare", (messages, elgamal_pk), lane, session
        )

    def submit_mint(self, sig_request, messages, elgamal_sk,
                    lane="interactive", max_wait_ms=None, session=None):
        return self._submit(
            "mint", (sig_request, messages, elgamal_sk), lane, session
        )

    def submit_show_prove(self, sig, messages, lane="interactive",
                          max_wait_ms=None, session=None):
        return self._submit("show_prove", (sig, messages), lane, session)

    def submit_show_verify(self, proof, revealed_msgs, challenge=None,
                           epoch=None, domain=None, tag=None,
                           lane="interactive", max_wait_ms=None,
                           session=None):
        return self._submit(
            "show_verify",
            (proof, revealed_msgs, challenge, epoch, domain, tag),
            lane, session,
        )

    def poll_beacon(self, timeout=5.0):
        """Synchronous beacon poll — the GossipLoop poller. Raises the
        decoded error (or TransientBackendError) on a refusing or dead
        replica, which the loop records as a miss."""
        msg_type, payload = self.transport.request(
            MSG_BEACON_POLL, b"", timeout=timeout
        )
        if msg_type == MSG_ERROR:
            raise wire.decode_error(payload)
        if msg_type != MSG_BEACON:
            raise DeserializationError(
                "beacon poll answered with 0x%02x" % msg_type
            )
        return wire.decode_beacon(payload)

    def pull_state(self, keyspace, origin, after_seq, limit=512,
                   timeout=5.0):
        """Synchronous anti-entropy pull: one page of the
        peer's replicated state records for (keyspace, origin) with
        seq > after_seq. The StateReplicator's transfer path."""
        msg_type, payload = self.transport.request(
            wire.MSG_STATE_PULL,
            wire.encode_state_pull(keyspace, origin, after_seq, limit),
            timeout=timeout,
        )
        if msg_type == MSG_ERROR:
            raise wire.decode_error(payload)
        if msg_type != wire.MSG_STATE_CHUNK:
            raise DeserializationError(
                "state pull answered with 0x%02x" % msg_type
            )
        return wire.decode_state_chunk(payload)

    def close(self):
        self.transport.close()
