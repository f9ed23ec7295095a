"""Client-side pooled persistent connections for the serve protocol
(v2, serve/protocol.py).

Counterpart (a copy) of dragnet_tpu/serve/pool.py.  Dialing a fresh
socket for every `--remote` request and every health/stats probe is
the wrong shape for high fan-in (each dial burns a round trip and a
file descriptor).  The pool keeps ONE long-lived multiplexed connection per endpoint:

* `exchange()` assigns the request a connection-unique id, sends one
  v2 frame, and parks on a per-request waiter; a background reader
  thread demultiplexes response frames by id, so any number of
  threads share the connection concurrently (the router's whole
  partial fan-out rides one socket per member).
* Negotiation is transparent: a v1 server ignores the proto/id
  fields, answers a correct v1 response (no `id`) and closes — the
  reader delivers it to the sole outstanding waiter, the endpoint is
  marked v1, and future requests fall back to dial-per-request
  (serve/client.py handles that path).
* Failure classification preserves the retry contract: a connection
  that dies BEFORE a waiter's header is pre-commit (plain OSError —
  the caller's retry loop re-dials); one that dies mid-payload AFTER
  that waiter's header arrived is post-commit (RemoteTransportError —
  never silently retried).

The pool is process-global (`get()`); `reset()` closes everything
(tests, and forked children must not share sockets).
"""

import itertools
import json
import socket
import threading
import time

from ..errors import DNError
from .. import faults as mod_faults
from ..vpipe import counter_bump
from . import protocol as mod_protocol


class _Waiter(object):
    __slots__ = ('event', 'header', 'payload', 'error')

    def __init__(self):
        self.event = threading.Event()
        self.header = None
        self.payload = b''
        self.error = None


def _transport_error():
    from . import client as mod_client
    return mod_client.RemoteTransportError


class LiveTimeout(OSError):
    """A pooled exchange whose own response never came while the
    connection kept delivering other requests' frames: the connection
    is alive, and its other in-flight exchanges stand."""


class PooledConn(object):
    """One endpoint's persistent multiplexed connection."""

    def __init__(self, endpoint, connect_timeout_s):
        from . import client as mod_client
        # client._connect fires the client.connect fault seam and
        # applies the connect deadline; a pooled conn then goes fully
        # blocking — per-request deadlines are the waiters' timeouts,
        # and an idle-reaped conn just shows up as EOF to the reader
        self.endpoint = endpoint
        self.sock = mod_client._connect(endpoint, None,
                                        connect_timeout_s)
        self.sock.settimeout(None)
        self._file = self.sock.makefile('rb')
        self._wlock = threading.Lock()
        self._lock = threading.Lock()
        self._waiters = {}
        self._ids = itertools.count(1)
        # ids in actual wire order — only needed until the FIRST
        # response settles the peer's protocol (a v1 answer goes to
        # the oldest-sent waiter); cleared and no longer tracked once
        # the conn is confirmed v2
        self._sent_order = []
        self._confirmed_v2 = False
        self.broken = False
        self.saw_v1 = False
        self.last_delivery = time.monotonic()
        t = threading.Thread(target=self._reader,
                             name='dn-pool-reader', daemon=True)
        t.start()

    # -- reader (demux) ----------------------------------------------------

    def _reader(self):
        err = None
        try:
            while True:
                line = self._file.readline(
                    mod_protocol.MAX_FRAME_BYTES)
                if not line:
                    break
                header = json.loads(line.decode('utf-8'))
                self.last_delivery = time.monotonic()
                nout = int(header.get('nout', 0))
                nerr = int(header.get('nerr', 0))
                rid = header.get('id')
                payload, short = self._read_payload(nout + nerr)
                if short:
                    # THIS response's header arrived but its payload
                    # was cut: post-commit for its waiter alone
                    self._deliver(rid, None, None, _transport_error()(
                        'remote response truncated mid-payload'))
                    break
                if rid is None:
                    if header.get('sub') is not None:
                        # a server-initiated subscription push frame:
                        # never a pool concern (subscribe_stream uses
                        # its own dedicated connection) — a stray one
                        # here means a subscription leaked onto the
                        # pooled conn; discard it rather than
                        # misreading it as a v1 downgrade
                        counter_bump('remote pool push discarded')
                        continue
                    # a v1 server answered our v2 frame: correct
                    # response, no multiplexing — deliver to the
                    # oldest-sent waiter and downgrade the endpoint
                    self.saw_v1 = True
                    self._deliver_v1(header, payload)
                    break
                if not self._confirmed_v2:
                    self._confirmed_v2 = True
                    with self._lock:
                        self._sent_order = []
                self._deliver(rid, header, payload, None)
        except (OSError, ValueError) as e:
            err = e
        finally:
            self._fail_all(err, from_reader=True)

    def _read_payload(self, size):
        chunks = []
        left = size
        while left > 0:
            chunk = self._file.read(min(1 << 16, left))
            if not chunk:
                return b''.join(chunks), True
            chunks.append(chunk)
            left -= len(chunk)
        return b''.join(chunks), False

    def _deliver(self, rid, header, payload, error):
        with self._lock:
            w = self._waiters.pop(rid, None)
        if w is None:
            return               # timed-out waiter: discard
        w.header, w.payload, w.error = header, payload, error
        w.event.set()

    def _deliver_v1(self, header, payload):
        """A v1 server answered the FIRST request line it read off
        this connection — sends are serialized under _wlock, so that
        is the oldest entry of _sent_order still waiting.  Deliver
        to exactly that waiter (any others fail pre-commit when the
        reader exits, and retry against the now-downgraded
        endpoint)."""
        with self._lock:
            rid = None
            while self._sent_order:
                cand = self._sent_order.pop(0)
                if cand in self._waiters:
                    rid = cand
                    break
        if rid is not None:
            self._deliver(rid, header, payload, None)

    def _fail_all(self, err, from_reader=False):
        """EOF/transport death: every still-parked waiter never saw
        its header — pre-commit, retry-safe.  Only the reader thread
        may close the makefile (close() takes the buffer lock a
        reader blocked in readline() already holds — another thread
        closing it would deadlock); everyone else shuts the SOCKET
        down, which wakes that blocked read with EOF."""
        self.broken = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        if from_reader:
            try:
                self._file.close()
            except (OSError, ValueError):
                pass
        with self._lock:
            waiters = list(self._waiters.values())
            self._waiters.clear()
        detail = str(err) if err is not None else \
            'pooled connection closed before the response header'
        for w in waiters:
            if not w.event.is_set():
                w.error = OSError(detail)
                w.event.set()

    # -- exchange ----------------------------------------------------------

    def exchange(self, req, timeout_s, phase):
        """Send one request, wait for its response.  Returns
        (header, payload_bytes).  Raises OSError pre-commit,
        RemoteTransportError post-commit.  `phase['phase']` flips to
        'exchange' once the frame is on the wire (the retry loop's
        reached-a-server classification)."""
        if self.broken:
            raise OSError('pooled connection is broken')
        rid = next(self._ids)
        w = _Waiter()
        with self._lock:
            if self.broken:
                raise OSError('pooled connection is broken')
            self._waiters[rid] = w
        # the connection is established: like _open_request, anything
        # past here counts as having reached a server (the retry
        # loop's RemoteRetryExhausted-vs-Unreachable classification)
        phase['phase'] = 'exchange'
        try:
            frame = mod_protocol.encode_request(req, rid)
            mod_faults.fire('client.send')
            with self._wlock:
                if not self._confirmed_v2:
                    # record wire order BEFORE the bytes leave: a
                    # fast v1 peer can answer and EOF before this
                    # thread runs again, and _deliver_v1 must find
                    # the rid or the response is dropped on the
                    # floor (a stale entry from a failed send is
                    # harmless — _deliver_v1 skips rids with no
                    # parked waiter)
                    with self._lock:
                        self._sent_order.append(rid)
                self.sock.sendall(frame)
            sent_at = time.monotonic()
            mod_faults.fire('client.recv')
            if not w.event.wait(timeout_s):
                # OUR response never came.  Kill the shared conn only
                # when it delivered NOTHING since our send — then it
                # is plausibly wedged; if other requests' frames kept
                # arriving the conn is demonstrably alive and a
                # short-timeout probe must not fail every concurrent
                # in-flight exchange on it
                if self.last_delivery < sent_at:
                    self._fail_all(OSError(
                        'pooled exchange timed out after %.1fs'
                        % timeout_s))
                    raise OSError('pooled exchange timed out after '
                                  '%.1fs' % timeout_s)
                raise LiveTimeout('pooled exchange timed out after '
                                  '%.1fs' % timeout_s)
            if w.error is not None:
                raise w.error
            return w.header, w.payload
        finally:
            with self._lock:
                self._waiters.pop(rid, None)


class ConnectionPool(object):
    """Endpoint -> PooledConn, with v1 downgrade memory and
    reuse/dial accounting (bench-fanin reads these)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._conns = {}
        self._v1 = set()
        self._pid = None
        self.counters = {'dials': 0, 'reuses': 0, 'downgrades': 0,
                         'invalidated': 0, 'evicted': 0}

    def _bump(self, name, n=1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def is_v1(self, endpoint):
        with self._lock:
            self._check_pid()
            return endpoint in self._v1

    def _check_pid(self):
        # a forked child must never share the parent's sockets or
        # reader threads: start fresh (call with _lock held)
        import os
        pid = os.getpid()
        if self._pid != pid:
            self._pid = pid
            self._conns = {}
            self._v1 = set()

    def _get(self, endpoint, connect_timeout_s):
        with self._lock:
            self._check_pid()
            conn = self._conns.get(endpoint)
            if conn is not None and not conn.broken:
                self.counters['reuses'] += 1
                return conn
        # dial outside the pool lock (a dead endpoint must not stall
        # other endpoints' exchanges), then publish
        conn = PooledConn(endpoint, connect_timeout_s)
        with self._lock:
            current = self._conns.get(endpoint)
            if current is not None and not current.broken:
                # someone else dialed first: use theirs
                conn._fail_all(OSError('redundant dial'))
                self.counters['reuses'] += 1
                return current
            self._conns[endpoint] = conn
            self.counters['dials'] += 1
        return conn

    def invalidate(self, endpoint, conn=None):
        with self._lock:
            current = self._conns.get(endpoint)
            if current is not None and \
                    (conn is None or current is conn):
                self._conns.pop(endpoint, None)
                self.counters['invalidated'] += 1
                current.broken = True
        if conn is not None:
            conn._fail_all(OSError('connection invalidated'))

    def exchange(self, endpoint, req, timeout_s, connect_timeout_s,
                 phase):
        """One request over the pooled connection.  Returns (header,
        payload).  Raises OSError/ValueError pre-commit (retry-safe),
        RemoteTransportError post-commit.  Callers must check
        is_v1() first and use the dial-per-request path for
        downgraded endpoints."""
        conn = self._get(endpoint, connect_timeout_s)
        try:
            header, payload = conn.exchange(req, timeout_s, phase)
        except LiveTimeout:
            # the connection is demonstrably alive: keep it for the
            # exchanges still in flight on it (the reference
            # invalidates it here, failing them all with "connection
            # invalidated" — a short-timeout probe starved for a few
            # seconds then kills a long partial on the same conn)
            raise
        except (DNError, OSError, ValueError):
            # even a failed exchange may have LEARNED the endpoint is
            # v1 (one concurrent first-contact waiter got the real
            # response; the rest fail here pre-commit): record the
            # downgrade so retries take the dial path immediately
            if conn.saw_v1:
                self._mark_v1(endpoint)
            self.invalidate(endpoint, conn)
            raise
        if conn.saw_v1:
            self._mark_v1(endpoint)
            self.invalidate(endpoint, conn)
        return header, payload

    def _mark_v1(self, endpoint):
        with self._lock:
            if endpoint not in self._v1:
                self._v1.add(endpoint)
                self.counters['downgrades'] += 1
        counter_bump('remote pool v1 downgrades')

    def close_endpoint(self, endpoint):
        """Retire an endpoint that left the serving topology: its
        pooled connection closes NOW (waking the demux reader and any
        parked waiters with a clean pre-commit error) and its
        v1-downgrade memory drops, so a member re-added later starts
        fresh.  Without this, a departed member's socket, reader
        thread, and downgrade verdict linger until process exit.
        Returns True when a live connection was actually closed."""
        with self._lock:
            conn = self._conns.pop(endpoint, None)
            self._v1.discard(endpoint)
            if conn is not None:
                self.counters['evicted'] += 1
        if conn is not None:
            conn._fail_all(OSError('endpoint removed from topology'))
            return True
        return False

    def reset(self):
        with self._lock:
            conns = list(self._conns.values())
            self._conns = {}
            self._v1 = set()
        for conn in conns:
            conn._fail_all(OSError('pool reset'))

    def stats(self):
        with self._lock:
            doc = dict(self.counters)
            doc['open'] = sum(1 for c in self._conns.values()
                              if not c.broken)
        return doc


_POOL = ConnectionPool()


def get():
    """The process-global pool."""
    return _POOL
