"""The `dn serve` readiness front end: one selector thread owns every
client connection, so thousands of idle connections cost zero threads
and a half-dead peer can never pin a worker.

Counterpart (a copy) of dragnet_tpu/serve/ioloop.py.  One thread per
accepted connection, parked in a blocking ``readline()``, would let a
peer that sent half a header (slow-loris, wedged NIC, dead VM) pin
that thread for the socket timeout, and enough of them the process.
This loop keeps transport a stage of its own:

* **Reads** are non-blocking: bytes land in a per-connection
  LineBuffer; each complete request line is handed to the server's
  dispatcher (which spawns/queues execution work — never blocks the
  loop).
* **Writes** are queued: workers enqueue response frames with
  ``send()`` (thread-safe, never blocks on the peer); the loop drains
  them as the socket accepts bytes, so a slow reader costs queue
  memory, not a worker.
* **Deadlines and reaping** ride the loop's tick:
  - a connection holding a PARTIAL request line longer than
    ``read_deadline_ms`` is reaped (the slow-loris bound),
  - a response pending longer than ``write_deadline_ms`` is reaped
    (the slow-reader bound),
  - a connection with no traffic and no in-flight work for
    ``idle_ms`` is reaped (the fd-leak bound).  0 disables each.

The loop knows framing only as "newline-terminated lines"; protocol
interpretation (v1 vs v2, ids, payloads) stays in server.py, and
execution stays in the worker threads behind admission control.
"""

import os
import selectors
import socket
import struct
import threading
import time
from collections import deque

from . import protocol as mod_protocol

_RECV_CHUNK = 1 << 16


def peer_identity(sock):
    """The transport-level tenant hint for an accepted socket: the
    peer uid for unix sockets (SO_PEERCRED), the peer address for
    TCP.  Requests may override with an explicit `tenant` field."""
    try:
        if sock.family == socket.AF_UNIX:
            creds = sock.getsockopt(socket.SOL_SOCKET,
                                    socket.SO_PEERCRED,
                                    struct.calcsize('3i'))
            pid, uid, gid = struct.unpack('3i', creds)
            return 'uid:%d' % uid
        host, port = sock.getpeername()[:2]
        return 'ip:%s' % host
    except (OSError, AttributeError, ValueError):
        return 'peer:unknown'


class Conn(object):
    """One accepted connection's loop-side state.  The loop thread
    owns everything except `inflight_ids`, which workers also touch
    (under `ids_lock`) when they retire a completed request id."""

    __slots__ = ('sock', 'fd', 'peer', 'rbuf', 'wbufs', 'wpos',
                 'proto', 'inflight', 'close_after_flush', 'closed',
                 'last_activity', 'read_started', 'write_started',
                 'inflight_ids', 'ids_lock', 'paused', 'registered',
                 'pinned')

    def __init__(self, sock, peer):
        self.sock = sock
        self.fd = sock.fileno()
        self.peer = peer
        self.rbuf = mod_protocol.LineBuffer()
        self.wbufs = deque()
        self.wpos = 0
        self.proto = None           # unknown until the first frame
        self.inflight = 0           # dispatched, not yet responded
        self.close_after_flush = False
        self.closed = False
        now = time.monotonic()
        self.last_activity = now
        self.read_started = None    # partial frame's first byte
        self.write_started = None   # oldest unflushed response
        self.inflight_ids = set()   # v2 duplicate-id guard
        self.ids_lock = threading.Lock()
        self.paused = False         # v1: one request, then no reads
        self.registered = False     # currently in the selector
        self.pinned = 0             # live subscriptions: no idle reap

    def pending_write(self):
        return bool(self.wbufs)


class IOLoop(object):
    """The selector loop.  `on_request(conn, line)` runs ON the loop
    thread for every complete request line and must return quickly
    (parse + hand off); `on_overflow(conn)` likewise when a frame
    exceeds the size bound.  `on_accept(conn)` may veto a connection
    by returning False (fault injection)."""

    def __init__(self, listener, conf, on_request, on_overflow=None,
                 on_accept=None, on_close=None, log=None):
        self.listener = listener
        self.conf = conf
        self.on_request = on_request
        self.on_overflow = on_overflow
        self.on_accept = on_accept
        # on_close(conn) fires on the loop thread for every closed
        # connection — how a SubscriptionManager learns its peer died
        # (serve/subscribe.py).  Must be quick and must not raise.
        self.on_close = on_close
        self.log = log
        self._sel = selectors.DefaultSelector()
        listener.setblocking(False)
        self._sel.register(listener, selectors.EVENT_READ, 'accept')
        r, w = os.pipe()
        os.set_blocking(r, False)
        os.set_blocking(w, False)
        self._wake_r, self._wake_w = r, w
        self._sel.register(r, selectors.EVENT_READ, 'wake')
        self._actions = deque()
        self._alock = threading.Lock()
        self._accepting = True
        self._shutdown_at = None     # flush deadline once stopping
        self._finished = threading.Event()
        self._thread = None
        self._conns = {}
        self._clock = threading.Lock()
        self.counters = {'conns_accepted': 0, 'conns_closed': 0,
                         'frames_in': 0, 'reaped_idle': 0,
                         'reaped_read_deadline': 0,
                         'reaped_write_deadline': 0,
                         'oversized_frames': 0, 'v2_conns': 0}

    # -- cross-thread API --------------------------------------------------

    def _wake(self):
        try:
            os.write(self._wake_w, b'x')
        except (BlockingIOError, OSError):
            pass

    def _enqueue(self, action):
        with self._alock:
            self._actions.append(action)
        self._wake()

    def send(self, conn, data, close_after=False, completes=False):
        """Queue response bytes on `conn` (thread-safe; never blocks
        on the peer).  `completes` marks the end of one dispatched
        request (decrements the in-flight count the reaper consults);
        `close_after` closes the connection once the bytes flush
        (v1's one-shot contract)."""
        self._enqueue(('send', conn, data, close_after, completes))

    def close_conn(self, conn, completes=False):
        """Close `conn` without a response (fault injection, torn
        frames)."""
        self._enqueue(('close', conn, None, False, completes))

    def pin(self, conn):
        """Exempt `conn` from idle reaping (thread-safe): a
        registered subscriber is QUIET by design — no requests, no
        pending writes between pushes — and must not be garbage-
        collected as an fd leak.  Counted, so overlapping
        subscriptions compose; the read/write deadlines still apply
        (a wedged peer is reaped, pinned or not)."""
        self._enqueue(('pin', conn, None, False, False))

    def unpin(self, conn):
        self._enqueue(('unpin', conn, None, False, False))

    def stop_accepting(self):
        self._enqueue(('stop_accept', None, None, False, False))

    def shutdown(self, flush_s):
        """Stop the loop: drain pending writes for up to `flush_s`,
        then close every connection and exit.  Blocks until the loop
        thread finishes."""
        self._enqueue(('shutdown', None, flush_s, False, False))
        self._finished.wait(flush_s + 5.0)
        if self._thread is not None:
            self._thread.join(2.0)

    def start(self):
        self._thread = threading.Thread(target=self.run,
                                        name='dn-serve-ioloop',
                                        daemon=True)
        self._thread.start()
        return self

    def stats(self):
        with self._clock:
            doc = dict(self.counters)
        doc['conns_open'] = len(self._conns)
        return doc

    def _bump(self, name, n=1):
        with self._clock:
            self.counters[name] = self.counters.get(name, 0) + n

    # -- the loop ----------------------------------------------------------

    def run(self):
        try:
            while True:
                try:
                    events = self._sel.select(0.1)
                except OSError:
                    break
                for key, mask in events:
                    tag = key.data
                    if tag == 'accept':
                        self._accept()
                    elif tag == 'wake':
                        self._drain_wake()
                    else:
                        if mask & selectors.EVENT_READ:
                            self._readable(tag)
                        if mask & selectors.EVENT_WRITE and \
                                not tag.closed:
                            self._writable(tag)
                self._drain_actions()
                self._tick()
                if self._shutdown_at is not None:
                    flushed = not any(c.pending_write() or c.inflight
                                      for c in self._conns.values())
                    if flushed or \
                            time.monotonic() >= self._shutdown_at:
                        break
        finally:
            for conn in list(self._conns.values()):
                self._close(conn)
            try:
                self._sel.close()
            except OSError:
                pass
            for fd in (self._wake_r, self._wake_w):
                try:
                    os.close(fd)
                except OSError:
                    pass
            self._finished.set()

    def _drain_wake(self):
        try:
            while os.read(self._wake_r, 4096):
                pass
        except (BlockingIOError, OSError):
            pass

    def _drain_actions(self):
        while True:
            with self._alock:
                if not self._actions:
                    return
                kind, conn, data, close_after, completes = \
                    self._actions.popleft()
            if kind == 'stop_accept':
                self._stop_accept()
                continue
            if kind == 'shutdown':
                self._stop_accept()
                self._shutdown_at = time.monotonic() + (data or 0)
                continue
            if conn is None or conn.closed:
                continue
            if completes:
                conn.inflight = max(0, conn.inflight - 1)
            if kind == 'pin':
                conn.pinned += 1
                continue
            if kind == 'unpin':
                conn.pinned = max(0, conn.pinned - 1)
                continue
            if kind == 'close':
                self._close(conn)
                continue
            # send
            if data:
                conn.wbufs.append(memoryview(data))
                if conn.write_started is None:
                    conn.write_started = time.monotonic()
            if close_after:
                conn.close_after_flush = True
            conn.last_activity = time.monotonic()
            self._update_interest(conn)
            # opportunistic flush: most responses fit the socket
            # buffer, sparing a selector round-trip
            self._writable(conn)

    def _stop_accept(self):
        if not self._accepting:
            return
        self._accepting = False
        try:
            self._sel.unregister(self.listener)
        except (KeyError, OSError):
            pass
        try:
            self.listener.close()
        except OSError:
            pass

    # -- readiness handlers ------------------------------------------------

    def _accept(self):
        while self._accepting:
            try:
                sock, _ = self.listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            sock.setblocking(False)
            conn = Conn(sock, peer_identity(sock))
            if self.on_accept is not None and \
                    not self.on_accept(conn):
                # vetoed (injected accept fault): the peer sees a
                # reset/EOF — exactly the failure its retry loop
                # exists for
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            self._conns[conn.fd] = conn
            self._bump('conns_accepted')
            self._sel.register(sock, selectors.EVENT_READ, conn)
            conn.registered = True

    def _readable(self, conn):
        if conn.closed or conn.paused:
            return
        try:
            data = conn.sock.recv(_RECV_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close(conn)
            return
        if not data:
            self._close(conn)
            return
        conn.last_activity = time.monotonic()
        conn.rbuf.feed(data)
        try:
            lines = conn.rbuf.take()
        except mod_protocol.FrameError:
            self._bump('oversized_frames')
            if self.on_overflow is not None:
                self.on_overflow(conn)
            else:
                self._close(conn)
            return
        for line in lines:
            if conn.closed or conn.paused:
                break
            self._bump('frames_in')
            conn.inflight += 1
            self.on_request(conn, line)
        if conn.closed:
            return
        if conn.rbuf.pending():
            # the deadline clock starts at the partial frame's FIRST
            # byte and is never reset by later drips — a peer feeding
            # one byte per interval must still be reaped
            if conn.read_started is None:
                conn.read_started = time.monotonic()
        else:
            conn.read_started = None

    def pause_reading(self, conn):
        """v1 backpressure: after its single request, a v1 connection
        reads nothing further (loop thread only)."""
        conn.paused = True
        self._update_interest(conn)

    def _update_interest(self, conn):
        """(Re)register `conn` for exactly the events it needs.  A
        paused connection with nothing to write is UNREGISTERED —
        keeping read interest on a socket we refuse to read (pending
        bytes, or EOF after a peer half-close) would make select()
        return instantly forever and busy-spin the loop thread."""
        if conn.closed:
            return
        events = 0
        if not conn.paused:
            events |= selectors.EVENT_READ
        if conn.pending_write():
            events |= selectors.EVENT_WRITE
        try:
            if not events:
                if conn.registered:
                    self._sel.unregister(conn.sock)
                    conn.registered = False
            elif conn.registered:
                self._sel.modify(conn.sock, events, conn)
            else:
                self._sel.register(conn.sock, events, conn)
                conn.registered = True
        except (KeyError, OSError):
            pass

    def _writable(self, conn):
        while conn.wbufs:
            buf = conn.wbufs[0]
            try:
                n = conn.sock.send(buf[conn.wpos:])
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._close(conn)
                return
            conn.wpos += n
            if conn.wpos >= len(buf):
                conn.wbufs.popleft()
                conn.wpos = 0
            if n == 0:
                break
        if not conn.wbufs:
            conn.write_started = None
            if conn.close_after_flush:
                self._close(conn)
                return
        self._update_interest(conn)

    # -- reaping -----------------------------------------------------------

    def _tick(self):
        now = time.monotonic()
        rd = self.conf.get('read_deadline_ms') or 0
        wd = self.conf.get('write_deadline_ms') or 0
        idle = self.conf.get('idle_ms') or 0
        for conn in list(self._conns.values()):
            if conn.closed:
                continue
            if rd and conn.read_started is not None and \
                    (now - conn.read_started) * 1000.0 >= rd:
                # half a request older than the read deadline: the
                # slow-loris bound — reap without stranding a worker
                self._bump('reaped_read_deadline')
                self._close(conn)
                continue
            if wd and conn.write_started is not None and \
                    (now - conn.write_started) * 1000.0 >= wd:
                self._bump('reaped_write_deadline')
                self._close(conn)
                continue
            if idle and not conn.inflight and not conn.pinned and \
                    not conn.pending_write() and \
                    conn.rbuf.pending() == 0 and \
                    (now - conn.last_activity) * 1000.0 >= idle:
                self._bump('reaped_idle')
                self._close(conn)

    def _close(self, conn):
        if conn.closed:
            return
        conn.closed = True
        self._conns.pop(conn.fd, None)
        self._bump('conns_closed')
        if conn.registered:
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, OSError):
                pass
            conn.registered = False
        try:
            conn.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        if self.on_close is not None:
            try:
                self.on_close(conn)
            except Exception:
                pass
