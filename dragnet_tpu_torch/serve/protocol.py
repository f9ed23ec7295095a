"""Wire framing for the `dn serve` protocol, v1 and v2.

Counterpart (a copy) of dragnet_tpu/serve/protocol.py.

v1: one request per connection.  The client sends one JSON
request line; the server answers with one JSON header line —
``{"ok", "rc", "nout", "nerr", "stats", "retryable"}`` — followed by
exactly ``nout`` stdout bytes and ``nerr`` stderr bytes, then closes
the connection.  Wrong shape for high fan-in: every request pays a
dial, and every idle dashboard costs the server an open-and-forgotten
socket it must thread-babysit.

v2: persistent multiplexed connections.  A request is still
one JSON line (the existing byte-counted newline-JSON payloads are
unchanged), but carries two extra fields::

    {"proto": 2, "id": 17, "op": "query", ...}

``id`` is a client-chosen positive integer, unique among the
connection's in-flight requests.  Requests may be PIPELINED — sent
back to back without waiting — and responses may return OUT OF ORDER:
each response frame is the same header line plus payload bytes, with
``"proto": 2`` and the request's ``id`` echoed so the client can
demultiplex.  The connection stays open across requests.

Negotiation is a protocol field, not a handshake round-trip: a v1
server ignores the unknown ``proto``/``id`` keys, answers with a v1
header (no ``id``) and closes — the client detects the missing ``id``,
keeps the (correct) response, and downgrades that endpoint to
dial-per-request.  A v2 server serves requests WITHOUT ``proto``
exactly as v1 did, byte-identically, so old clients keep working.

This module holds the frame encode/decode helpers and the incremental
line splitter both sides share, and the server-initiated push frames
of `dn subscribe` (serve/subscribe.py) with their byte-delta codec;
the server's readiness loop lives in
ioloop.py and the client's connection pool in pool.py.
"""

import json

# one request/response frame (header line + payload) may not exceed
# this; a line that grows past it without a newline is a torn or
# malicious frame and the connection is closed
MAX_FRAME_BYTES = 1 << 24

PROTO_V2 = 2


class FrameError(Exception):
    """A malformed frame (oversized, non-JSON, bad protocol fields).
    The connection that produced it cannot be trusted to be in sync
    and is closed after an error response where one can be framed."""


def classify_request(req):
    """(proto, request_id) for a parsed request dict: (1, None) for a
    legacy request, (2, id) for a well-formed v2 frame.  Raises
    FrameError on a malformed v2 frame (proto present but wrong, or
    a missing/bad id)."""
    proto = req.get('proto')
    if proto is None or proto == 1:
        return 1, None
    if proto != PROTO_V2:
        raise FrameError('unsupported protocol %r' % (proto,))
    rid = req.get('id')
    if not isinstance(rid, int) or isinstance(rid, bool) or rid <= 0:
        raise FrameError('protocol 2 requires a positive integer '
                         '"id", got %r' % (rid,))
    return PROTO_V2, rid


def encode_request(req, rid):
    """One v2 request frame (bytes) for `req` under request id
    `rid`."""
    return json.dumps(dict(req, proto=PROTO_V2, id=rid),
                      sort_keys=True).encode('utf-8') + b'\n'


def encode_push(sub, seq, epoch, kind, payload=b'', extra=None):
    """One SERVER-INITIATED push frame (bytes) for subscription `sub`
    (`dn subscribe`, serve/subscribe.py).  Same newline-JSON header +
    byte-counted payload shape as a response, but carrying ``sub``
    (the subscription id) INSTEAD of a request ``id`` — that absence
    is the discriminator: a client frame with ``id`` answers a
    request it sent, a frame with ``sub`` is the server talking
    first.  ``kind`` is 'full' (payload = the complete rendered
    result bytes), 'delta' (payload = the inserted span; `extra`
    carries the patch doc), 'current' (resume matched — no payload),
    or 'end' (the server is dropping the subscription; `extra`
    carries the reason).  v1 connections can never receive one:
    registration itself requires a v2 frame (server.py rejects a v1
    subscribe before a subscription exists)."""
    header = {'proto': PROTO_V2, 'sub': sub, 'seq': seq,
              'epoch': epoch, 'kind': kind, 'ok': True, 'rc': 0,
              'nout': len(payload), 'nerr': 0,
              'stats': extra or {}}
    return (json.dumps(header, sort_keys=True).encode('utf-8') +
            b'\n' + payload)


def classify_frame(header):
    """Client-side demux of one received header dict: 'push' for a
    server-initiated subscription frame (``sub`` present, no request
    ``id``), 'response' for an answer to a request this side sent.
    A frame carrying BOTH is malformed — the connection is out of
    sync."""
    has_id = header.get('id') is not None
    has_sub = header.get('sub') is not None
    if has_id and has_sub:
        raise FrameError('frame carries both "id" and "sub"')
    return 'push' if has_sub else 'response'


def encode_response(rc, out, err, extra, proto=1, rid=None):
    """One response frame: the JSON header line plus the stdout and
    stderr payload bytes.  `extra` rides as the header's `stats`
    section; `retryable` and `retry_after_ms` are hoisted to the top
    level so clients can act on them without digging."""
    header = {'ok': rc == 0, 'rc': rc, 'nout': len(out),
              'nerr': len(err), 'stats': extra,
              'retryable': bool(extra.get('retryable'))}
    if extra.get('retry_after_ms') is not None:
        header['retry_after_ms'] = extra['retry_after_ms']
    if proto == PROTO_V2:
        header['proto'] = PROTO_V2
        header['id'] = rid
    return (json.dumps(header, sort_keys=True).encode('utf-8') +
            b'\n' + out + err)


class LineBuffer(object):
    """Incremental newline-frame splitter: feed() raw chunks, take()
    complete lines.  Raises FrameError when a line exceeds
    MAX_FRAME_BYTES without terminating — the only honest move left
    is closing the connection."""

    __slots__ = ('_buf', 'max_bytes')

    def __init__(self, max_bytes=MAX_FRAME_BYTES):
        self._buf = bytearray()
        self.max_bytes = max_bytes

    def feed(self, data):
        self._buf.extend(data)

    def take(self):
        """Every complete line currently buffered (without the
        trailing newline), leaving any partial tail in place."""
        lines = []
        while True:
            nl = self._buf.find(b'\n')
            if nl < 0:
                break
            lines.append(bytes(self._buf[:nl]))
            del self._buf[:nl + 1]
        if len(self._buf) > self.max_bytes:
            raise FrameError('frame exceeds %d bytes without a '
                             'newline' % self.max_bytes)
        return lines

    def pending(self):
        """Bytes of the partial line waiting for its newline."""
        return len(self._buf)


# -- push-frame delta codec --------------------------------------------------
#
# A standing query's payload usually changes at the tail (new time
# buckets) or in a few counter digits, so a push can often ship just
# the edited span: a delta frame carries {"off": O, "keep": K} plus
# the inserted bytes, meaning
#
#     new = old[:O] + inserted + old[len(old)-K:]
#
# Reconstruction is pure byte splicing — trivially byte-identical, no
# structural diff to trust.  The prefix/suffix scan runs as O(log n)
# slice comparisons (C memcmp speed), not a per-byte Python loop.

def _common_prefix_len(a, b):
    n = min(len(a), len(b))
    lo, hi = 0, n
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if a[:mid] == b[:mid]:
            lo = mid
        else:
            hi = mid - 1
    return lo


def byte_delta(old, new):
    """(off, keep, inserted) such that
    ``new == old[:off] + inserted + old[len(old)-keep:]``."""
    off = _common_prefix_len(old, new)
    ta, tb = old[off:], new[off:]
    n = min(len(ta), len(tb))
    lo, hi = 0, n
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if ta[len(ta) - mid:] == tb[len(tb) - mid:]:
            lo = mid
        else:
            hi = mid - 1
    keep = lo
    return off, keep, new[off:len(new) - keep]


def apply_delta(old, off, keep, inserted):
    """Reconstruct the new payload from `old` and a delta frame's
    patch; raises FrameError on an inconsistent patch (the client's
    base diverged — reconnect and re-seed)."""
    if not isinstance(off, int) or not isinstance(keep, int) or \
            isinstance(off, bool) or isinstance(keep, bool) or \
            off < 0 or keep < 0 or off + keep > len(old):
        raise FrameError('delta patch inconsistent with base payload '
                         '(off=%r keep=%r base=%d)'
                         % (off, keep, len(old)))
    return old[:off] + inserted + old[len(old) - keep:]


class LineBuffer(object):
    """Incremental newline-frame splitter: feed() raw chunks, take()
    complete lines.  Raises FrameError when a line exceeds
    MAX_FRAME_BYTES without terminating — the only honest move left
    is closing the connection."""

    __slots__ = ('_buf', 'max_bytes')

    def __init__(self, max_bytes=MAX_FRAME_BYTES):
        self._buf = bytearray()
        self.max_bytes = max_bytes

    def feed(self, data):
        self._buf.extend(data)

    def take(self):
        """Every complete line currently buffered (without the
        trailing newline), leaving any partial tail in place."""
        lines = []
        while True:
            nl = self._buf.find(b'\n')
            if nl < 0:
                break
            lines.append(bytes(self._buf[:nl]))
            del self._buf[:nl + 1]
        if len(self._buf) > self.max_bytes:
            raise FrameError('frame exceeds %d bytes without a '
                             'newline' % self.max_bytes)
        return lines

    def pending(self):
        """Bytes of the partial line waiting for its newline."""
        return len(self._buf)
