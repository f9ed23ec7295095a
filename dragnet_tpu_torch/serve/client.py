"""The `--remote` thin client: ship a parsed request to a resident
`dn serve`, stream the result bytes back verbatim, and survive
transport flaps with bounded, jittered retries.

The client does ALL argument parsing locally (usage errors never
travel), ships the parsed QueryConfig document plus output options,
and writes the response's stdout/stderr bytes through this process's
streams untouched — so remote output is byte-identical to local
output by construction, and `dn query --remote ... | sort` composes
exactly like the local pipeline would.

Retry policy lives HERE, at the transport seam (Diba's
transport/execution separation: the engines never see a retry):

* Failures BEFORE the response header — connect refused/timed out,
  the request send cut short, the connection dying before the header
  — are pre-commit: the server has not published a response.  These
  retry up to DN_REMOTE_RETRIES times with exponential backoff
  (DN_REMOTE_BACKOFF_MS base, +/-50% jitter) on top of a per-attempt
  connect deadline (DN_REMOTE_CONNECT_TIMEOUT_S).  Queries and scans
  are idempotent; builds carry a client-generated idempotency key so
  a retried build whose first request actually ran replays the
  recorded response instead of double-writing.
* Responses the server marks `retryable` (busy, draining) retry the
  same way — the request was never admitted.
* Failures AFTER the header arrives are post-commit: response bytes
  may already be on this process's stdout, so the only honest outcome
  is RemoteTransportError — never a silent re-run.

When every attempt fails, the classification decides the caller's
move: RemoteUnreachable (no attempt ever reached a server — local
fallback is safe and run_or_fallback takes it, with the attempt count
in the warning) vs RemoteRetryExhausted (the server saw at least one
request but never answered — reported as a clean retryable transport
error with the attempt count, never a bare socket traceback, and
never a local fallback that might double-run a build).
"""

import io
import json
import os
import random
import socket
import sys
import time

from ..errors import DNError
from .. import faults as mod_faults
from ..obs import trace as obs_trace
from ..vpipe import counter_bump
from . import pool as mod_pool

CHUNK = 1 << 16


class RemoteTransportError(DNError):
    """The connection died AFTER the server committed a response —
    too late to retry or fall back to local execution."""


class RemoteUnreachable(DNError):
    """Every attempt failed at connect: no server ever saw the
    request, so local fallback is safe (run_or_fallback takes it)."""


class RemoteRetryExhausted(DNError):
    """Pre-commit failures exhausted the retry budget, but at least
    one attempt reached a server (the request may have been received):
    reported, not silently re-run locally."""


def parse_addr(value):
    """'--remote' address forms: a unix socket path, or HOST:PORT /
    :PORT for TCP."""
    if value and os.sep not in value and ':' in value:
        host, _, port = value.rpartition(':')
        if port.isdigit():
            return ('tcp', host or '127.0.0.1', int(port))
    return ('unix', value, None)


def retry_conf():
    """The validated DN_REMOTE_* knobs (config.remote_config); a
    malformed value raises its DNError here, before any socket is
    touched."""
    from .. import config as mod_config
    conf = mod_config.remote_config()
    if isinstance(conf, DNError):
        raise conf
    return conf


def _backoff_s(conf, attempt):
    """Exponential backoff with +/-50% jitter: attempt k (1-based)
    sleeps ~base * 2^(k-1) before attempt k+1."""
    base = conf['backoff_ms'] / 1000.0
    return base * (1 << (attempt - 1)) * random.uniform(0.5, 1.5)


def _connect(value, timeout_s, connect_timeout_s):
    mod_faults.fire('client.connect')
    kind, a, b = parse_addr(value)
    if kind == 'tcp':
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        addr = (a, b)
    else:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        addr = a
    # the connect deadline is its own (tighter) knob: a dead host must
    # fail fast so the retry/backoff loop — or the fallback — can act;
    # the exchange keeps the caller's longer timeout
    sock.settimeout(connect_timeout_s)
    try:
        sock.connect(addr)
    except BaseException:
        sock.close()
        raise
    sock.settimeout(timeout_s)
    return sock


def _open_request(remote, req, timeout_s, conf, phase):
    """Connect, send one request line, read the response header.
    Everything in here is the pre-commit phase: failures raise plain
    OSError/ValueError and retrying is safe.  `phase['phase']` tracks
    how far the attempt got ('connect' -> 'exchange') so exhausted
    retries classify correctly.  Returns (header, response_file,
    sock)."""
    sock = _connect(remote, timeout_s, conf['connect_timeout_s'])
    phase['phase'] = 'exchange'
    try:
        mod_faults.fire('client.send')
        sock.sendall(json.dumps(req).encode() + b'\n')
        f = sock.makefile('rb')
        mod_faults.fire('client.recv')
        line = f.readline()
        if not line:
            raise OSError('server closed the connection before '
                          'responding')
        return json.loads(line.decode('utf-8')), f, sock
    except BaseException:
        sock.close()
        raise


def _read_exact(f, size):
    """Read exactly `size` payload bytes in chunks, yielding each;
    post-commit, so truncation is a RemoteTransportError."""
    left = size
    while left > 0:
        try:
            chunk = f.read(min(CHUNK, left))
        except OSError as e:
            raise RemoteTransportError(
                'remote response interrupted mid-payload',
                cause=DNError(str(e)))
        if not chunk:
            raise RemoteTransportError('remote response truncated '
                                       'mid-payload')
        yield chunk
        left -= len(chunk)


def _default_timeout_s():
    return float(os.environ.get('DN_SERVE_CLIENT_TIMEOUT_S', '3600'))


def _retry_delay_s(conf, attempt, header):
    """Backoff before the next attempt: the server's own
    retry_after_ms hint when the rejection carried one (±20% jitter —
    a shed burst must not retry in lockstep), the blind exponential
    otherwise."""
    hint = header.get('retry_after_ms') if header else None
    if hint is None and header:
        hint = (header.get('stats') or {}).get('retry_after_ms')
    if hint is not None:
        try:
            counter_bump('remote retry-after honored')
            return max(0.001,
                       float(hint) / 1000.0 * random.uniform(0.8,
                                                             1.2))
        except (TypeError, ValueError):
            pass
    return _backoff_s(conf, attempt)


def _attempt(remote, req, timeout_s, conf, phase, pooled):
    """One request attempt: the pooled multiplexed path when the
    endpoint speaks v2, the dial-per-request path otherwise.
    Returns (header, response_file, sock_or_None)."""
    if pooled and not mod_pool.get().is_v1(remote):
        header, payload = mod_pool.get().exchange(
            remote, req, timeout_s, conf['connect_timeout_s'], phase)
        return header, io.BytesIO(payload), None
    return _open_request(remote, req, timeout_s, conf, phase)


def _exchange_with_retry(remote, req, timeout_s, on_header,
                         pooled=False):
    """The shared retry loop: attempt the request up to
    1 + DN_REMOTE_RETRIES times, backing off between attempts on
    pre-commit transport failures and retryable server rejections
    (busy/draining/overloaded — honoring the server's retry_after_ms
    hint when present).  On a kept response, returns
    on_header(header, f) with the socket managed here.  Raises
    RemoteUnreachable / RemoteRetryExhausted on exhaustion (see
    module docstring) and RemoteTransportError from post-commit
    failures.  `pooled` rides the persistent multiplexed connection
    (pool.py) with transparent v1 fallback."""
    conf = retry_conf()
    attempts = conf['retries'] + 1
    last_err = None
    reached_server = False
    for attempt in range(1, attempts + 1):
        phase = {'phase': 'connect'}
        try:
            header, f, sock = _attempt(remote, req, timeout_s, conf,
                                       phase, pooled)
        except RemoteTransportError:
            raise                     # post-commit: never retried
        except (OSError, ValueError, mod_faults.FaultInjected) as e:
            last_err = e
            if phase['phase'] != 'connect':
                reached_server = True
            if attempt < attempts:
                counter_bump('remote transport retries')
                time.sleep(_backoff_s(conf, attempt))
                continue
            break
        if header.get('retryable') and attempt < attempts:
            # busy/draining/shed: the request was never admitted —
            # back off (the server's retry_after_ms when it sent
            # one) and try again (the last attempt keeps the
            # server's error response so the user sees the real
            # message)
            if sock is not None:
                sock.close()
            counter_bump('remote retryable rejections')
            time.sleep(_retry_delay_s(conf, attempt, header))
            continue
        try:
            return on_header(header, f)
        finally:
            if sock is not None:
                sock.close()
    detail = getattr(last_err, 'strerror', None) or str(last_err)
    if reached_server:
        raise RemoteRetryExhausted(
            'remote transport failed after %d attempt(s) '
            '(retryable): %s' % (attempts, detail))
    raise RemoteUnreachable(
        'serve endpoint unreachable after %d attempt(s): %s'
        % (attempts, detail))


def graft_remote_trace(tctx, header):
    """Graft the span subtree a server returned in its response
    header (``stats.trace``) into `tctx` under the caller's current
    span — the shared joined-tree seam for the `--remote` client AND
    the router's pooled partial path."""
    remote_doc = (header.get('stats') or {}).get('trace')
    if remote_doc:
        tctx.graft(remote_doc.get('spans') or remote_doc)


def _write_bytes(stream, data):
    """Verbatim byte pass-through: the underlying binary buffer when
    the stream has one (flushing pending text first so ordering
    holds), a decode otherwise (StringIO capture harnesses)."""
    if not data:
        return
    buf = getattr(stream, 'buffer', None)
    try:
        stream.flush()
    except Exception:
        pass
    if buf is not None:
        buf.write(data)
        buf.flush()
    else:
        stream.write(data.decode('utf-8', 'replace'))


def request(remote, req, timeout_s=None):
    """Send one request (with the retry/backoff armor) and stream the
    response through this process's stdout/stderr.  Returns the
    remote exit code.  Raises RemoteUnreachable while falling back is
    still safe, RemoteRetryExhausted / RemoteTransportError when it
    is not.

    Trace propagation: when this process has an active trace context
    (DN_TRACE / DN_SLOW_MS / --trace), the request carries the
    CLIENT-generated trace id in its ``trace`` header and asks the
    server for its span subtree, which is grafted under this
    request's exchange span — one joined client+server tree."""
    if timeout_s is None:
        timeout_s = _default_timeout_s()
    tctx = obs_trace.current_trace()
    if tctx is not None and 'trace' not in req:
        req = dict(req, trace={'id': tctx.trace_id, 'want': True})
    req = _annotate(req)

    def stream_through(header, f):
        if tctx is not None:
            graft_remote_trace(tctx, header)
        for size, stream in ((header.get('nout', 0), sys.stdout),
                             (header.get('nerr', 0), sys.stderr)):
            for chunk in _read_exact(f, size):
                _write_bytes(stream, chunk)
        return int(header.get('rc', 1))

    # scans stream UNBOUNDED output (every record): they keep the
    # dial-per-request path, whose payload flows through in 64K
    # chunks — the pooled path necessarily buffers a whole response
    # to demultiplex it, which is fine for query/build/stats-sized
    # payloads and an OOM hazard for a multi-GB scan
    pooled = req.get('op') != 'scan'
    with obs_trace.span('remote.exchange', endpoint=str(remote)):
        return _exchange_with_retry(remote, req, timeout_s,
                                    stream_through, pooled=pooled)


def _annotate(req):
    """Attach the ambient request envelope: the end-to-end deadline
    (DN_REMOTE_DEADLINE_MS — the server sheds work it cannot finish
    inside it, and the router propagates the remaining budget to
    member partials) and the tenant identity (DN_REMOTE_TENANT —
    admission fairness keys on it; defaults to peer identity
    server-side)."""
    extra = {}
    if 'deadline_ms' not in req:
        conf = retry_conf()
        if conf['deadline_ms'] > 0:
            extra['deadline_ms'] = conf['deadline_ms']
    if 'tenant' not in req:
        tenant = os.environ.get('DN_REMOTE_TENANT')
        if tenant:
            extra['tenant'] = tenant
    return dict(req, **extra) if extra else req


def request_bytes(remote, req, timeout_s=60.0, retry=False,
                  pooled=None):
    """request() for harnesses, probes, and the router's partials:
    returns (rc, header, stdout_bytes, stderr_bytes) instead of
    writing through the process streams.  Defaults to a single
    attempt; pass retry=True for the armored _exchange_with_retry
    path (health/stats probes do — one transient accept flap must not
    read as a dead server).  `pooled` rides the persistent
    multiplexed connection (defaults to True with retry, False for
    the raw single-shot dial harnesses depend on)."""
    if pooled is None:
        pooled = retry
    req = _annotate(req)

    def buffer_up(header, f):
        out = b''.join(_read_exact(f, header.get('nout', 0)))
        err = b''.join(_read_exact(f, header.get('nerr', 0)))
        return int(header.get('rc', 1)), header, out, err

    if retry:
        return _exchange_with_retry(remote, req, timeout_s,
                                    buffer_up, pooled=pooled)
    conf = retry_conf()
    phase = {'phase': 'connect'}
    if pooled and not mod_pool.get().is_v1(remote):
        header, payload = mod_pool.get().exchange(
            remote, req, timeout_s, conf['connect_timeout_s'], phase)
        return buffer_up(header, io.BytesIO(payload))
    header, f, sock = _open_request(remote, req, timeout_s, conf,
                                    phase)
    try:
        return buffer_up(header, f)
    finally:
        sock.close()


def run_or_fallback(remote, req):
    """request() with the unreachable-server contract: when NO
    attempt ever reached a server (RemoteUnreachable), print the
    fallback warning — with the attempt count — and return None so
    the caller runs the command locally.  Once a server may have seen
    the request (RemoteRetryExhausted) or already responded
    (RemoteTransportError), the error propagates: re-running locally
    could duplicate output or a build's side effects."""
    try:
        return request(remote, req)
    except (RemoteTransportError, RemoteRetryExhausted):
        raise
    except RemoteUnreachable as e:
        sys.stderr.write(
            'dn: warning: serve endpoint "%s" unreachable (%s); '
            'falling back to local execution\n' % (remote, e.message))
        return None


def stats(remote, timeout_s=5.0):
    """Fetch and parse the server's /stats document (bench + tests).
    Rides the _exchange_with_retry backoff path: a transient accept
    flap must not read as a dead server."""
    rc, header, out, err = request_bytes(remote, {'op': 'stats'},
                                         timeout_s=timeout_s,
                                         retry=True)
    return json.loads(out.decode('utf-8'))


class SubscribeUnsupported(DNError):
    """The endpoint cannot serve a standing query (a v1 server, a
    pre-push v2 server, or DN_SUB_MAX=0): the caller's correct move
    is falling back to polling."""


def subscribe_stream(remote, req, timeout_s=None, resume=None):
    """Register the standing query `req` on a DEDICATED v2 connection
    and yield one dict per pushed frame: ``{'kind', 'sub', 'seq',
    'epoch', 'payload', 'token'}`` with ``payload`` always the FULL
    reconstructed result bytes (delta frames are spliced here, against
    the previous frame's payload — protocol.apply_delta).  Each data
    frame is acked before the next is read, which is the backpressure
    contract: a consumer that stops iterating stops acking, and the
    server degrades it without wedging anyone else.

    The connection is deliberately NOT the shared pool: push frames
    are server-initiated and the pool's demux treats unsolicited
    frames as protocol noise.  `resume` is (token, last_payload) from
    a previous stream's final frame; a server holding byte-identical
    state answers 'current' and resumes deltas against it with no
    re-seed.  Raises SubscribeUnsupported against a pre-push or v1
    endpoint (fallback is safe), DNError on a rejected registration,
    and RemoteTransportError when the stream dies mid-push (reconnect
    with the resume token)."""
    from . import protocol as mod_protocol
    conf = retry_conf()
    if timeout_s is None:
        timeout_s = _default_timeout_s()
    req = dict(_annotate(req), op='subscribe')
    token = payload = None
    if resume is not None:
        token, payload = resume
        req['resume'] = token
    sock = _connect(remote, timeout_s, conf['connect_timeout_s'])
    try:
        sock.sendall(mod_protocol.encode_request(req, 1))
        f = sock.makefile('rb')
        line = f.readline()
        if not line:
            raise OSError('server closed the connection before '
                          'responding')
        header = json.loads(line.decode('utf-8'))
        out = b''.join(_read_exact(f, header.get('nout', 0)))
        err = b''.join(_read_exact(f, header.get('nerr', 0)))
        if header.get('id') is None:
            # a v1 server answered (and closed): it can never push
            raise SubscribeUnsupported(
                'endpoint speaks protocol 1; subscriptions need a '
                'persistent v2 connection')
        if int(header.get('rc', 1)) != 0:
            msg = err.decode('utf-8', 'replace').strip()
            if 'unsupported request op' in msg or \
                    'subscriptions disabled' in msg:
                raise SubscribeUnsupported(msg or 'subscriptions '
                                           'unsupported')
            e = DNError(msg or 'subscribe rejected')
            e.retryable = bool(header.get('retryable'))
            raise e
        reg = json.loads(out.decode('utf-8'))
        sid = reg['sub']
        resumed = bool(reg.get('resumed'))
        if resumed and payload is not None:
            yield {'kind': 'current', 'sub': sid,
                   'seq': reg.get('seq', 0), 'epoch': reg['epoch'],
                   'payload': payload, 'token': reg.get('token')}
        else:
            payload = None        # a full seed frame is on its way
        rid = 1
        while True:
            line = f.readline()
            if not line:
                raise RemoteTransportError(
                    'subscription stream interrupted (reconnect '
                    'with the resume token)')
            header = json.loads(line.decode('utf-8'))
            body = b''.join(_read_exact(f, header.get('nout', 0)))
            b''.join(_read_exact(f, header.get('nerr', 0)))
            if mod_protocol.classify_frame(header) == 'response':
                # an ack's answer; a failed ack means the server no
                # longer knows us — resync by reconnecting
                if int(header.get('rc', 1)) != 0:
                    raise RemoteTransportError(
                        'subscription ack rejected: %s'
                        % body.decode('utf-8', 'replace').strip())
                continue
            kind = header.get('kind')
            stats = header.get('stats') or {}
            if kind == 'end':
                return
            if kind == 'delta':
                patch = stats.get('delta') or {}
                if payload is None:
                    raise RemoteTransportError(
                        'delta frame without a base payload')
                payload = mod_protocol.apply_delta(
                    payload, patch.get('off'), patch.get('keep'),
                    body)
            else:
                payload = body
            seq = header.get('seq')
            yield {'kind': kind, 'sub': sid, 'seq': seq,
                   'epoch': header.get('epoch'), 'payload': payload,
                   'token': stats.get('token')}
            rid += 1
            try:
                sock.sendall(mod_protocol.encode_request(
                    {'op': 'sub_ack', 'sub': sid, 'seq': seq}, rid))
            except OSError:
                # the server may be gone with frames still buffered
                # (a drain pushes 'end' THEN closes): the ack is
                # advisory — keep reading; the 'end' frame or EOF
                # resolves the stream
                pass
    except (OSError, ValueError) as e:
        raise RemoteTransportError(
            'subscription stream failed: %s' % e)
    finally:
        sock.close()


def health(remote, timeout_s=5.0):
    """A health probe: the parsed health document, or {'ok': False,
    'error': ...} — what a scatter-gather router polls to pick live
    replicas.  Probes ride the _exchange_with_retry backoff path: a
    single-shot probe would turn one transient accept failure into a
    'dead member' verdict — exactly wrong under a circuit breaker,
    which needs DN_ROUTER_FAILURES *post-retry* verdicts before it
    opens."""
    try:
        rc, header, out, err = request_bytes(
            remote, {'op': 'health'}, timeout_s=timeout_s,
            retry=True)
        return json.loads(out.decode('utf-8'))
    except (OSError, ValueError, DNError) as e:
        return {'ok': False, 'error': str(e)}
