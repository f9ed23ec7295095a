"""Lifecycle hygiene for `dn serve`: pidfile + socket claim/reclaim,
liveness probing, drain-time cleanup, and writer-invalidation wiring.

Startup follows the classic daemon claim protocol: a pidfile and a
socket left behind by a crashed server ("stale") must not block the
next start, but a LIVE server must — so claiming probes before
reclaiming.  A unix socket path that accepts a connection and answers
a ping belongs to a live server (claim fails); one that refuses or
times out is an orphan and is unlinked.  The pidfile is the secondary
signal: a recorded pid that no longer exists (or whose socket is
dead) is stale and reclaimed.

Writer invalidation: the index writers already invalidate the reader
caches shard-by-shard as they land (index_build_mt ->
shard_cache_invalidate, covering the `_index_write` path too).  A
resident server additionally retires whole-tree derived state on
every completed write — `install_writer_invalidation` registers an
index-write hook that sweeps the handle cache + find memo under the
written root (catching DELETED shards a per-path invalidation can
never see) and counts the event for /stats.
"""

import os

from ..errors import DNError
from ..vpipe import counter_bump


def pidfile_for(socket_path, explicit=None):
    """Default pidfile: next to the unix socket.  TCP servers have no
    socket file, so they get a pidfile only when --pidfile says so."""
    if explicit:
        return explicit
    if socket_path:
        return socket_path + '.pid'
    return None


def probe(socket_path=None, port=None, host='127.0.0.1',
          timeout_s=2.0):
    """True when a live `dn serve` answers a ping at the address."""
    from . import client as mod_client
    if socket_path is not None:
        remote = socket_path
    else:
        remote = '%s:%d' % (host, int(port))
    try:
        rc, header, out, err = mod_client.request_bytes(
            remote, {'op': 'ping'}, timeout_s=timeout_s)
        return bool(header.get('ok'))
    except (OSError, ValueError, DNError):
        return False


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return False
    return True


def claim(socket_path=None, port=None, pidfile=None, warn=None):
    """Take ownership of the serve endpoint, reclaiming stale litter.

    Raises DNError when a live server already owns it.  `warn(msg)` is
    told about each reclaimed artifact (stale pidfile, orphaned
    socket).  On success the pidfile (when any) records this pid."""
    def note(msg):
        if warn is not None:
            warn(msg)

    if pidfile and os.path.exists(pidfile):
        pid = None
        try:
            with open(pidfile) as f:
                pid = int(f.read().strip() or '0')
        except (OSError, ValueError):
            pid = None
        if pid and _pid_alive(pid) and \
                probe(socket_path=socket_path, port=port):
            raise DNError('dn serve already running (pid %d)' % pid)
        note('reclaiming stale pidfile "%s" (pid %s)'
             % (pidfile, pid if pid else 'unreadable'))
        try:
            os.unlink(pidfile)
        except OSError:
            pass

    if socket_path and os.path.exists(socket_path):
        if probe(socket_path=socket_path):
            raise DNError('dn serve already running on socket "%s"'
                          % socket_path)
        note('reclaiming orphaned socket "%s"' % socket_path)
        try:
            os.unlink(socket_path)
        except OSError as e:
            raise DNError('cannot reclaim socket "%s"' % socket_path,
                          cause=DNError(str(e)))

    if pidfile:
        try:
            with open(pidfile, 'w') as f:
                f.write('%d\n' % os.getpid())
        except OSError as e:
            raise DNError('cannot write pidfile "%s"' % pidfile,
                          cause=DNError(str(e)))


def release(socket_path=None, pidfile=None):
    """Drain-time cleanup: unlink the socket and pidfile (missing
    files are fine — release must be idempotent)."""
    for path in (socket_path, pidfile):
        if not path:
            continue
        try:
            os.unlink(path)
        except OSError:
            pass


def install_writer_invalidation():
    """Register the server's coherence hook on the index writers;
    returns the hook so the caller can unregister at drain."""
    from .. import index_build_mt as mod_ibmt
    from .. import index_query_mt as mod_iqmt

    def on_written(indexroot, paths):
        mod_iqmt.invalidate_index_tree(indexroot)
        counter_bump('index writer invalidations')

    mod_ibmt.register_index_write_hook(on_written)
    return on_written


def remove_writer_invalidation(hook):
    from .. import index_build_mt as mod_ibmt
    mod_ibmt.unregister_index_write_hook(hook)
