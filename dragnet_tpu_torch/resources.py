"""Resource-exhaustion survival for index writes: the disk-full write
gate and the translation of pressure errors.

Counterpart of dragnet_tpu/resources.py, reduced to what `dn build`
uses (its resource governor's serve-side mode machine, memory budget
and gauges come with `dn serve`):

* ``check_tree_writable`` — the one-shot write gate of the CLI's
  `build`: a tree whose filesystem is below ``DN_DISK_CRITICAL_PCT``
  free rejects the build up front with the clean retryable disk_full
  error instead of failing mid-publish.
* ``translate_pressure_errors`` — a full disk or exhausted fd table
  mid-build (ENOSPC/EDQUOT/EMFILE/ENFILE, real or fault-injected at the
  sink/journal seams) surfaces as that same DNError, never a
  traceback; the two-phase journal already leaves the tree pre-build
  or post-build, never torn.

Test/ops hook: ``DN_DISK_SIM_FILE`` names a file whose first line is a
simulated free-space percentage, read instead of statvfs.
"""

import contextlib
import errno
import os

from .errors import DNError
from .vpipe import counter_bump

# the pressure errnos: disk-shaped (ENOSPC, EDQUOT) and fd-shaped
# (EMFILE, ENFILE)
DISK_ERRNOS = (errno.ENOSPC, errno.EDQUOT)
FD_ERRNOS = (errno.EMFILE, errno.ENFILE)
PRESSURE_ERRNOS = DISK_ERRNOS + FD_ERRNOS

class DiskFullError(DNError):
    """The read-only rejection: clean, retryable, marked disk_full so
    response headers and retry loops can classify it.  Raised by
    check_tree_writable and by translate_pressure_errors."""

    def __init__(self, message, cause=None):
        super(DiskFullError, self).__init__(message, cause=cause)
        self.retryable = True
        self.disk_full = True


def is_pressure_error(e):
    """True when `e` is resource pressure: an OSError with a pressure
    errno, or a DNError carrying the disk_full marker (a seam already
    classified it)."""
    if isinstance(e, OSError):
        return e.errno in PRESSURE_ERRNOS
    return bool(getattr(e, 'disk_full', False))


def disk_full_error(what, cause=None):
    """The shared rejection message for a write-shaped op refused (or
    failed) under disk pressure."""
    return DiskFullError('%s rejected: disk full (member is '
                         'read-only until space frees)' % what,
                         cause=cause)


@contextlib.contextmanager
def translate_pressure_errors(what):
    """Convert a pressure OSError (ENOSPC/EDQUOT/EMFILE/ENFILE —
    real or fault-injected) escaping the body into the clean
    retryable disk_full DNError every error contract handles.
    Non-pressure OSErrors pass through untouched."""
    try:
        yield
    except OSError as e:
        if not is_pressure_error(e):
            raise
        raise DiskFullError(
            '%s failed: %s (retryable: resumes when the resource '
            'frees)' % (what, getattr(e, 'strerror', None) or str(e)))


def disk_status(path, env=None):
    """{'total_bytes', 'free_bytes', 'free_pct'} for the filesystem
    holding `path` (statvfs on the nearest existing ancestor), or
    None when nothing can be statted.  DN_DISK_SIM_FILE (first line:
    a simulated free percentage) overrides for soaks/tests."""
    if env is None:
        env = os.environ
    sim = env.get('DN_DISK_SIM_FILE')
    if sim:
        try:
            with open(sim) as f:
                pct = float(f.readline().strip())
            pct = min(100.0, max(0.0, pct))
            total = 100 << 30
            return {'total_bytes': total,
                    'free_bytes': int(total * pct / 100.0),
                    'free_pct': pct, 'simulated': True}
        except (OSError, ValueError):
            pass                 # fall through to the real filesystem
    probe = os.path.abspath(path or '.')
    while probe and not os.path.exists(probe):
        parent = os.path.dirname(probe)
        if parent == probe:
            break
        probe = parent
    try:
        st = os.statvfs(probe)
    except OSError:
        return None
    total = st.f_frsize * st.f_blocks
    free = st.f_frsize * st.f_bavail
    return {'total_bytes': total, 'free_bytes': free,
            'free_pct': (100.0 * free / total) if total else 100.0}


def check_tree_writable(indexroot, conf, what='build'):
    """One-shot write gate for CLI commands (local `dn build`): raises
    the retryable disk_full DNError when the filesystem holding
    `indexroot` (the working directory when None) is at or below the
    critical free-space watermark — the read-only mode of the
    reference's resource governor.  `conf` is config.resources_config()
    output."""
    st = disk_status(indexroot or os.getcwd())
    if st is not None and st['free_pct'] <= conf['disk_critical_pct']:
        counter_bump('resource writes rejected')
        from .obs import metrics as obs_metrics
        obs_metrics.inc('resource_writes_rejected_total')
        raise disk_full_error(what)
