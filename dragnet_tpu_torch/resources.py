"""Resource-exhaustion survival: disk-space governance and the
translation of pressure errors.

Counterpart of dragnet_tpu/resources.py.  The ``ResourceGovernor``
polls statvfs over the index trees it watches (``DN_RESOURCE_POLL_MS``
cadence; on-demand reads are throttled to the same period) plus the
process fd headroom, and drives a three-state mode machine:

* ``ok``       — nothing constrained.
* ``low``      — free space under ``DN_DISK_LOW_PCT`` (or fd
  headroom under ``DN_FD_HEADROOM``): background disk consumers
  pause — `dn follow` holds its batch and checkpoint (the batch queue
  bounded), `dn rollup` and `dn compact` stop their pass.
* ``critical`` — free space under ``DN_DISK_CRITICAL_PCT``: the tree
  is read-only.  Builds, `dn index-read` and follow publishes reject
  with a retryable ``disk_full`` DNError.  Recovery is automatic: the
  next poll that sees space above the watermark returns to ``ok``.

A REAL pressure error observed at a write seam (ENOSPC/EDQUOT from
the filesystem, EMFILE/ENFILE from the fd table) feeds
``note_pressure_error``: the governor holds the matching mode for a
short window even when statvfs disagrees (quotas and fd limits are
invisible to statvfs), then re-evaluates.

``check_tree_writable`` is the one-shot write gate of the CLI's
`build` and `index-read`; ``translate_pressure_errors`` turns a
pressure OSError mid-write into that same clean DNError.  The
admission-level memory budget (``DN_SERVE_MEM_BUDGET_MB``) is the
reference's, for `dn serve`, which the port does not run yet.

Test/ops hook: ``DN_DISK_SIM_FILE`` names a file whose first line is
a simulated free-space percentage; the governor reads it instead of
statvfs on every poll.
"""

import contextlib
import errno
import os
import threading
import time

from .errors import DNError
from .vpipe import counter_bump

MODES = ('ok', 'low', 'critical')
MODE_ORD = {'ok': 0, 'low': 1, 'critical': 2}

# the pressure errnos: disk-shaped (ENOSPC, EDQUOT) flip the governor
# toward critical; fd-shaped (EMFILE, ENFILE) toward low
DISK_ERRNOS = (errno.ENOSPC, errno.EDQUOT)
FD_ERRNOS = (errno.EMFILE, errno.ENFILE)
PRESSURE_ERRNOS = DISK_ERRNOS + FD_ERRNOS

# how long an observed pressure error holds its mode past the poll
# that would otherwise clear it (statvfs cannot see quotas/fd limits)
PRESSURE_HOLD_S = 5.0

# tree-size memo TTL for footprint estimates: one os.walk per tree
# per window, not per request
_TREE_MEMO_TTL_S = 5.0


class DiskFullError(DNError):
    """The read-only rejection: clean, retryable, marked disk_full so
    response headers and retry loops can classify it.  Raised by
    check_writable (mode-driven) and by the seam wrappers translating
    a real ENOSPC."""

    def __init__(self, message, cause=None):
        super(DiskFullError, self).__init__(message, cause=cause)
        self.retryable = True
        self.disk_full = True


class MemoryBudgetError(DNError):
    """The memory-budget shed.  The serve layer re-raises it through
    its OverloadedError path with a retry_after_ms hint."""

    def __init__(self, message):
        super(MemoryBudgetError, self).__init__(message)
        self.retryable = True


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
def translate_pressure_errors(what, governor=None):
    """Convert a pressure OSError (ENOSPC/EDQUOT/EMFILE/ENFILE —
    real or fault-injected) escaping the body into the clean
    retryable disk_full DNError every error contract handles, feeding
    `governor` (when given) so the mode machine reacts immediately.
    Non-pressure OSErrors pass through untouched."""
    try:
        yield
    except OSError as e:
        if not is_pressure_error(e):
            raise
        if governor is not None:
            governor.note_pressure_error(e)
        raise DiskFullError(
            '%s failed: %s (retryable: resumes when the resource '
            'frees)' % (what, getattr(e, 'strerror', None) or str(e)))


class _NullLease(object):
    """The disabled-budget lease: free to hand out, free to release."""

    __slots__ = ()

    def release(self):
        pass


_NULL_LEASE = _NullLease()


class MemoryLease(object):
    """One admitted request's reserved footprint; release() is
    idempotent (the deadline reaper and the job thread's finally may
    both call it, like admission.Slot)."""

    __slots__ = ('_gov', '_nbytes', '_released')

    def __init__(self, gov, nbytes):
        self._gov = gov
        self._nbytes = nbytes
        self._released = False

    def release(self):
        self._gov._release_memory(self)


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


def fd_status():
    """(open_fds, soft_limit); open_fds is None where /proc is not
    available (the headroom check degrades to disabled there)."""
    limit = None
    try:
        import resource as mod_resource
        limit = mod_resource.getrlimit(mod_resource.RLIMIT_NOFILE)[0]
        if limit in (mod_resource.RLIM_INFINITY, -1):
            limit = None
    except (ImportError, OSError, ValueError):
        pass
    used = None
    try:
        used = len(os.listdir('/proc/self/fd'))
    except OSError:
        pass
    return used, limit


_TREE_MEMO_LOCK = threading.Lock()
_TREE_MEMO = {}          # abspath -> (monotonic, bytes)


def tree_bytes(path):
    """Total file bytes under `path` (a file's own size when it is
    one), memoized for _TREE_MEMO_TTL_S — the footprint estimator's
    walk must not run per request."""
    if not path:
        return 0
    key = os.path.abspath(path)
    now = time.monotonic()
    with _TREE_MEMO_LOCK:
        ent = _TREE_MEMO.get(key)
        if ent is not None and now - ent[0] < _TREE_MEMO_TTL_S:
            return ent[1]
    total = 0
    try:
        if os.path.isfile(key):
            total = os.path.getsize(key)
        else:
            for r, dirs, names in os.walk(key):
                for name in names:
                    try:
                        total += os.path.getsize(os.path.join(r, name))
                    except OSError:
                        pass
    except OSError:
        total = 0
    with _TREE_MEMO_LOCK:
        if len(_TREE_MEMO) >= 64:
            _TREE_MEMO.pop(next(iter(_TREE_MEMO)))
        _TREE_MEMO[key] = (now, total)
    return total


def reset_tree_memo():
    """Test hook."""
    with _TREE_MEMO_LOCK:
        _TREE_MEMO.clear()


def estimate_request_bytes(op, ds):
    """The admission-level footprint estimate for one data request:
    index-tree bytes for query-shaped ops, input bytes for
    scan/build-shaped ones.  Deliberately coarse and conservative —
    the budget gates CONCURRENT admissions, it is not an allocator."""
    if op in ('query', 'query_partial'):
        return tree_bytes(getattr(ds, 'ds_indexpath', None))
    if op in ('scan', 'build'):
        return tree_bytes(getattr(ds, 'ds_datapath', None))
    return 0


class ResourceGovernor(object):
    """The per-process resource-pressure state machine (module
    docstring).  `paths` is a list of directories to watch, or a
    callable returning one (the serve layer resolves its member trees
    lazily); empty falls back to the working directory."""

    def __init__(self, conf=None, paths=None, member=None):
        if conf is None:
            from . import config as mod_config
            conf = mod_config.resources_config(env={})
        if isinstance(conf, DNError):
            raise conf
        self.conf = conf
        self._paths = paths
        self.member = member
        self._lock = threading.Lock()
        self._mode = 'ok'
        self._last_poll = None       # monotonic of the last refresh
        self._last_doc = {}          # per-path disk docs
        self._fd = (None, None)
        self._forced = None          # (mode, monotonic expiry)
        self._transitions = {'to_low': 0, 'to_critical': 0,
                             'to_ok': 0}
        self._pressure_errors = 0
        # memory budget accounting
        self._mem_used = 0
        self._mem_inflight = 0
        self._mem_reservations = 0
        self._mem_sheds = 0
        self._cache_bytes = 0
        # background poll thread (serve mode); on-demand callers just
        # ride the throttled refresh
        self._stop = threading.Event()
        self._thread = None

    # -- polling ----------------------------------------------------------

    def _watch_paths(self):
        paths = self._paths() if callable(self._paths) else \
            self._paths
        out = [p for p in (paths or []) if p]
        return out or [os.getcwd()]

    def start(self):
        """Run the background poller (serve mode): gauges and mode
        transitions stay fresh even when no request arrives."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name='dn-resource-governor',
            daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def _run(self):
        period = self.conf['poll_ms'] / 1000.0
        while not self._stop.wait(period):
            try:
                self.refresh(force=True)
            except Exception:
                pass             # the governor must never kill serve

    def refresh(self, force=False):
        """One poll: statvfs every watched path, read fd headroom,
        recompute the mode, update gauges, emit transition events.
        Throttled to poll_ms unless `force`."""
        now = time.monotonic()
        with self._lock:
            if not force and self._last_poll is not None and \
                    now - self._last_poll < \
                    self.conf['poll_ms'] / 1000.0:
                return self._mode
            self._last_poll = now
        docs = {}
        worst = 'ok'
        min_free_pct = None
        min_free_bytes = None
        for path in self._watch_paths():
            st = disk_status(path)
            if st is None:
                continue
            docs[path] = st
            pct = st['free_pct']
            if min_free_pct is None or pct < min_free_pct:
                min_free_pct = pct
                min_free_bytes = st['free_bytes']
            if pct <= self.conf['disk_critical_pct']:
                worst = 'critical'
            elif pct <= self.conf['disk_low_pct'] and \
                    worst != 'critical':
                worst = 'low'
        fd_used, fd_limit = fd_status()
        headroom = self.conf['fd_headroom']
        if headroom and fd_used is not None and fd_limit and \
                fd_limit - fd_used < headroom and worst == 'ok':
            worst = 'low'
        with self._lock:
            if self._forced is not None:
                fmode, expiry = self._forced
                if now < expiry:
                    if MODE_ORD[fmode] > MODE_ORD[worst]:
                        worst = fmode
                else:
                    self._forced = None
            prior = self._mode
            self._mode = worst
            self._last_doc = docs
            self._fd = (fd_used, fd_limit)
        self._set_gauges(worst, min_free_bytes, min_free_pct, fd_used)
        if worst != prior:
            self._note_transition(prior, worst, min_free_pct)
        return worst

    def _set_gauges(self, mode, free_bytes, free_pct, fd_used):
        from .obs import metrics as obs_metrics
        reg = obs_metrics.global_registry()
        reg.set_gauge('disk_mode', MODE_ORD[mode])
        if free_bytes is not None:
            reg.set_gauge('disk_free_bytes', free_bytes)
        if free_pct is not None:
            reg.set_gauge('disk_free_pct', free_pct)
        if fd_used is not None:
            reg.set_gauge('fd_used', fd_used)
        with self._lock:
            reg.set_gauge('mem_budget_used_bytes', self._mem_used)

    def _note_transition(self, prior, mode, free_pct):
        with self._lock:
            self._transitions['to_%s' % mode] = \
                self._transitions.get('to_%s' % mode, 0) + 1
        counter_bump('resource mode transitions')
        from .obs import events as obs_events
        from .obs import metrics as obs_metrics
        obs_metrics.inc('resource_mode_transitions_total', mode=mode)
        obs_events.emit('resource.mode', frm=prior, to=mode,
                        free_pct=round(free_pct, 2)
                        if free_pct is not None else None)

    # -- the mode machine --------------------------------------------------

    def mode(self):
        """The current mode ('ok' | 'low' | 'critical'), refreshing
        on the throttled cadence."""
        return self.refresh()

    def is_read_only(self):
        return self.mode() == 'critical'

    def check_writable(self, what):
        """Gate a write-shaped op: raises the retryable disk_full
        DNError while the member is read-only."""
        if self.is_read_only():
            counter_bump('resource writes rejected')
            from .obs import metrics as obs_metrics
            obs_metrics.inc('resource_writes_rejected_total')
            raise disk_full_error(what)

    def note_pressure_error(self, e=None):
        """A REAL pressure error fired at a write seam: hold the
        matching mode for PRESSURE_HOLD_S even when statvfs disagrees
        (quota and fd exhaustion are invisible to it), then let the
        poll re-evaluate — recovery stays automatic."""
        mode = 'critical'
        if isinstance(e, OSError) and e.errno in FD_ERRNOS:
            mode = 'low'
        now = time.monotonic()
        with self._lock:
            self._pressure_errors += 1
            cur = self._forced
            if cur is None or MODE_ORD[cur[0]] <= MODE_ORD[mode]:
                self._forced = (mode, now + PRESSURE_HOLD_S)
        counter_bump('resource pressure errors')
        self.refresh(force=True)

    # -- memory budget -----------------------------------------------------

    def budget_bytes(self):
        return self.conf['mem_budget_mb'] << 20

    def admit_request(self, op, ds):
        """Memory-aware admission for one data request: estimate its
        footprint and reserve it for the request's lifetime.  Returns
        a lease (release() exactly-or-more-than once); raises
        MemoryBudgetError when the in-flight sum would exceed the
        budget (unless nothing is in flight — see module
        docstring)."""
        budget = self.budget_bytes()
        if budget <= 0:
            return _NULL_LEASE
        est = estimate_request_bytes(op, ds)
        with self._lock:
            if self._mem_inflight > 0 and \
                    self._mem_used + est > budget:
                self._mem_sheds += 1
                used, inflight = self._mem_used, self._mem_inflight
            else:
                self._mem_used += est
                self._mem_inflight += 1
                self._mem_reservations += 1
                lease = MemoryLease(self, est)
                used = None
        if used is not None:
            counter_bump('resource memory sheds')
            from .obs import events as obs_events
            obs_events.emit_burst('resource.shed', key='memory',
                                  reason='memory')
            raise MemoryBudgetError(
                'server overloaded: estimated request footprint '
                '(%d bytes) would exceed DN_SERVE_MEM_BUDGET_MB '
                '(%d in flight over %d requests); shed'
                % (est, used, inflight))
        return lease

    def _release_memory(self, lease):
        with self._lock:
            if lease._released:
                return
            lease._released = True
            self._mem_used = max(0, self._mem_used - lease._nbytes)
            self._mem_inflight = max(0, self._mem_inflight - 1)

    def reserve_cache(self, nbytes):
        """Charge result-cache residency against the same budget the
        request admission draws on, so cached bytes and in-flight
        request bytes share one accounting.  Returns False (without
        reserving) when the bytes would push the budget over — the
        cache then evicts or skips the fill.  With no memory budget
        configured the reservation always succeeds and is merely
        tracked."""
        if nbytes <= 0:
            return True
        budget = self.budget_bytes()
        with self._lock:
            if budget > 0 and self._mem_used + nbytes > budget:
                return False
            self._mem_used += nbytes
            self._cache_bytes += nbytes
        return True

    def release_cache(self, nbytes):
        if nbytes <= 0:
            return
        with self._lock:
            self._mem_used = max(0, self._mem_used - nbytes)
            self._cache_bytes = max(0, self._cache_bytes - nbytes)

    # -- reporting ---------------------------------------------------------

    def stats_doc(self):
        """The /stats `resources` section: mode, per-path disk view,
        watermarks, fd headroom, memory-budget accounting, transition
        counters."""
        with self._lock:
            docs = dict(self._last_doc)
            fd_used, fd_limit = self._fd
            forced = self._forced
            doc = {
                'mode': self._mode,
                'read_only': self._mode == 'critical',
                'watermarks': {
                    'low_pct': self.conf['disk_low_pct'],
                    'critical_pct': self.conf['disk_critical_pct']},
                'poll_ms': self.conf['poll_ms'],
                'transitions': dict(self._transitions),
                'pressure_errors': self._pressure_errors,
                'fd': {'used': fd_used, 'limit': fd_limit,
                       'headroom': self.conf['fd_headroom']},
                'memory': {
                    'budget_bytes': self.budget_bytes(),
                    'used_bytes': self._mem_used,
                    'cache_bytes': self._cache_bytes,
                    'inflight': self._mem_inflight,
                    'reservations': self._mem_reservations,
                    'sheds': self._mem_sheds},
            }
        pcts = [st['free_pct'] for st in docs.values()]
        doc['free_pct'] = round(min(pcts), 2) if pcts else None
        doc['free_bytes'] = min((st['free_bytes']
                                 for st in docs.values()),
                                default=None)
        doc['disk'] = {p: {'free_bytes': st['free_bytes'],
                           'free_pct': round(st['free_pct'], 2),
                           'total_bytes': st['total_bytes']}
                       for p, st in docs.items()}
        if forced is not None:
            doc['pressure_hold'] = forced[0]
        return doc


def check_tree_writable(indexroot, conf=None, what='build'):
    """One-shot write gate for CLI commands (`dn index-read`, local
    `dn build`): a throwaway governor over the target tree; raises
    the retryable disk_full DNError when the disk is critical."""
    gov = ResourceGovernor(conf, paths=[indexroot] if indexroot
                           else None)
    gov.check_writable(what)
