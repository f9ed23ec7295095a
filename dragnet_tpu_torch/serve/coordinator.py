"""Dynamic-topology coordination: epoch publication, transition
lifecycle, and the member-side topology watcher.

Counterpart (a copy) of dragnet_tpu/serve/coordinator.py.  Host code.

A static cluster serves from a topology file loaded once at startup:
adding a member, widening a replica set, or draining a hot partition
meant restarting the world.  This module makes the SAME file a live
coordinator source (Diba's re-configurable dataflow: reconfiguration
as a first-class runtime operation, not a deploy):

* publish_topology() writes a validated document atomically (fsynced
  tmp + rename, the index-journal discipline) — a reader polling the
  file sees the old document or the new one, never a torn mix.
* A transition is TWO publishes.  begin_transition() writes the new
  epoch as ``state: pending`` with the last committed document
  embedded as ``prev``: every member keeps serving the committed map
  while joiners stream their newly-assigned shards from the committed
  owners (serve/rebalance.py).  commit_transition() rewrites the file
  as the committed new epoch once every pending member reports
  handoff_ready — the atomic cutover.  abort_transition() rewrites
  the committed predecessor, withdrawing the epoch.
* TopologyWatcher runs inside each `dn serve` member
  (DN_TOPO_POLL_MS > 0): it polls the file by stat identity, loads
  changed documents through the same strict validation as startup,
  and hands (committed, pending) to DnServer.apply_topology.  A
  malformed or half-visible file never takes down a member — the
  poll logs, counts an error, and retries next period.

Failure model (the acceptance bar): the only durable state is the
topology file, and every publish is atomic.  SIGKILL the coordinator
process mid-transition and the file is either still pending (every
member keeps serving the committed ``prev`` — no partition changes
owner) or already committed (the cutover happened); re-running
`dn topo commit` resumes either way.  SIGKILL a joiner and the
committed map is untouched — its restart re-reads the pending file
and re-pulls idempotently.  Stragglers that miss the commit are
covered by the topology-epoch mismatch rejection: members reject
partials from an older (or unknown) epoch retryably, and the router
re-fetches the current map and retries (serve/router.py).
"""

import json
import os
import threading
import time

from ..errors import DNError
from .. import faults as mod_faults
from ..obs import metrics as obs_metrics
from . import topology as mod_topology


def publish_topology(path, doc):
    """Atomically write a validated topology document: fsynced tmp +
    rename (a polling member sees old or new bytes, never a mix).
    Raises DNError on validation failure — a malformed document must
    never reach the file members poll."""
    err = mod_topology.validate_doc(json.loads(json.dumps(doc)))
    if err is not None:
        raise DNError('cluster topology "%s": %s' % (path, err))
    tmp = '%s.tmp.%d' % (path, os.getpid())
    data = json.dumps(doc, indent=2, sort_keys=True) + '\n'
    try:
        with open(tmp, 'w') as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)
    except OSError as e:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise DNError('cluster topology "%s": publish failed' % path,
                      cause=DNError(str(e)))


def begin_transition(path, new_doc, note=None):
    """Publish `new_doc` as the PENDING epoch of the topology at
    `path` (its epoch defaults to committed+1 when omitted; when
    given it must exceed the committed epoch).  Returns (committed,
    pending) Topology views.  Refuses while another transition is
    already pending — one epoch in flight at a time keeps the
    handoff window reasoned about."""
    committed, pending = mod_topology.load_topology_state(path)
    if pending is not None:
        raise DNError('cluster topology "%s": transition to epoch %d '
                      'already pending (commit or abort it first)'
                      % (path, pending.epoch))
    doc = dict(new_doc)
    if 'epoch' not in doc:
        doc['epoch'] = committed.epoch + 1
    doc.pop('state', None)
    doc.pop('prev', None)
    pend = dict(doc, state='pending', prev=committed.doc())
    if note is not None:
        pend['note'] = note
    publish_topology(path, pend)
    return mod_topology.load_topology_state(path)


def commit_transition(path):
    """Atomically cut the pending epoch over to committed.  Returns
    the committed Topology.  The caller is responsible for readiness
    (wait_ready) — committing under an incomplete handoff is safe but
    degrades: members reject partials for partitions whose shards are
    still streaming, retryably, until their pull completes."""
    committed, pending = mod_topology.load_topology_state(path)
    if pending is None:
        raise DNError('cluster topology "%s": no transition pending '
                      '(epoch %d is committed)' % (path,
                                                   committed.epoch))
    publish_topology(path, pending.doc())
    new_committed, _ = mod_topology.load_topology_state(path)
    return new_committed


def abort_transition(path):
    """Withdraw the pending epoch: rewrite the committed predecessor.
    Joiners' already-streamed shards are harmless litter their
    partition filters ignore."""
    committed, pending = mod_topology.load_topology_state(path)
    if pending is None:
        raise DNError('cluster topology "%s": no transition pending'
                      % path)
    publish_topology(path, committed.doc())
    return committed


def member_topology(endpoint, timeout_s=5.0):
    """One member's `topology` op document, or {'error': ...} — what
    transition_status polls for handoff readiness."""
    from . import client as mod_client
    try:
        rc, header, out, err = mod_client.request_bytes(
            endpoint, {'op': 'topology'}, timeout_s=timeout_s,
            retry=True)
        if rc != 0:
            return {'error': err.decode('utf-8', 'replace').strip()
                    or 'topology op failed'}
        return json.loads(out.decode('utf-8'))
    except (OSError, ValueError, DNError) as e:
        return {'error': str(e)}


def transition_status(path, timeout_s=5.0):
    """The transition's live view: per-pending-member epoch /
    handoff_ready, and whether the whole transition is ready to
    commit.  A member is ready once it reports the pending epoch with
    its handoff complete — or already serves an epoch >= the pending
    one (it saw the commit before we did)."""
    committed, pending = mod_topology.load_topology_state(path)
    doc = {'path': path, 'epoch': committed.epoch,
           'state': 'committed' if pending is None else 'pending',
           'pending_epoch': pending.epoch if pending is not None
           else None, 'members': {}}
    if pending is None:
        doc['ready'] = True
        return doc
    ready = True
    for name in pending.member_names():
        m = member_topology(pending.endpoint(name),
                            timeout_s=timeout_s)
        m_epoch = m.get('epoch')
        m_ready = bool(
            (isinstance(m_epoch, int) and m_epoch >= pending.epoch) or
            (m.get('pending_epoch') == pending.epoch and
             m.get('handoff_ready')))
        doc['members'][name] = {
            'ready': m_ready, 'epoch': m_epoch,
            'pending_epoch': m.get('pending_epoch'),
            'handoff': m.get('handoff'),
            'error': m.get('error')}
        ready = ready and m_ready
    doc['ready'] = ready
    return doc


def wait_ready(path, timeout_s=60.0, poll_s=0.2, probe_timeout_s=5.0):
    """Poll transition_status until every pending member is
    handoff-ready (returns the final status doc) or `timeout_s`
    expires (returns the last status with ready=False)."""
    deadline = time.monotonic() + timeout_s
    while True:
        status = transition_status(path, timeout_s=probe_timeout_s)
        if status.get('ready'):
            return status
        if time.monotonic() >= deadline:
            return status
        time.sleep(poll_s)


class TopologyWatcher(object):
    """The member-side poller: re-read the topology file every
    `poll_ms`, apply changed epochs to the server while it serves.
    poll_now() forces a synchronous poll — the router calls it when a
    member rejects a partial with an epoch mismatch (our map is
    stale; re-fetch before retrying)."""

    def __init__(self, server, path, poll_ms, log=None):
        self.server = server
        self.path = path
        self.poll_ms = poll_ms
        self.log = log
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._poll_lock = threading.Lock()
        self._ident = None
        self._lock = threading.Lock()
        self.counters = {'polls': 0, 'errors': 0, 'applied': 0}
        self._thread = None

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name='dn-topo-watch', daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(2.0)
            self._thread = None

    def _loop(self):
        period = self.poll_ms / 1000.0
        while not self._stop.is_set():
            self._wake.wait(period)
            self._wake.clear()
            if self._stop.is_set():
                return
            self.poll_now()

    def poll_now(self):
        """One synchronous poll (thread-safe; also the router's
        resync path).  Returns True when a change was applied."""
        with self._poll_lock:
            self._bump('polls')
            try:
                mod_faults.fire('topo.poll')
                st = os.stat(self.path)
                ident = (st.st_ino, st.st_mtime_ns, st.st_size)
                if ident == self._ident:
                    # unchanged file — but a transiently FAILED pull
                    # for the still-pending epoch gets another
                    # attempt each poll (a dead-then-recovered donor
                    # must not wedge the transition)
                    self.server.retry_failed_handoff()
                    return False
                committed, pending = \
                    mod_topology.load_topology_state(self.path)
            except (OSError, DNError) as e:
                # a transient read/validate failure (or an injected
                # topo.poll fault) must never take the member down:
                # keep serving the last good map, retry next period
                self._bump('errors')
                obs_metrics.inc('topo_poll_errors_total')
                if self.log is not None:
                    self.log.warn('topology poll failed', err=str(e))
                return False
            self._ident = ident
            self.server.apply_topology(committed, pending)
            self._bump('applied')
            return True

    def _bump(self, name):
        with self._lock:
            self.counters[name] += 1

    def stats(self):
        with self._lock:
            doc = dict(self.counters)
        doc['path'] = self.path
        doc['poll_ms'] = self.poll_ms
        return doc
