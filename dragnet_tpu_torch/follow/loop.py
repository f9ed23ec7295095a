"""The `dn follow` daemon loop: poll sources -> cut mini-batches ->
scan -> merge-publish -> checkpoint, forever (or --once: catch up to
current EOF and exit).

Counterpart of dragnet_tpu/follow/loop.py.  Each mini-batch is scanned
by the port's build path on the engine and device the caller resolved
(the CLI passes DN_ENGINE and DN_TORCH_DEVICE as it does for `dn
build`): under DN_ENGINE=jax every batch folds through the stacked
device scan (DeviceScanStack, with the one-hot kernel for small dense
metrics); under the default auto a mini-batch is far below the
escalation point and stays on the host engine, as in bin/dn.

Failure discipline: a failed publish keeps the cut batch pending and
retries with backoff — nothing landed (pre-commit failures abort
their tmps; post-commit failures leave recoverable intent the retry
completes and then skips via the checkpoint seq), so a retry is
exact.  Disk pressure pauses publishing with the checkpoint held.  A
fault of the device lane is NOT a publish failure: the reference's
device lane falls back to its host engine and so never raises there,
while the port's raises on purpose (no silent host route), and a
daemon that retried it would spin on a broken card.  A scan on the
device lane that raises (probe, kernel, staging, fetch) ends the loop
with a DeviceLaneError; nothing of that batch landed, so the
checkpoint stands at the last good batch and a restarted follower
re-reads the batch exactly once.  A SIGTERM/SIGINT drain publishes the
final batch and exits only once the checkpoint covers every published
byte; a held partial line stays held for resumable files (it may
still be mid-write — only stdin, which cannot resume, flushes it at
stop).

Telemetry: follow_* counters/gauges/histograms in the metrics
registry (obs/metrics.py), follow.scan / follow.publish stages
(`follow_scan_ms`, `follow_publish_ms`), and the process-wide `follow`
stats section (stats_doc below)."""

import json
import os
import signal
import sys
import threading
import time

from ..errors import DNError
from .. import jsvalues as jsv
from ..datasource_file import DatasourceFile
from ..obs import events as obs_events
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..vpipe import counter_bump
from .. import index_journal as mod_journal
from .. import resources as mod_resources
from .batcher import MiniBatcher
from .checkpoint import Checkpointer
from .publisher import merge_publish
from .tailer import STDIN, SourceTailer

_STATS_LOCK = threading.Lock()
_STATS = None                 # the live FollowLoop's stats snapshot


def stats_doc():
    """The `follow` stats section (None when no follow loop ever ran
    in this process) — the reference's `dn serve` /stats and `dn
    stats` embed it."""
    with _STATS_LOCK:
        return dict(_STATS) if _STATS is not None else None


def _publish_stats(doc):
    global _STATS
    with _STATS_LOCK:
        _STATS = doc


class DeviceLaneError(DNError):
    """A mini-batch's scan failed on the device lane: fatal to the
    loop, never retried as a publish failure (module docstring)."""


# the engines whose scan can run on the device (datasource_file.ENGINES)
DEVICE_ENGINES = ('device', 'auto')


class FollowLoop(object):
    # consecutive publish failures tolerated while draining before
    # giving up with an error (a fault-armed soak must not wedge the
    # drain forever)
    DRAIN_PUBLISH_RETRIES = 3
    # consecutive all-error zero-byte poll passes tolerated in --once
    # before draining with exit code 1 instead of claiming caught-up
    ONCE_POLL_RETRIES = 5
    # disk-pressure pauses tolerated while DRAINING before giving up
    # (a transient full disk must not turn a drain into rc=1, but an
    # operator's SIGTERM must still win against a permanently full
    # one) — deliberately larger than the failure-streak budget:
    # pauses are EXPECTED under pressure, failures are not
    DRAIN_PAUSE_RETRIES = 10
    # publish-pause backoff ceiling (seconds)
    PAUSE_BACKOFF_MAX_S = 5.0
    # while paused, sources keep tailing only until the pending queue
    # holds this many mini-batches' worth of bytes — the follower
    # must not become its own memory exhaustion under a full disk
    PAUSE_QUEUE_BATCHES = 4

    def __init__(self, ds, metrics, interval, sources, conf,
                 once=False, warn=None, device=None, engine='device'):
        self.ds = ds
        # the scan's device and engine (DatasourceFile.index_scan's own
        # arguments; the CLI passes DN_TORCH_DEVICE and DN_ENGINE)
        self.device = device
        self.engine = engine
        self.metrics = metrics
        self.interval = interval
        self.conf = conf
        self.once = once
        self.warn = warn or (lambda msg: sys.stderr.write(
            'dn follow: %s\n' % msg))
        self.indexroot = ds.ds_indexpath
        self.ckpt = Checkpointer(self.indexroot)
        self.spool_path = os.path.join(self.ckpt.dir, 'spool.json')
        # the spool datasource: the batch bytes as a one-file corpus
        # under the follow datasource's format/timefield/filter — the
        # scan path (byteparse lanes included) is the build's own
        self.spool_ds = DatasourceFile({
            'ds_backend_config': {'path': self.spool_path,
                                  'indexPath': None,
                                  'timeFormat': None,
                                  'timeField': ds.ds_timefield},
            'ds_format': ds.ds_format,
            'ds_filter': ds.ds_filter,
        })
        self.batcher = MiniBatcher(conf['latency_ms'],
                                   conf['max_bytes'])
        self.tailers = [SourceTailer(p) for p in sources]
        self.seq = 0
        self.batches = 0
        self.records = 0
        self.nbytes = 0
        self.ckpt_wall = None
        self.lag_ms = 0.0
        self._stop = threading.Event()
        # resource governance (resources.py): low/critical disk
        # pressure PAUSES publishing — checkpoint held, sources keep
        # tailing into the bounded queue, automatic resume when space
        # frees — instead of burning the failure streak on a
        # transient full disk
        from .. import config as mod_config
        res_conf = mod_config.resources_config()
        if isinstance(res_conf, DNError):
            # the CLI validates up front; an embedder's bad env must
            # not crash the loop — fall back to defaults
            res_conf = mod_config.resources_config(env={})
        self.governor = mod_resources.ResourceGovernor(
            res_conf, paths=[self.indexroot])
        self.pauses = 0

    def request_stop(self):
        self._stop.set()

    # -- resume -----------------------------------------------------------

    def resume(self):
        """Recover the tree (roll any dead batch forward/back), then
        position every tailer from the committed checkpoint: matching
        identity resumes at its offset; a changed identity (rotated
        while down) or a fresh source starts at 0."""
        mod_journal.sweep_index_tree(self.indexroot)
        os.makedirs(self.ckpt.dir, exist_ok=True)
        self.ckpt.clean_stale_tmps()
        doc = self.ckpt.load()
        bysrc = {}
        if doc is not None:
            self.seq = int(doc.get('seq') or 0)
            self.ckpt_wall = doc.get('time')
            bysrc = {s.get('path'): s for s in doc['sources']}
        for t in self.tailers:
            if t.is_stdin:
                if bysrc.get(STDIN):
                    self.warn('stdin source cannot resume from a '
                              'checkpoint; reading from the current '
                              'position')
                continue
            ent = bysrc.get(t.path)
            ident = t.identity()
            if ident is None:
                continue             # created later; opens lazily
            if ent is not None and ident == (ent.get('dev'),
                                             ent.get('ino')):
                t.open_at(int(ent.get('offset') or 0))
            else:
                if ent is not None:
                    self.warn('source "%s" rotated while down; '
                              'restarting from offset 0' % t.path)
                t.open_at(0)

    # -- one batch --------------------------------------------------------

    def _offsets(self):
        return [(t.path, t.dev, t.ino, t.line_off)
                for t in self.tailers]

    def _scan(self, batch):
        """The batch through the build's own scan path: spool file +
        index_scan -> tagged aggregated points.  A failure of a scan
        that may run on the device (the port's DNError, or a CUDA
        error torch raises as RuntimeError) raises DeviceLaneError
        (module docstring); disk pressure and OSErrors pass through to
        the publish discipline."""
        with open(self.spool_path + '.w', 'wb') as f:
            f.write(batch.data)
        os.replace(self.spool_path + '.w', self.spool_path)
        try:
            result = self.spool_ds.index_scan(
                self.metrics, self.interval, filter=self.ds.ds_filter,
                device=self.device, engine=self.engine)
        except (DNError, RuntimeError) as e:
            if not self._device_lane() or \
                    mod_resources.is_pressure_error(e):
                raise
            counter_bump('follow device lane faults')
            obs_metrics.inc('follow_device_faults_total')
            raise DeviceLaneError(
                'mini-batch %d (%d records) failed on the device lane'
                % (self.seq + 1, batch.nlines), cause=e)
        return result.points or []

    def _device_lane(self):
        """Whether this loop's scans may run on the device: a device
        engine, or the byte lane's device parse (DN_PARSE=device)."""
        return self.engine in DEVICE_ENGINES or \
            os.environ.get('DN_PARSE') == 'device'

    def publish_batch(self, batch, recover=True):
        """Scan + merge-publish + checkpoint one batch (raises on
        failure with nothing landed or recoverable intent only).
        `recover=False` skips merge_publish's sweep/own-journal
        recovery — the loop passes it on the clean path (resume()
        already swept; see publisher.merge_publish)."""
        with obs_metrics.timed_stage('follow.scan',
                                     metric='follow_scan_ms',
                                     labels={},
                                     nbytes=batch.nbytes):
            tagged = self._scan(batch)
        new_seq = self.seq + 1
        sources = [(p, dev, ino, off)
                   for p, dev, ino, off in batch.offsets]
        with obs_metrics.timed_stage('follow.publish',
                                     metric='follow_publish_ms',
                                     labels={},
                                     npoints=len(tagged)):
            paths = merge_publish(self.metrics, self.interval,
                                  self.indexroot, self.ds.ds_timefield,
                                  tagged, self.ckpt, new_seq, sources,
                                  recover=recover,
                                  append=bool(
                                      self.conf.get('append')))
        self.seq = new_seq
        self.batches += 1
        self.records += batch.nlines
        self.nbytes += batch.nbytes
        self.ckpt_wall = time.time()
        counter_bump('follow batches published')
        counter_bump('follow records ingested', batch.nlines)
        obs_metrics.inc('follow_batches_total')
        obs_metrics.inc('follow_records_total', batch.nlines)
        obs_metrics.inc('follow_bytes_total', batch.nbytes)
        obs_metrics.inc('follow_shards_published_total', len(paths))
        obs_metrics.observe(
            'follow_append_to_queryable_ms',
            (time.monotonic() - batch.first_t) * 1000.0)
        newest_ms = self._batch_newest_ms(batch)
        if newest_ms is not None:
            self.lag_ms = max(0.0, time.time() * 1000.0 - newest_ms)
            obs_metrics.set_gauge('follow_ingest_lag_ms', self.lag_ms)

    def _batch_newest_ms(self, batch):
        """The raw timefield of the batch's LAST complete record (ms
        since epoch), or None.  Log streams are near time-ordered, so
        the final record approximates the newest — and unlike the
        aggregated points' __dn_ts (quantized to the BUCKET start, up
        to a full day early), it is an actual record timestamp the
        ingest-lag gauge can honestly compare to the wall clock."""
        timefield = getattr(self.ds, 'ds_timefield', None)
        if not timefield:
            return None
        data = batch.data
        end = data.rfind(b'\n')
        if end <= 0:
            return None
        start = data.rfind(b'\n', 0, end) + 1
        try:
            rec = json.loads(data[start:end])
        except (ValueError, UnicodeDecodeError):
            return None
        v = jsv.pluck(rec, timefield)
        if isinstance(v, bool):
            return None
        if isinstance(v, (int, float)):
            return float(v) * 1000.0     # epoch seconds, like __dn_ts
        return jsv.date_parse(v)

    # -- telemetry --------------------------------------------------------

    def _refresh_stats(self):
        now = time.time()
        age = round(now - self.ckpt_wall, 3) \
            if self.ckpt_wall is not None else None
        srcs = []
        for t in self.tailers:
            srcs.append({'path': t.path, 'offset': t.line_off,
                         'dev': t.dev, 'ino': t.ino})
            obs_metrics.set_gauge('follow_source_offset',
                                  t.line_off, source=t.path)
        if age is not None:
            obs_metrics.set_gauge('follow_checkpoint_age_s', age)
        _publish_stats({
            'seq': self.seq,
            'batches_published': self.batches,
            'records': self.records,
            'bytes': self.nbytes,
            'pending_bytes': self.batcher.pending_bytes(),
            'checkpoint_age_s': age,
            'ingest_lag_ms': round(self.lag_ms, 3),
            'publish_pauses': self.pauses,
            'sources': srcs,
        })

    # -- the loop ---------------------------------------------------------

    def _poll_all(self):
        """One pass over every source; returns (bytes READ, sources
        that errored).  Bytes read, not bytes completed — the idle
        test must see mid-line progress too."""
        pre = sum(t.read_off for t in self.tailers)
        errs = 0
        for t in self.tailers:
            try:
                buf = t.poll()
            except DNError as e:
                self.warn(str(getattr(e, 'message', e)))
                errs += 1
                continue
            if buf:
                self.batcher.add(buf)
        return sum(t.read_off for t in self.tailers) - pre, errs

    def _note_pause(self, stopping, why):
        """One disk-pressure pause tick: counted, surfaced, bounded
        backoff (the checkpoint is HELD — nothing published, nothing
        lost; the retry is exact)."""
        self.pauses += 1
        counter_bump('follow publishes paused')
        obs_metrics.inc('follow_publish_pauses_total')
        obs_events.emit_burst('resource.paused', key='follow',
                             component='follow', why=why)
        if self.pauses == 1 or stopping:
            self.warn('publish paused: %s (checkpoint held; '
                      'resuming when the resource frees)' % why)
        delay = min(self.PAUSE_BACKOFF_MAX_S,
                    (self.conf['poll_ms'] / 1000.0) *
                    max(1, self.pauses))
        if self._stop.is_set():
            # draining: _stop is already set, so waiting on it would
            # return instantly and burn every DRAIN_PAUSE_RETRIES in
            # milliseconds — the pause must really pace the drain
            time.sleep(delay)
        else:
            self._stop.wait(delay)

    def run(self):
        with obs_trace.span('follow.resume'):
            self.resume()
        self._refresh_stats()
        poll_s = self.conf['poll_ms'] / 1000.0
        pause_cap = self.PAUSE_QUEUE_BATCHES * self.conf['max_bytes']
        pending = None
        fails = 0
        drain_pauses = 0
        attempt_recover = False
        poll_fails = 0
        once_rc = 0
        draining = False
        while True:
            stopping = self._stop.is_set() or draining
            paused = self.governor.mode() != 'ok'
            got = errs = 0
            if not stopping and not (paused and
                                     self.batcher.pending_bytes() >=
                                     pause_cap):
                # under pressure the sources keep tailing only until
                # the pending queue holds PAUSE_QUEUE_BATCHES batches
                # of bytes — bounded, like everything else here
                got, errs = self._poll_all()
            if self.once and not stopping:
                # --once promises "ingest to the sources' current
                # EOF": a pass that read nothing because a source
                # ERRORED is not caught up — retry (the poll wait at
                # the bottom paces it) up to a bounded streak, then
                # drain what we have and exit non-zero
                if errs and not got:
                    poll_fails += 1
                    if poll_fails >= self.ONCE_POLL_RETRIES:
                        self.warn('giving up on --once catch-up '
                                  'after %d failed poll passes'
                                  % poll_fails)
                        once_rc = 1
                        stopping = True
                elif got:
                    poll_fails = 0
                if not got and not errs:
                    # caught up: one full pass read nothing new.
                    # Enter the drain even with a batch pending — the
                    # drain publishes it (or gives up at the retry
                    # cap); gating on pending would retry a failing
                    # publish forever
                    stopping = True
            if stopping and not draining:
                # `draining` is sticky so a --once publish-failure
                # streak still reaches the retry cap below.  EOF-at-
                # stop flushes only sources that cannot resume (stdin
                # has no durable identity): a regular file's held
                # partial line may still be MID-WRITE — it stays
                # held, the checkpoint stays on a line boundary, and
                # a restarted follower parses the completed line
                # exactly once
                draining = True
                for t in self.tailers:
                    if t.is_stdin:
                        tail = t.flush_tail()
                        if tail:
                            self.batcher.add(tail)
            if pending is None and \
                    (self.batcher.ready() or
                     (stopping and self.batcher.pending_bytes() > 0)):
                pending = self.batcher.cut(self._offsets())
            if pending is not None and paused and not stopping:
                # pressure pause: hold the batch (and its checkpoint)
                # without even attempting the publish — hammering a
                # known-full disk buys nothing, and every attempt is
                # an abort/retry cycle
                self._note_pause(stopping,
                                 'disk %s' % self.governor.mode())
            elif pending is not None:
                try:
                    # recovery only on a retry: a failed previous
                    # attempt is the one in-process way journal
                    # intent can be left on this single-writer tree
                    self.publish_batch(pending,
                                       recover=attempt_recover)
                    pending = None
                    fails = 0
                    drain_pauses = 0
                    attempt_recover = False
                    if self.pauses:
                        self.pauses = 0
                        self.warn('publish resumed')
                except DeviceLaneError:
                    # not retried: the batch stays unpublished and the
                    # checkpoint at the last good batch
                    self._refresh_stats()
                    raise
                except (DNError, OSError) as e:
                    attempt_recover = True
                    if mod_resources.is_pressure_error(e):
                        # ENOSPC/EMFILE is PAUSABLE, not a failure:
                        # the checkpoint is held, nothing landed (or
                        # recoverable intent only — the retry
                        # completes it), and the streak that would
                        # end a drain with rc=1 is not burned on a
                        # transient full disk
                        self.governor.note_pressure_error(
                            e if isinstance(e, OSError) else None)
                        if stopping:
                            drain_pauses += 1
                            if drain_pauses >= \
                                    self.DRAIN_PAUSE_RETRIES:
                                self.warn(
                                    'giving up on the drain: disk '
                                    'pressure outlasted %d pause(s)'
                                    % drain_pauses)
                                self._refresh_stats()
                                return 1
                        self._note_pause(
                            stopping, str(getattr(e, 'message',
                                                  None) or e))
                    elif isinstance(e, OSError):
                        raise
                    else:
                        fails += 1
                        self.warn('publish failed (attempt %d): %s'
                                  % (fails, getattr(e, 'message', e)))
                        if stopping and \
                                fails >= self.DRAIN_PUBLISH_RETRIES:
                            self._refresh_stats()
                            return 1
                        time.sleep(min(2.0, poll_s * fails))
            self._refresh_stats()
            if stopping and pending is None and \
                    self.batcher.pending_bytes() == 0:
                return once_rc
            if not got and pending is None and not stopping:
                self._stop.wait(poll_s)


def follow_main(ds, metrics, interval, sources, conf, once=False,
                device=None, engine='device'):
    """CLI entry: run the loop until drained (or caught up with
    --once).  Returns the process exit code; a device-lane fault
    raises DeviceLaneError (the CLI reports it and exits 1)."""
    loop = FollowLoop(ds, metrics, interval, sources, conf, once=once,
                      device=device, engine=engine)
    if not once:
        def on_signal(signo, frame):
            loop.request_stop()
        try:
            signal.signal(signal.SIGTERM, on_signal)
            signal.signal(signal.SIGINT, on_signal)
        except ValueError:
            pass                 # not the main thread (tests)
        sys.stderr.write(
            'dn follow: following %d source(s) -> %s (pid %d)\n'
            % (len(sources), ds.ds_indexpath, os.getpid()))
    rc = loop.run()
    if not once:
        sys.stderr.write('dn follow: drained; exiting\n')
    return rc
