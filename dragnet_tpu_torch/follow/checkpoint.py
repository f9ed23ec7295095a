"""The durable follow checkpoint: source identity + byte offset +
published-batch seq, updated atomically WITH each batch's shards.

Counterpart (a copy) of dragnet_tpu/follow/checkpoint.py.

`<indexroot>/.dn_follow/checkpoint.json` records, per source, the
file's stat identity (dev, ino) and the line-boundary byte offset
covered by every published batch, plus the monotonically increasing
batch seq.  The update never lands on its own: publisher.py writes
the new record to a journal-suffixed tmp (fsynced, like the commit
record itself) and hands it to publish_prepared's extra_paths, so it
renames into place under the SAME commit record as the batch's
shards.  Kill -9 anywhere leaves the recovery sweep exactly one
choice — roll the whole batch (shards AND checkpoint) forward, or
none of it — which is the entire exactly-once argument: the resume
offset and the published data cannot disagree.

Checkpoint-read errors on a tree that HAS follow state are fatal
(DNError), not a silent restart-from-zero: resuming at 0 over
already-published shards would duplicate every point."""

import json
import os
import time

from ..errors import DNError
from .. import faults as mod_faults
from ..index_journal import FOLLOW_DIR, _pid_alive

CHECKPOINT_VERSION = 1


class Checkpointer(object):
    def __init__(self, indexroot):
        self.indexroot = os.path.abspath(indexroot)
        self.dir = os.path.join(self.indexroot, FOLLOW_DIR)
        self.path = os.path.join(self.dir, 'checkpoint.json')

    def load(self):
        """The last committed checkpoint doc, or None when the tree
        has never been followed.  Malformed state raises DNError (see
        module docstring)."""
        try:
            with open(self.path) as f:
                doc = json.loads(f.read())
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            raise DNError('follow checkpoint "%s" unreadable: %s'
                          % (self.path, e))
        if not isinstance(doc, dict) or \
                not isinstance(doc.get('sources'), list):
            raise DNError('follow checkpoint "%s" malformed'
                          % self.path)
        return doc

    def clean_stale_tmps(self):
        """Unlink checkpoint tmps of dead writers that never reached a
        commit record (the journal sweep also quarantines these; this
        keeps the state dir tidy when no journal ever existed)."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return
        for name in names:
            if not name.startswith('checkpoint.json.'):
                continue
            parts = name.split('.')
            pid = int(parts[2]) if len(parts) > 2 and \
                parts[2].isdigit() else None
            if pid is None or _pid_alive(pid):
                continue
            try:
                os.unlink(os.path.join(self.dir, name))
            except OSError:
                pass

    def prepare(self, journal, seq, sources):
        """Write the post-batch checkpoint to the journal's tmp name
        (fsynced tmp, no rename — publish_prepared renames it with the
        shard set).  `sources` is [(path, dev, ino, offset)].  Returns
        the final path for extra_paths."""
        mod_faults.fire('follow.checkpoint')
        os.makedirs(self.dir, exist_ok=True)
        doc = {
            'version': CHECKPOINT_VERSION,
            'pid': os.getpid(),
            'seq': seq,
            'build_id': journal.build_id,
            # wall clock ON PURPOSE: a persisted
            # forensic timestamp read across processes (checkpoint
            # age in /stats), never a duration
            'time': time.time(),
            'sources': [{'path': p, 'dev': dev, 'ino': ino,
                         'offset': off}
                        for p, dev, ino, off in sources],
        }
        tmp = journal.tmp_for(self.path)
        try:
            with open(tmp, 'w') as f:
                f.write(json.dumps(doc))
                f.flush()
                os.fsync(f.fileno())
        except BaseException:
            # a half-written checkpoint tmp (ENOSPC mid-write) is
            # pre-commit litter, not recoverable intent — the retry
            # re-prepares from scratch; never strand it
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return self.path
