"""Mini-batch assembly: complete-line buffers accumulate until the
target latency or byte budget cuts a batch.

Counterpart (a copy) of dragnet_tpu/follow/batcher.py.

StreamBox-HBM (PAPERS.md) makes the case for cutting mini-batches by
a *target latency* rather than a fixed record count: under light load
a small batch publishes quickly (bounded staleness), under heavy load
the byte budget bounds memory and amortizes the per-publish cost.
Both knobs are live here: a pending batch is cut when its OLDEST
bytes reach DN_FOLLOW_LATENCY_MS of age, or earlier when
DN_FOLLOW_MAX_BYTES of pending data accumulate.

A batch always takes *everything* pending — there is no partial cut —
so the per-source line offsets snapshotted at cut time describe
exactly the bytes published so far, which is what makes the offsets
checkpointable."""

import time


class Batch(object):
    """One cut mini-batch: the concatenated complete-line bytes, the
    per-source offset snapshot to checkpoint after publish, and the
    arrival time of its oldest bytes (append-to-queryable latency is
    measured against this)."""

    __slots__ = ('data', 'offsets', 'nbytes', 'nlines', 'first_t')

    def __init__(self, data, offsets, first_t):
        self.data = data
        self.offsets = offsets
        self.nbytes = len(data)
        self.nlines = data.count(b'\n')
        self.first_t = first_t


class MiniBatcher(object):
    def __init__(self, latency_ms, max_bytes):
        self.latency_s = latency_ms / 1000.0
        self.max_bytes = max_bytes
        self._bufs = []
        self._nbytes = 0
        self._first_t = None

    def add(self, buf):
        """Absorb one complete-line buffer from a tailer poll."""
        if not buf:
            return
        if self._first_t is None:
            self._first_t = time.monotonic()
        self._bufs.append(buf)
        self._nbytes += len(buf)

    def pending_bytes(self):
        return self._nbytes

    def age_s(self):
        if self._first_t is None:
            return 0.0
        return time.monotonic() - self._first_t

    def ready(self):
        """Cut now?  Byte budget reached, or the oldest pending bytes
        hit the target latency."""
        if self._nbytes <= 0:
            return False
        if self._nbytes >= self.max_bytes:
            return True
        return self.age_s() >= self.latency_s

    def cut(self, offsets):
        """Take everything pending as one Batch; `offsets` is the
        caller's per-source {path: (dev, ino, line_off)} snapshot,
        taken AFTER the last poll that fed this batch."""
        batch = Batch(b''.join(self._bufs), offsets,
                      self._first_t or time.monotonic())
        self._bufs = []
        self._nbytes = 0
        self._first_t = None
        return batch
