"""Per-stage counters and warnings for the host data pipeline.

Counterpart of dragnet_tpu/vpipe.py (its request scoping of the global
counter store, for `dn serve`, is not ported).  The reference wraps every stream
with vstream for per-stage counters and warnings (`dn --counters`;
reference: bin/dn:902-916, lib/krill-skinner-stream.js:44-48).  A
Pipeline is an ordered list of Stage objects, each with named counters
(dumped alphabetically, matching vstream's output).

Counter dump format is byte-compatible with vstream vsDumpCounters:
    name %-18s, space, counter+':' %-13s, value %8d
(measured from tests/dn golden output).

Hidden telemetry counters also land in a process-global store
(`counter_bump`): the index publish path counts its recoveries and
fault firings there.
"""

import sys
import threading

_GLOBAL_LOCK = threading.Lock()
_GLOBAL_COUNTERS = {}


def counter_bump(counter, n=1):
    """Bump a process-global telemetry counter."""
    with _GLOBAL_LOCK:
        _GLOBAL_COUNTERS[counter] = _GLOBAL_COUNTERS.get(counter, 0) + n


class Stage(object):
    def __init__(self, name, pipeline=None):
        self.name = name
        self.counters = {}
        self.hidden = set()    # telemetry counters kept out of dump()
        self.pipeline = pipeline

    def bump(self, counter, n=1):
        self.counters[counter] = self.counters.get(counter, 0) + n

    def warn(self, error, kind):
        self.bump(kind)
        if self.pipeline is not None and self.pipeline.warn_func is not None:
            self.pipeline.warn_func(self, kind, error)

    def bump_hidden(self, counter, n=1):
        """Bump a telemetry counter that stays out of the --counters
        dump (whose byte format is pinned to the reference goldens
        regardless of engine); still visible programmatically via
        Stage.counters, and mirrored into the global store."""
        self.hidden.add(counter)
        self.bump(counter, n)
        counter_bump(counter, n)

    def dump(self, out):
        # DN_COUNTERS_ALL=1 includes hidden telemetry counters (engine
        # batches, index-shard fan-out) in the --counters dump; default
        # output stays byte-pinned to the reference goldens
        import os
        show_hidden = os.environ.get('DN_COUNTERS_ALL') == '1'
        for counter in sorted(self.counters):
            value = self.counters[counter]
            if value == 0 or (counter in self.hidden
                              and not show_hidden):
                continue
            out.write('%-18s %-13s%8d\n' % (self.name, counter + ':', value))


class Pipeline(object):
    def __init__(self):
        self.stages = []
        self.warn_func = None

    def stage(self, name):
        s = Stage(name, self)
        self.stages.append(s)
        return s

    def dump_counters(self, out=None):
        if out is None:
            out = sys.stderr
        for s in self.stages:
            s.dump(out)
