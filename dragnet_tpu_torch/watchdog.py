"""Lost-work detection at interpreter exit — the role of the
reference's premature-exit watchdog (bin/dn:1276-1311, which caught
lost-callback bugs in the event loop): resources that still hold
un-merged work when the process exits mean the printed result may be
incomplete, and that must be loud.

On detection the watchdog also dumps per-stage counters of every live
pipeline (the same format as --counters) — the reference printed
counters + debug dumps of the whole pipeline on abnormal exit
(bin/dn:1290-1311), and those dumps were its main lost-work forensics.
"""

import atexit
import sys
import weakref

# every vpipe.Pipeline registers itself here (weakly) so the watchdog
# can dump per-stage counters when it detects lost work
_PIPELINES = weakref.WeakSet()
# all LeakChecks; ONE atexit handler runs them all so the forensics
# dump appears exactly once however many checks fire
_CHECKS = []
_registered = [False]


def register_pipeline(pipeline):
    _PIPELINES.add(pipeline)


def _stage_visible(stage):
    """Same visibility rule as Stage.dump: non-zero, non-hidden."""
    return any(v != 0 and c not in stage.hidden
               for c, v in stage.counters.items())


def _dump_forensics(out):
    """Per-stage counters of every live pipeline, --counters format."""
    dumped = False
    for p in list(_PIPELINES):
        try:
            if not any(_stage_visible(s) for s in p.stages):
                continue
            if not dumped:
                out.write('premature-exit forensics: per-stage pipeline '
                          'counters follow\n')
                dumped = True
            p.dump_counters(out)
        except Exception:
            continue


def _run_checks(out=None):
    if out is None:
        out = sys.stderr
    any_leaked = False
    for check in list(_CHECKS):
        if check._report(out):
            any_leaked = True
    if any_leaked:
        _dump_forensics(out)


class LeakCheck(object):
    """Weakly tracks live resources; at interpreter exit, any tracked
    object for which `predicate` is true counts as leaked work and
    produces a premature-exit error on stderr."""

    def __init__(self, message, predicate):
        self.items = weakref.WeakSet()
        self.message = message
        self.predicate = predicate
        _CHECKS.append(self)

    def track(self, obj):
        self.items.add(obj)
        if not _registered[0]:
            _registered[0] = True
            atexit.register(_run_checks)

    def untrack(self, obj):
        self.items.discard(obj)

    def _report(self, out):
        try:
            leaked = sum(1 for o in list(self.items)
                         if self.predicate(o))
        except Exception:
            return False
        if leaked:
            out.write(
                'ERROR: internal error: premature exit (%d %s)\n'
                % (leaked, self.message))
        return bool(leaked)
