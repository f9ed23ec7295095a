"""Span seams of the index build and publish path.

Counterpart of dragnet_tpu/obs/trace.py.  The reference collects a
per-request span tree when its CLI's request wrapper or `dn serve`
installs a trace context (DN_TRACE, DN_SLOW_MS, `--trace`).  The port
has neither yet (`--trace` is a usage error), so no context is ever
active and every seam takes the reference's tracing-off path: one call
and a no-op context manager.
"""


class _NullSpan(object):
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


def current_trace():
    """The active trace context: always None in the port."""
    return None


def span(name, **attrs):
    """A span under the current trace context; a no-op context manager
    when tracing is off."""
    return NULL_SPAN


def event(name, **attrs):
    """An instant event on the current span; no-op when tracing is
    off."""
