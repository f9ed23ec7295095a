"""Structured logging gated by LOG_LEVEL — the bunyan role in the
reference (bin/dn:68-71 creates the root logger with level from
LOG_LEVEL, default warn; components get child loggers, e.g.
lib/datasource-file.js:102,224,494).

Log records are bunyan-shaped JSON lines on stderr:

    {"name":"dn","component":"datasource-file","level":30,
     "msg":"scan start","time":"...","pid":...,"hostname":"...",...}

plus arbitrary structured fields per call.  The level check is a
single integer compare, so disabled levels cost nothing on hot paths;
`enabled_for()` guards any record assembly that is itself expensive.
"""

import json
import os
import socket
import sys
import time

TRACE = 10
DEBUG = 20
INFO = 30
WARN = 40
ERROR = 50
FATAL = 60

_NAMES = {'trace': TRACE, 'debug': DEBUG, 'info': INFO,
          'warn': WARN, 'error': ERROR, 'fatal': FATAL}


def _iso_now():
    t = time.time()     # one clock read: seconds and millis agree
    return time.strftime('%Y-%m-%dT%H:%M:%S', time.gmtime(t)) + \
        ('.%03dZ' % (int(t * 1000) % 1000))


def _env_level():
    """LOG_LEVEL by name or bunyan numeric value; default warn."""
    raw = (os.environ.get('LOG_LEVEL') or 'warn').strip().lower()
    if raw in _NAMES:
        return _NAMES[raw]
    try:
        return int(raw)
    except ValueError:
        return WARN


class Logger(object):
    __slots__ = ('name', 'component', 'level', 'stream', '_fields')

    def __init__(self, name='dn', component=None, level=None,
                 stream=None, fields=None):
        self.name = name
        self.component = component
        self.level = _env_level() if level is None else level
        self.stream = stream
        self._fields = fields or {}

    def child(self, component, **fields):
        """Per-component child logger (the bunyan child idiom)."""
        merged = dict(self._fields)
        merged.update(fields)
        return Logger(self.name, component=component, level=self.level,
                      stream=self.stream, fields=merged)

    def enabled_for(self, level):
        return level >= self.level

    def _log(self, level, msg, fields):
        if level < self.level:
            return
        rec = {
            'name': self.name,
            'hostname': socket.gethostname(),
            'pid': os.getpid(),
            'level': level,
            'msg': msg,
            'time': _iso_now(),
            'v': 0,
        }
        if self.component is not None:
            rec['component'] = self.component
        rec.update(self._fields)
        if fields:
            rec.update(fields)
        stream = self.stream or sys.stderr
        try:
            stream.write(json.dumps(rec, default=str) + '\n')
        except Exception:
            pass   # logging must never take the process down

    def trace(self, msg, **fields):
        self._log(TRACE, msg, fields)

    def debug(self, msg, **fields):
        self._log(DEBUG, msg, fields)

    def info(self, msg, **fields):
        self._log(INFO, msg, fields)

    def warn(self, msg, **fields):
        self._log(WARN, msg, fields)

    def error(self, msg, **fields):
        self._log(ERROR, msg, fields)

    def fatal(self, msg, **fields):
        self._log(FATAL, msg, fields)


_root = None


def root():
    global _root
    if _root is None:
        _root = Logger('dn')
    return _root


def get(component, **fields):
    """Child logger for a component (cached root; level from
    LOG_LEVEL at first use).  Extra fields ride on every record —
    `dn serve` uses this for per-request loggers (req=N)."""
    return root().child(component, **fields)
