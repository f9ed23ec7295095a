"""VError-style error chaining: messages compose as "outer: inner".

The reference chains errors with verror's VError(cause, fmt, ...), producing
messages like `invalid query: invalid filter: unknown operator "junk"`
(reference: lib/dragnet.js:118-119).  DNError reproduces that composition so
CLI error output matches byte-for-byte.
"""


class DNError(Exception):
    def __init__(self, message, cause=None):
        if cause is not None:
            cmsg = cause.args[0] if cause.args else str(cause)
            message = '%s: %s' % (message, cmsg)
        super(DNError, self).__init__(message)

    @property
    def message(self):
        return self.args[0]
