"""Source tailers: bounded reads from growing files and stdin with
rotation/truncation detection and held-partial-line assembly.

Counterpart (a copy) of dragnet_tpu/follow/tailer.py.

Each source tracks two positions:

* ``read_off``  — how many bytes have been read off the current file;
* ``line_off``  — ``read_off`` minus the bytes the LineAssembler is
  holding mid-line.  This is the only position the checkpoint may
  record: it always lands on a line boundary, so a resume re-reads
  nothing and skips nothing.

Rotation is detected the way index_query_mt's handle cache keys
shards: by stat identity (st_dev, st_ino).  When the path's identity
no longer matches the open descriptor, the old file is drained to
EOF (its trailing unterminated line, if any, is flushed as a final
record — the file is over), then the new file opens at offset 0.
In-place truncation (copytruncate rotation: same inode, size below
our read position) reopens at 0 and DROPS the held partial — the
bytes it came from no longer exist in the file.
"""

import os
import select
import sys

from ..errors import DNError
from .. import faults as mod_faults
from ..ingest import LineAssembler

STDIN = '-'


class SourceTailer(object):
    """One growing source.  poll() returns a buffer of newly completed
    lines (b'' when nothing new), advancing read_off/line_off."""

    def __init__(self, path, chunk_size=1 << 20):
        self.path = path
        self.chunk_size = chunk_size
        self.asm = LineAssembler()
        self.read_off = 0
        self.is_stdin = path == STDIN
        self.eof = False          # stdin only: the pipe closed
        self._f = None
        self.dev = 0
        self.ino = 0
        if self.is_stdin:
            self._f = getattr(sys.stdin, 'buffer', sys.stdin)

    @property
    def line_off(self):
        return self.read_off - self.asm.pending()

    # -- lifecycle --------------------------------------------------------

    def open_at(self, offset=0):
        """Open (or reopen) the file source at `offset` — resume
        entry; the caller verified the identity matches its
        checkpoint.  DNError when the file cannot be opened."""
        if self.is_stdin:
            return
        self._close()
        try:
            self._f = open(self.path, 'rb')
            st = os.fstat(self._f.fileno())
        except OSError as e:
            self._close()
            raise DNError('follow source "%s": %s' % (self.path, e))
        self.dev, self.ino = st.st_dev, st.st_ino
        if offset:
            self._f.seek(offset)
        self.read_off = offset
        self.asm = LineAssembler()

    def identity(self):
        """The path's CURRENT stat identity (dev, ino), or None when
        the file does not exist (pre-create / mid-rotation)."""
        try:
            st = os.stat(self.path)
        except OSError:
            return None
        return (st.st_dev, st.st_ino)

    def _close(self):
        if self._f is not None and not self.is_stdin:
            try:
                self._f.close()
            except OSError:
                pass
        self._f = None

    def close(self):
        self._close()

    # -- polling ----------------------------------------------------------

    def _read(self):
        mod_faults.fire('follow.read')
        try:
            return self._f.read(self.chunk_size)
        except OSError as e:
            raise DNError('follow source "%s": read: %s'
                          % (self.path, e))

    def _poll_stdin(self):
        """Bounded stdin read: select() first, so an idle pipe never
        wedges the loop (a blocking BufferedReader.read(n) would sit
        until n bytes or EOF, breaking the latency target AND the
        SIGTERM drain).  os.read returns whatever is available."""
        if self.eof:
            return b''
        try:
            fd = self._f.fileno()
        except (OSError, ValueError, AttributeError):
            fd = None
        if fd is None:
            chunk = self._read()     # test doubles without a real fd
        else:
            try:
                ready, _, _ = select.select([fd], [], [], 0)
            except (OSError, ValueError):
                ready = [fd]
            if not ready:
                return b''
            mod_faults.fire('follow.read')
            try:
                chunk = os.read(fd, self.chunk_size)
            except OSError as e:
                raise DNError('follow source "%s": read: %s'
                              % (self.path, e))
        if not chunk:
            self.eof = True
            return b''
        if isinstance(chunk, str):
            chunk = chunk.encode()
        self.read_off += len(chunk)
        return self.asm.feed(chunk)

    def poll(self):
        """Read whatever new bytes the source has; returns a buffer of
        complete lines (b'' when none completed).  Handles
        create-late, rotation, and truncation."""
        if self.is_stdin:
            return self._poll_stdin()
        if self._f is None:
            if self.identity() is None:
                return b''           # not created yet
            self.open_at(0)

        out = []
        # truncation is a STATE check (size fell below our position),
        # not something inferred from a failed read — test it before
        # reading.  A truncate-then-regrow that passes read_off
        # between two polls is stat-invisible (the copytruncate
        # hazard every stat-based tailer shares — the next read hands
        # back new content spliced at the old offset); rename
        # rotation has no such hole.
        try:
            size = os.fstat(self._f.fileno()).st_size
        except OSError:
            size = self.read_off
        if size < self.read_off:
            # truncated in place: the held partial's bytes are gone
            # from the file — drop them and start over
            self.open_at(0)
        chunk = self._read()
        if chunk:
            self.read_off += len(chunk)
            buf = self.asm.feed(chunk)
            if buf:
                out.append(buf)
        else:
            # at EOF: check for rotation
            ident = self.identity()
            if ident is not None and ident != (self.dev, self.ino):
                # rotated: drain the old descriptor (already at EOF —
                # the read above returned b''), flush its tail as the
                # file's final record, and switch to the new file
                tail = self.asm.flush()
                if tail:
                    # the tail bytes were already counted in read_off;
                    # flushing just released them to line_off
                    out.append(tail + b'\n')
                try:
                    self.open_at(0)
                    buf = self.poll()
                    if buf:
                        out.append(buf)
                except DNError:
                    # the flushed tail must not be lost to a transient
                    # open/read failure on the NEW file: return what
                    # we have; the closed descriptor makes the next
                    # poll retry the open (at offset 0) cleanly
                    pass
        return b''.join(out)

    def flush_tail(self):
        """Emit the held partial line as a final record (newline-
        terminated for the batch buffer) and advance line_off past
        it.  Only for sources that are OVER: stdin at stop (no
        resume), and a rotated-away file (handled inside poll).  A
        live file's partial stays held — it may be mid-write, and a
        checkpoint past it could never be resumed exactly."""
        tail = self.asm.flush()
        if not tail:
            return b''
        return tail + b'\n'
