"""Ingest: newline-separated JSON (and json-skinner points) -> records.

Counterpart of dragnet_tpu/ingest.py.  Re-implements the reference's
parse layer (lib/format-json.js):

* the byte stream is the *concatenation* of all found files (catstreams
  semantics: a partial trailing line joins across file boundaries),
* each line is JSON-decoded; undecodable lines bump the "json parser"
  stage's "invalid json" counter and are dropped,
* format "json": each object becomes a record with weight 1
  (SkinnerAdapterStream),
* format "json-skinner": each object is already {"fields":...,"value":N}.

The iterator yields (fields_dict, value) pairs for the per-record engine
(scan.StreamScan) and the record path of the vectorized engine
(engine.DictColumns); the byte lanes (byteparse.py) take the same
line-boundary buffers (iter_line_buffers).
"""

import json

from .errors import DNError


def parser_for(fmt):
    """Validate a datasource format name.

    Contract: RETURNS (never raises) the parser token for a supported
    format, or a DNError instance for anything else — the datasource
    error-plumbing convention (create_datasource, _scan_init, and the
    find layer all return DNError for config-shaped failures and let
    the command layer raise).  Every call site must isinstance-check
    the result; tests/test_ingest.py pins both halves of the
    contract."""
    if fmt == 'json-skinner':
        return 'json-skinner'
    if fmt == 'json':
        return 'json'
    return DNError('unsupported format: "%s"' % fmt)


def open_byte_source(path, chunk_size=1 << 20):
    """THE pluggable fetcher seam: every ingest path obtains raw bytes
    as a chunk iterator of this shape — local files are the only
    built-in fetcher.  A remote-object-store backend (the reference's
    Manta listInputs/fetch, lib/datasource-manta.js:392-433) would
    plug in here by yielding fetched chunks for a remote path; today
    remote ingest is an explicit, documented non-goal
    (docs/architecture.md) and a shared filesystem is the contract."""
    with open(path, 'rb') as f:
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                break
            yield chunk


class LineAssembler(object):
    """THE chunk-boundary joiner, incremental form: feed() byte chunks
    in, get back buffers of COMPLETE lines (trailing newline
    included); a chunk ending mid-line is *held* — never emitted as a
    truncated record — until more bytes arrive or the caller flushes
    (EOF / stop).  One implementation serves the batch paths
    (iter_chunk_lines, iter_line_buffers, and through them iter_lines
    / iter_stream_lines / the raw-byte parse lanes) AND the live-tail
    path (`dn follow`'s source tailer), so the join-across-chunks
    semantics can't drift apart.

    The live-tail case is why the carry must be explicit: a growing
    file routinely ends mid-line (the appender's write() landed
    between our read()s), and a joiner that emitted the partial tail
    at iterator end would hand the parser a truncated record that the
    eventual complete line then duplicates.

    The carry between chunks is a *list* of chunk references, joined
    only when a newline finally arrives — appending chunks to a bytes
    buffer would re-copy the whole accumulated tail every read and go
    quadratic on multi-MB single-line inputs."""

    __slots__ = ('_tail', '_npending')

    def __init__(self):
        self._tail = []
        self._npending = 0

    def feed(self, chunk):
        """Absorb one chunk; returns a buffer of complete lines
        (possibly spanning the held carry), or b'' when the chunk left
        no line complete."""
        nl = chunk.rfind(b'\n')
        if nl == -1:
            if chunk:
                self._tail.append(chunk)
                self._npending += len(chunk)
            return b''
        head = chunk[:nl + 1]
        if self._tail:
            self._tail.append(head)
            head = b''.join(self._tail)
            self._tail = []
            self._npending = 0
        rest = chunk[nl + 1:]
        if rest:
            self._tail.append(rest)
            self._npending = len(rest)
        return head

    def pending(self):
        """Bytes currently held mid-line (the tailer's checkpoint
        offset is its read position minus this)."""
        return self._npending

    def flush(self):
        """Give up the held partial line (no trailing newline), or
        b''.  EOF-at-stop semantics: a file whose last line is
        unterminated still yields that line when the stream ends, just
        as the batch paths (and the reference's catstreams) do."""
        if not self._tail:
            return b''
        out = b''.join(self._tail)
        self._tail = []
        self._npending = 0
        return out


def iter_chunk_lines(chunks):
    """Yield complete lines (no newline) from an iterable of byte
    chunks, joining lines split across chunk boundaries
    (LineAssembler); a final partial line flushes last."""
    asm = LineAssembler()
    for chunk in chunks:
        buf = asm.feed(chunk)
        if buf:
            for line in buf[:-1].split(b'\n'):
                yield line
    last = asm.flush()
    if last:
        yield last


def iter_line_buffers(chunks):
    """The same joiner at buffer granularity: yield byte buffers that
    end on a line boundary (trailing newline included; a final partial
    line flushes last, without one).  This is the ingest unit of the
    columnar byte-parse lanes — one buffer per read chunk, complete
    lines only, identical carry discipline to iter_chunk_lines."""
    asm = LineAssembler()
    for chunk in chunks:
        buf = asm.feed(chunk)
        if buf:
            yield buf
    last = asm.flush()
    if last:
        yield last


def _file_chunks(paths, chunk_size):
    for path in paths:
        for chunk in open_byte_source(path, chunk_size):
            yield chunk


def iter_lines(paths, chunk_size=1 << 20):
    """Yield decoded text lines from the concatenated contents of
    paths (catstreams semantics: a partial trailing line joins across
    file boundaries)."""
    return iter_chunk_lines(_file_chunks(paths, chunk_size))


def _stream_chunks(instream, chunk_size):
    while True:
        chunk = instream.read(chunk_size)
        if not chunk:
            break
        if isinstance(chunk, str):
            chunk = chunk.encode()
        yield chunk


def iter_stream_lines(instream, chunk_size=1 << 20):
    """Yield lines from an already-open (binary or text) stream in
    bounded chunks — the stdin ingest path (`dn index-read`) must not
    materialize the whole pipe.  A trailing line without a newline is
    still yielded."""
    return iter_chunk_lines(_stream_chunks(instream, chunk_size))


def make_parser_stages(pipeline, fmt):
    """Create the parse-layer pipeline stages eagerly so --counters output
    preserves the reference's stage order (parser before scan stages)."""
    parser_stage = pipeline.stage('json parser')
    adapter_stage = pipeline.stage('SkinnerAdapterStream') \
        if fmt == 'json' else None
    return (parser_stage, adapter_stage)


def iter_records(lines, fmt, pipeline=None, stages=None):
    """Yield (fields, value) records with parse counters.

    `fmt` is 'json' or 'json-skinner'.
    """
    if stages is not None:
        parser_stage, adapter_stage = stages
    elif pipeline is not None:
        parser_stage, adapter_stage = make_parser_stages(pipeline, fmt)
    else:
        parser_stage = adapter_stage = None

    for line in lines:
        if parser_stage is not None:
            parser_stage.bump('ninputs')
        try:
            obj = json.loads(line)
        except ValueError as e:
            if parser_stage is not None:
                parser_stage.warn(e, 'invalid json')
            continue
        if parser_stage is not None:
            parser_stage.bump('noutputs')
        if fmt == 'json':
            if adapter_stage is not None:
                adapter_stage.bump('ninputs')
                adapter_stage.bump('noutputs')
            yield (obj, 1)
        else:
            yield (obj.get('fields', {}), obj.get('value'))
