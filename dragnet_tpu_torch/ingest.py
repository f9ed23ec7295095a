"""Ingest: format validation, the byte source, and the parse-layer
stages.

Counterpart of dragnet_tpu/ingest.py for the native-parser lane
(the Python record path is not ported).  Re-implements the reference's
parse layer (lib/format-json.js): the byte stream is the concatenation
of all found files; undecodable lines bump the "json parser" stage's
"invalid json" counter; format "json" records get weight 1
(SkinnerAdapterStream); "json-skinner" objects are already
{"fields":...,"value":N}.
"""

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


def make_parser_stages(pipeline, fmt):
    """Create the parse-layer pipeline stages eagerly so --counters output
    preserves the reference's stage order (parser before scan stages)."""
    parser_stage = pipeline.stage('json parser')
    adapter_stage = pipeline.stage('SkinnerAdapterStream') \
        if fmt == 'json' else None
    return (parser_stage, adapter_stage)
