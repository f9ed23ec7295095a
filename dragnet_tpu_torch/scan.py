"""The per-record scan operator: filter -> synthetic date fields ->
time bounds -> aggregate.

Counterpart of dragnet_tpu/scan.py, the reference's StreamScan pipeline
(lib/stream-scan.js:40-96) with stage order and counter semantics
preserved:

    [Datasource filter] -> [User filter] -> [Datetime parser] ->
    [Time filter] -> [Aggregator]

Per-record fault tolerance matches the reference: filter-eval failures
(missing fields) drop the record with an `nfailedeval` warning; filtered
records bump `nfilteredout`; unparseable/missing date fields drop with
`baddate`/`undef` warnings (lib/stream-synthetic.js:43-80,
lib/krill-skinner-stream.js:29-52).

The vectorized engines (engine.py on the host, device_scan.py on the
card) execute the same operator graph over columnar batches; this
module is the semantic definition, and the engine of DN_ENGINE=host and
of `--warnings` (ordered per-record warnings).
"""

from . import jsvalues as jsv
from . import krill as mod_krill
from . import query as mod_query
from .aggr import Aggregator


class FilterStage(object):
    def __init__(self, predicate, stage):
        self.predicate = predicate
        self.stage = stage

    def accept(self, fields):
        self.stage.bump('ninputs')
        try:
            result = self.predicate.eval_(fields)
        except mod_krill.EvalError as e:
            self.stage.warn(e, 'nfailedeval')
            return False
        except Exception as e:  # JS comparison never throws; be safe
            self.stage.warn(e, 'nfailedeval')
            return False
        if result:
            self.stage.bump('noutputs')
            return True
        self.stage.bump('nfilteredout')
        return False


class SyntheticStage(object):
    """Materializes date-typed fields: ISO-8601 string -> unix seconds;
    numbers pass through.  (reference: lib/stream-synthetic.js:20-85)"""

    def __init__(self, synthetic, stage):
        self.synthetic = synthetic
        self.stage = stage

    def accept(self, fields):
        self.stage.bump('ninputs')
        nerrors = 0
        for fieldconf in self.synthetic:
            val = jsv.pluck(fields, fieldconf['field'])
            if val is jsv.UNDEFINED:
                if nerrors == 0:
                    self.stage.warn(
                        ValueError('field "%s" is undefined'
                                   % fieldconf['field']), 'undef')
                nerrors += 1
                continue
            if jsv.is_number(val):
                fields[fieldconf['name']] = val
                continue
            parsed = jsv.date_parse(val)
            if parsed is None:
                if nerrors == 0:
                    self.stage.warn(
                        ValueError('field "%s" is not a valid date'
                                   % fieldconf['field']), 'baddate')
                nerrors += 1
                continue
            fields[fieldconf['name']] = parsed // 1000
        if nerrors == 0:
            self.stage.bump('noutputs')
            return True
        return False


class StreamScan(object):
    """Composes the per-record operator chain for one query."""

    def __init__(self, query, time_field, pipeline, ds_filter=None):
        self.query = query
        self.stages = []

        if ds_filter is not None:
            pred = mod_krill.create(ds_filter)
            self.stages.append(FilterStage(
                pred, pipeline.stage('Datasource filter')))

        if query.qc_filter is not None:
            pred = mod_krill.create(query.qc_filter)
            self.stages.append(FilterStage(
                pred, pipeline.stage('User filter')))

        synthetic = list(query.qc_synthetic)
        if query.qc_before is not None or query.qc_after is not None:
            assert isinstance(time_field, str)
            synthetic.append({
                'name': 'dn_ts',
                'field': time_field,
                'date': '',
            })

        if synthetic:
            self.stages.append(SyntheticStage(
                synthetic, pipeline.stage('Datetime parser')))

        tfilter = mod_query.query_time_bounds_filter(query, 'dn_ts')
        if tfilter is not None:
            self.stages.append(FilterStage(
                mod_krill.create(tfilter), pipeline.stage('Time filter')))

        self.aggr = Aggregator(query, stage=pipeline.stage('Aggregator'))

    def write(self, fields, value):
        for s in self.stages:
            if not s.accept(fields):
                return
        self.aggr.write(fields, value)
