"""`dn subscribe` of the port (dragnet_tpu_torch/serve/subscribe.py) on
the CPU, held against the JAX package.

The port's server runs in this process (so the port's CLI builds fire
its index write hook); the JAX package's server runs as a `bin/dn
serve` subprocess over the same trees (so it sees every publish as a
cross-process write, through its revalidation tick), and the JAX
package's local CLI answers the polls it is held to.  Covered, as the
JAX package's tests/test_subscribe.py has them for a single member:
the contract (a pushed frame at epoch E is byte-identical to a poll at
epoch E and to the JAX package's frame and poll: seed, post-publish
push and delta-reconstructed frames, both index formats), one
recompute for eight subscribers, incremental fold reuse, a stalled
subscriber shedding while a healthy one delivers, resume tokens,
unsubscribe, the drain's `end` frame, the disabled and limit
rejections, the fleet watch, the /stats section, `dn subscribe` JSONL,
`dn top --subscribe` and its polling fallback, the push codec against
the reference's on drawn byte strings, the write hook for the stacked
device build and `follow`, a publish from another process, and the
routed groups of a cluster member (one scatter per publish through
serve/router.py, and the confirming scatter past the peers' stat-TTL
window).
"""

import datetime
import io
import json
import os
import signal
import socket as mod_socket
import subprocess
import sys
import threading
import time

import pytest
from hypothesis import given, settings, strategies as st

from dragnet_tpu import cli as jcli
from dragnet_tpu.serve import client as jclient
from dragnet_tpu.serve import fleet as jfleet
from dragnet_tpu.serve import protocol as jprotocol
from dragnet_tpu.serve import server as jserver
from dragnet_tpu_torch import cli as tcli
from dragnet_tpu_torch import index_build_mt as tbuild
from dragnet_tpu_torch import index_query_mt as tiqmt
from dragnet_tpu_torch.errors import DNError
from dragnet_tpu_torch.serve import client as tclient
from dragnet_tpu_torch.serve import fleet as tfleet
from dragnet_tpu_torch.serve import lifecycle as tlifecycle
from dragnet_tpu_torch.serve import protocol as tprotocol
from dragnet_tpu_torch.serve import server as tserver
from dragnet_tpu_torch.serve import top as ttop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1388534400  # 2014-01-01T00:00:00Z
DSS = ('ds_dnc', 'ds_sq')
# every wait on the servers polls a condition against this deadline
WAIT_S = 60.0


def run_port(args):
    """One in-process run of the port's CLI, its output captured through
    the port's thread-stdio router."""
    with tserver.thread_stdio() as cap:
        rc = tcli.main(list(args))
    out, err = cap.finish()
    return rc, out, err


def run_ref(args):
    """One in-process run of the JAX package's CLI under its own router;
    the process streams are restored after it, so the two routers never
    stack."""
    saved = sys.stdout, sys.stderr
    try:
        with jserver.thread_stdio() as cap:
            rc = jcli.main(list(args))
        out, err = cap.finish()
    finally:
        sys.stdout, sys.stderr = saved
    return rc, out, err


def _append(datafile, n, start):
    """Append n deterministic records continuing the corpus clock."""
    with open(datafile, 'a') as f:
        for i in range(start, start + n):
            ts = datetime.datetime.fromtimestamp(
                T0 + i * 800, datetime.timezone.utc).strftime(
                    '%Y-%m-%dT%H:%M:%S.000Z')
            f.write(json.dumps({
                'time': ts,
                'host': 'host%d' % (i % 3),
                'operation': ('get', 'put', 'index')[i % 3],
                'latency': (i * 7) % 230,
            }, separators=(',', ':')) + '\n')


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """A GROWING corpus: each datasource owns its datafile and tree
    (ds_dnc dnc, ds_sq sqlite), built by the port's CLI; publishes
    append records and rebuild the touched days."""
    root = tmp_path_factory.mktemp('tsub_corpus')
    rc_path = str(root / 'dragnetrc.json')
    keys = ('DRAGNET_CONFIG', 'DN_INDEX_FORMAT', 'DN_TORCH_DEVICE',
            'DN_ENGINE', 'DN_IQ_STAT_TTL_MS')
    prior = {k: os.environ.get(k) for k in keys}
    os.environ['DRAGNET_CONFIG'] = rc_path
    os.environ['DN_TORCH_DEVICE'] = 'cpu'
    os.environ.pop('DN_ENGINE', None)
    # the JAX package's CLI runs in this process and sees the port's
    # publishes through no write hook: its shard handles re-stat on
    # every checkout instead of trusting a 1 s memo
    os.environ['DN_IQ_STAT_TTL_MS'] = '0'
    state = {'root': root, 'rc_path': rc_path, 'n': {},
             'fmt': {'ds_dnc': 'dnc', 'ds_sq': 'sqlite'},
             'datafile': {}, 'idx': {}}
    try:
        for ds in DSS:
            fmt = state['fmt'][ds]
            datafile = str(root / ('data_%s.log' % fmt))
            _append(datafile, 400, 0)
            state['datafile'][ds] = datafile
            state['n'][ds] = 400
            state['idx'][ds] = str(root / ('idx_' + fmt))
            for args in (['datasource-add', '--path', datafile,
                          '--index-path', state['idx'][ds],
                          '--time-field', 'time', ds],
                         ['metric-add', '-b',
                          'timestamp[date,field=time,aggr=lquantize,'
                          'step=86400],host,latency[aggr=quantize]',
                          ds, 'm1']):
                rc, out, err = run_port(args)
                assert rc == 0, err
            os.environ['DN_INDEX_FORMAT'] = fmt
            rc, out, err = run_port(['build', ds])
            assert rc == 0, err
        os.environ.pop('DN_INDEX_FORMAT', None)
        yield state
    finally:
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _publish(corpus, ds, remote, n=60, engine=None):
    """One `dn follow`-like publish through the port's CLI: append and
    rebuild only the appended records' days (untouched day shards keep
    their stat identities), through the server at `remote` (None: in
    this process, outside the server).  Either build fires the port's
    write hook; a served one holds the tree's write lock until its
    publish has landed, so the group walks it once, whole, while a
    revalidation tick can walk an unserved one mid-publish and push an
    intermediate frame before the final one."""
    start = corpus['n'][ds]
    _append(corpus['datafile'][ds], n, start)
    corpus['n'][ds] += n
    fmt = '%Y-%m-%dT%H:%M:%S.000Z'
    day0 = ((T0 + start * 800) // 86400) * 86400
    day9 = ((T0 + corpus['n'][ds] * 800) // 86400 + 1) * 86400
    after = datetime.datetime.fromtimestamp(
        day0, datetime.timezone.utc).strftime(fmt)
    before = datetime.datetime.fromtimestamp(
        day9, datetime.timezone.utc).strftime(fmt)
    saved = {k: os.environ.get(k) for k in ('DN_INDEX_FORMAT',
                                            'DN_ENGINE')}
    os.environ['DN_INDEX_FORMAT'] = corpus['fmt'][ds]
    if engine is not None:
        os.environ['DN_ENGINE'] = engine
    try:
        rc, out, err = run_port(
            ['build'] + (['--remote', remote] if remote else []) +
            ['--after', after, '--before', before, ds])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert rc == 0, err
    return (day9 - day0) // 86400


def _conf(**over):
    base = {'max_inflight': 4, 'queue_depth': 16, 'deadline_ms': 0,
            'coalesce': True, 'drain_s': 10}
    base.update(over)
    return base


def _start(sock, monkeypatch, **env):
    """A port server with a fast sweep cadence (the manager reads
    DN_SUB_* at construction)."""
    monkeypatch.setenv('DN_SUB_COALESCE_MS', '30')
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return tserver.DnServer(socket_path=str(sock), conf=_conf()).start()


@pytest.fixture
def server(corpus, tmp_path, monkeypatch):
    srv = _start(tmp_path / 'dn.sock', monkeypatch)
    try:
        yield srv
    finally:
        srv.stop()


@pytest.fixture(scope='module')
def jax_server(corpus, tmp_path_factory):
    """The JAX package's server (`bin/dn serve`) over the same trees,
    in its own process: the port's publishes are cross-process writes
    to it."""
    sock = str(tmp_path_factory.mktemp('tsub_jax') / 'jax.sock')
    env = dict(os.environ, DN_SUB_COALESCE_MS='30', JAX_PLATFORMS='cpu',
               DRAGNET_CONFIG=corpus['rc_path'])
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, 'bin', 'dn.py'), 'serve',
         '--socket', sock], cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 120
        while not tlifecycle.probe(socket_path=sock):
            assert proc.poll() is None, proc.stderr.read()
            assert time.monotonic() < deadline, 'bin/dn serve never bound'
            time.sleep(0.1)
        yield sock
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _sub_req(corpus, ds, breakdowns='host'):
    qdoc = {'breakdowns': [{'name': b, 'field': b}
                           for b in breakdowns.split(',')]}
    return {'op': 'subscribe', 'ds': ds, 'config': corpus['rc_path'],
            'interval': 'day', 'queryconfig': qdoc, 'opts': {}}


def _poll(sock, ds, breakdowns='host'):
    rc, out, err = run_port(['query', '--remote', sock, '-b', breakdowns,
                             ds])
    assert rc == 0, err
    return out


def _ref_poll(ds, breakdowns='host'):
    rc, out, err = run_ref(['query', '-b', breakdowns, ds])
    assert rc == 0, err
    return out


def _wait(cond, what):
    deadline = time.monotonic() + WAIT_S
    while True:
        value = cond()
        if value:
            return value
        assert time.monotonic() < deadline, 'timed out waiting: ' + what
        time.sleep(0.05)


def _settled(sock, seq=None):
    """Wait until every group has caught up with the tree's epoch (the
    epoch can move after a push without changing its bytes: a tick that
    saw the tree change bumps it and recomputes to the same payload);
    returns that epoch, with every subscriber at frame `seq` when
    given."""
    def caught_up():
        st = tclient.stats(sock)['subscriptions']
        epoch = tiqmt.cache_epoch()
        return all(g['epoch'] == epoch for g in st['groups']) and st
    st = _wait(caught_up, 'the groups to reach the tree epoch')
    if seq is not None:
        assert {r['seq'] for r in st['subscribers']} == {seq}
    return st['groups'][0]['epoch']


def _next_with_payload(stream, payload):
    """The stream's frames until one carries `payload` (the JAX
    server's revalidation tick may push an intermediate state while a
    publish lands); the frame that carries it."""
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        fr = next(stream)
        if fr['payload'] == payload:
            return fr
    raise AssertionError('no frame carried the polled bytes')


# -- the contract: seed / push / delta, both formats, both packages ----------

@pytest.mark.parametrize('ds', DSS)
def test_push_byte_identical_to_poll(server, jax_server, corpus, ds):
    """The seed frame and a post-publish push carry EXACTLY the bytes of
    a `query --remote` poll at the same epoch, the JAX package's local
    query, and the JAX package's server's frames."""
    stream = tclient.subscribe_stream(server.socket_path,
                                      _sub_req(corpus, ds))
    jstream = jclient.subscribe_stream(jax_server, _sub_req(corpus, ds))
    try:
        seed = next(stream)
        assert seed['kind'] == 'full' and seed['seq'] == 1
        assert seed['epoch'] == tiqmt.cache_epoch()
        polled = _poll(server.socket_path, ds)
        assert seed['payload'] == polled == _ref_poll(ds)
        assert next(jstream)['payload'] == polled
        _publish(corpus, ds, server.socket_path)
        pushed = next(stream)
        assert pushed['seq'] == 2 and pushed['kind'] == 'full'
        assert pushed['epoch'] > seed['epoch']
        assert _settled(server.socket_path, 2) >= pushed['epoch']
        polled = _poll(server.socket_path, ds)
        assert pushed['payload'] == polled == _ref_poll(ds)
        assert pushed['payload'] != seed['payload']
        assert _next_with_payload(jstream, polled)['kind'] == 'full'
    finally:
        stream.close()
        jstream.close()


@pytest.mark.parametrize('ds', DSS)
def test_delta_frame_reconstructs_identical_bytes(corpus, tmp_path,
                                                  monkeypatch, ds):
    """DN_SUB_DELTA_PCT=100: the post-publish frame ships as a byte
    delta, and the client's splice rebuilds the poll's bytes."""
    srv = _start(tmp_path / 'delta.sock', monkeypatch,
                 DN_SUB_DELTA_PCT='100')
    bds = 'timestamp,host'
    try:
        stream = tclient.subscribe_stream(
            srv.socket_path, _sub_req(corpus, ds, breakdowns=bds))
        try:
            seed = next(stream)
            assert seed['kind'] == 'full'
            _publish(corpus, ds, srv.socket_path)
            pushed = next(stream)
            assert pushed['kind'] == 'delta'
            assert pushed['payload'] == _poll(srv.socket_path, ds,
                                              breakdowns=bds)
            assert pushed['payload'] == _ref_poll(ds, breakdowns=bds)
            assert _settled(srv.socket_path, 2) >= pushed['epoch']
            st = tclient.stats(srv.socket_path)
            assert st['subscriptions']['counters']['frames_delta'] >= 1
        finally:
            stream.close()
    finally:
        srv.stop()


def test_resume_token_skips_reseed(server, corpus):
    """Reconnecting with the last frame's token against unchanged
    state: a 'current' frame (no payload on the wire)."""
    req = _sub_req(corpus, 'ds_sq')
    stream = tclient.subscribe_stream(server.socket_path, dict(req))
    seed = next(stream)
    stream.close()
    stream2 = tclient.subscribe_stream(
        server.socket_path, dict(req),
        resume=(seed['token'], seed['payload']))
    try:
        fr = next(stream2)
        assert fr['kind'] == 'current'
        assert fr['payload'] == seed['payload']
        st = tclient.stats(server.socket_path)
        assert st['subscriptions']['counters']['resumed'] >= 1
    finally:
        stream2.close()


# -- the cost: one recompute per publish, only changed shards folded ---------

def test_one_recompute_serves_all_subscribers(server, corpus):
    """Eight subscribers on one standing query, one publish: ONE
    recompute, eight pushes of the same bytes."""
    ds = 'ds_dnc'
    streams = [tclient.subscribe_stream(server.socket_path,
                                        _sub_req(corpus, ds))
               for _ in range(8)]
    try:
        seeds = [next(s) for s in streams]
        assert len({fr['payload'] for fr in seeds}) == 1
        before = tclient.stats(
            server.socket_path)['subscriptions']['counters']
        _publish(corpus, ds, server.socket_path)
        pushed = [next(s) for s in streams]
        assert len({fr['payload'] for fr in pushed}) == 1
        assert pushed[0]['payload'] == _poll(server.socket_path, ds)
        after = tclient.stats(
            server.socket_path)['subscriptions']['counters']
        assert after['recomputes'] - before['recomputes'] == 1
        assert after['pushes'] - before['pushes'] == 8
    finally:
        for s in streams:
            s.close()


def test_incremental_fold_reuses_unchanged_shards(server, corpus):
    """A publish that rewrites a few days' shards folds only those; the
    rest replay from the group memo."""
    ds = 'ds_sq'
    stream = tclient.subscribe_stream(server.socket_path,
                                      _sub_req(corpus, ds))
    try:
        next(stream)
        before = tclient.stats(
            server.socket_path)['subscriptions']['counters']
        ndays = _publish(corpus, ds, server.socket_path)
        assert next(stream)['payload'] == _poll(server.socket_path, ds)
        after = tclient.stats(
            server.socket_path)['subscriptions']['counters']
        folded = after['shards_folded'] - before['shards_folded']
        assert 1 <= folded <= ndays
        assert after['shards_reused'] > before['shards_reused']
    finally:
        stream.close()


# -- backpressure -------------------------------------------------------------

def _raw_subscribe(sock_path, req):
    """A hand-rolled v2 subscriber that never acks."""
    s = mod_socket.socket(mod_socket.AF_UNIX, mod_socket.SOCK_STREAM)
    s.settimeout(30.0)
    s.connect(sock_path)
    s.sendall(tprotocol.encode_request(dict(req), 1))
    f = s.makefile('rb')

    def read_frame():
        line = f.readline(tprotocol.MAX_FRAME_BYTES)
        assert line, 'unexpected EOF'
        header = json.loads(line.decode('utf-8'))
        need = int(header.get('nout', 0)) + int(header.get('nerr', 0))
        payload = b''
        while len(payload) < need:
            chunk = f.read(need - len(payload))
            assert chunk, 'short frame'
            payload += chunk
        return header, payload

    reg, body = read_frame()
    assert reg['rc'] == 0, body
    seed, _ = read_frame()
    assert seed.get('kind') == 'full'
    return s, read_frame, json.loads(body.decode())['sub']


def test_stalled_subscriber_sheds_healthy_delivers(corpus, tmp_path,
                                                    monkeypatch):
    """DN_SUB_QUEUE_DEPTH=1: a subscriber that never acks is shed while
    a healthy one on the same group gets every frame; its first ack
    buys one catch-up FULL frame with the current bytes."""
    srv = _start(tmp_path / 'stall.sock', monkeypatch,
                 DN_SUB_QUEUE_DEPTH='1')
    try:
        req = _sub_req(corpus, 'ds_dnc')
        s, read_frame, sid = _raw_subscribe(srv.socket_path, req)
        healthy = tclient.subscribe_stream(srv.socket_path, dict(req))
        try:
            next(healthy)
            _publish(corpus, 'ds_dnc', srv.socket_path)
            fresh = next(healthy)
            assert fresh['seq'] == 2

            def shed():
                st = tclient.stats(srv.socket_path)['subscriptions']
                return st if st['counters']['lagging_sheds'] >= 1 \
                    else None

            st = _wait(shed, 'a lagging shed')
            row = [d for d in st['subscribers'] if d['sub'] == sid][0]
            assert row['lagging'] is True and row['seq'] == 1
            s.sendall(tprotocol.encode_request(
                {'op': 'sub_ack', 'sub': sid, 'seq': 1}, 2))
            got = [read_frame(), read_frame()]
            kinds = [h.get('kind') for h, _ in got
                     if h.get('sub') is not None]
            assert kinds == ['full']
            assert [p for h, p in got if h.get('kind') == 'full'][0] == \
                fresh['payload']
        finally:
            healthy.close()
            s.close()
    finally:
        srv.stop()


# -- the ops: sub_ack, unsubscribe; the drain, disabled and limits -----------

def test_sub_ack_validates_and_dedupes(server, corpus):
    """`sub_ack`: an unknown subscription and an out-of-range seq are
    rc 1; a repeated ack is idempotent and counted."""
    s, read_frame, sid = _raw_subscribe(server.socket_path,
                                        _sub_req(corpus, 'ds_dnc'))
    try:
        for req, needle in (({'op': 'sub_ack', 'sub': 'nope', 'seq': 1},
                             b'unknown subscription'),
                            ({'op': 'sub_ack', 'sub': sid, 'seq': 5},
                             b'bad ack seq')):
            rc, hd, out, err = tclient.request_bytes(server.socket_path,
                                                     req)
            assert rc == 1 and needle in err, err
        for _ in range(2):
            rc, hd, out, err = tclient.request_bytes(
                server.socket_path, {'op': 'sub_ack', 'sub': sid,
                                     'seq': 1})
            assert rc == 0 and out == b'', err
        st = tclient.stats(server.socket_path)['subscriptions']
        assert st['counters']['duplicate_acks'] >= 1
    finally:
        s.close()


def test_unsubscribe_idempotent(server, corpus):
    stream = tclient.subscribe_stream(server.socket_path,
                                      _sub_req(corpus, 'ds_dnc'))
    sid = next(stream)['sub']
    rc, hd, out, err = tclient.request_bytes(
        server.socket_path, {'op': 'unsubscribe', 'sub': sid})
    assert rc == 0, err
    rc, hd, out, err = tclient.request_bytes(
        server.socket_path, {'op': 'unsubscribe', 'sub': sid})
    assert rc == 1 and b'unknown subscription' in err
    stream.close()
    st = tclient.stats(server.socket_path)['subscriptions']
    assert st['active'] == 0 and st['counters']['dropped'] >= 1


def test_drain_sends_end_frame(corpus, tmp_path, monkeypatch):
    """A stopping server ends every stream with an 'end' frame."""
    srv = _start(tmp_path / 'drain.sock', monkeypatch)
    stream = tclient.subscribe_stream(srv.socket_path,
                                      _sub_req(corpus, 'ds_dnc'))
    try:
        next(stream)
        srv.stop()
        assert list(stream) == []
    finally:
        stream.close()


def test_disabled_and_limit_rejections(corpus, tmp_path, monkeypatch):
    srv = _start(tmp_path / 'off.sock', monkeypatch, DN_SUB_MAX='0')
    try:
        with pytest.raises(tclient.SubscribeUnsupported):
            next(tclient.subscribe_stream(srv.socket_path,
                                          _sub_req(corpus, 'ds_dnc')))
        assert tclient.stats(srv.socket_path)['subscriptions'][
            'enabled'] is False
    finally:
        srv.stop()
    srv = _start(tmp_path / 'one.sock', monkeypatch, DN_SUB_MAX='1')
    try:
        stream = tclient.subscribe_stream(srv.socket_path,
                                          _sub_req(corpus, 'ds_dnc'))
        next(stream)
        with pytest.raises(DNError) as ei:
            next(tclient.subscribe_stream(srv.socket_path,
                                          _sub_req(corpus, 'ds_sq')))
        assert 'subscription limit' in ei.value.message
        assert getattr(ei.value, 'retryable', False) is True
        stream.close()
    finally:
        srv.stop()


def test_rejected_registrations(server, corpus):
    """Bad standing queries answer a clean error, not a stream; a v1
    subscribe is refused before a subscription exists."""
    cases = [
        (dict(_sub_req(corpus, 'ds_dnc'), ds=None), 'missing "ds"'),
        (dict(_sub_req(corpus, 'nope')), 'unknown datasource'),
        (dict(_sub_req(corpus, 'ds_dnc'), opts={'counters': True}),
         'cannot ride a standing query'),
    ]
    for req, needle in cases:
        with pytest.raises(DNError) as ei:
            next(tclient.subscribe_stream(server.socket_path, req))
        assert needle in ei.value.message, (needle, ei.value.message)
    rc, hd, out, err = tclient.request_bytes(
        server.socket_path, _sub_req(corpus, 'ds_dnc'), pooled=False)
    assert rc == 1 and b'requires protocol 2' in err


def _cluster_topo(tmp_path, socks, parts):
    from dragnet_tpu_torch.serve import topology as ttopology
    topo_path = str(tmp_path / 'topo.json')
    with open(topo_path, 'w') as f:
        json.dump({'epoch': 1, 'assign': 'hash',
                   'members': {m: {'endpoint': socks[m]} for m in socks},
                   'partitions': [{'id': i, 'replicas': r}
                                  for i, r in enumerate(parts)]}, f)
    return {m: ttopology.load_topology(topo_path, member=m)
            for m in socks}


def _pin_disk(tmp_path, monkeypatch):
    """A fixed free-space reading: a cluster member's governor must not
    depend on the disk the tests run on."""
    sim = tmp_path / 'disk_free_pct'
    sim.write_text('50\n')
    monkeypatch.setenv('DN_DISK_SIM_FILE', str(sim))


def test_routed_group_reconfirms_and_stays_quiet(corpus, tmp_path,
                                                 monkeypatch):
    """A cluster member's group scatters through the router, and re-
    scatters ONCE after the peer stat-TTL window (_confirm_delay): the
    confirm fires after quiescence, a confirm that finds identical bytes
    pushes no frame, and a publish pushes once with its confirm quiet
    too — as the JAX package's test of the same name pins."""
    ds = 'ds_dnc'
    monkeypatch.setenv('DN_SUB_COALESCE_MS', '30')
    monkeypatch.setenv('DN_IQ_STAT_TTL_MS', '120')
    monkeypatch.setenv('DN_ROUTER_PROBE_MS', '60000')
    _pin_disk(tmp_path, monkeypatch)
    sock = str(tmp_path / 'routed.sock')
    topo = _cluster_topo(tmp_path, {'a': sock}, [['a'], ['a'], ['a']])
    srv = tserver.DnServer(socket_path=sock, conf=_conf(),
                           cluster=topo['a'], member='a').start()
    try:
        stream = tclient.subscribe_stream(sock, _sub_req(corpus, ds))
        try:
            seed = next(stream)
            assert seed['kind'] == 'full' and seed['seq'] == 1
            assert seed['payload'] == _ref_poll(ds)

            def reconfirms():
                st = tclient.stats(sock)['subscriptions']
                return st['counters']['reconfirms']

            _wait(lambda: reconfirms() >= 1, 'the seed\'s confirm')
            time.sleep(0.5)
            st = tclient.stats(sock)['subscriptions']
            assert st['subscribers'][0]['seq'] == 1
            assert st['groups'][0]['version'] == 1
            assert tclient.stats(sock)['cluster']['counters'][
                'scatters'] >= 2
            before = reconfirms()
            _publish(corpus, ds, sock)
            pushed = next(stream)
            assert pushed['seq'] == 2
            assert pushed['payload'] == _poll(sock, ds) == _ref_poll(ds)
            _wait(lambda: reconfirms() > before, 'the publish\'s confirm')
            time.sleep(0.5)
            st = tclient.stats(sock)['subscriptions']
            assert st['subscribers'][0]['seq'] == 2
        finally:
            stream.close()
    finally:
        srv.stop()


def test_routed_group_on_three_members(corpus, tmp_path, monkeypatch):
    """Three members (partitions [a,b], [b,c], [c,a]); four subscribers
    through `a`: the seed and the frame after a publish through `a`
    equal a routed poll and the JAX package's local query, with one
    recompute per publish for the whole group (the served build holds
    a's write lock until it has landed; the confirming scatter past the
    stat-TTL window recomputes the same bytes and pushes nothing)."""
    ds = 'ds_sq'
    monkeypatch.setenv('DN_SUB_COALESCE_MS', '30')
    monkeypatch.setenv('DN_ROUTER_PROBE_MS', '60000')
    _pin_disk(tmp_path, monkeypatch)
    socks = {m: str(tmp_path / ('dn-%s.sock' % m)) for m in 'abc'}
    topo = _cluster_topo(tmp_path, socks,
                         [['a', 'b'], ['b', 'c'], ['c', 'a']])
    servers = {}
    streams = []
    try:
        for m in 'abc':
            servers[m] = tserver.DnServer(
                socket_path=socks[m], conf=_conf(), cluster=topo[m],
                member=m).start()
        for _ in range(4):
            streams.append(tclient.subscribe_stream(
                socks['a'], _sub_req(corpus, ds)))
        seeds = [next(s) for s in streams]
        assert {fr['payload'] for fr in seeds} == {_ref_poll(ds)}
        _settled(socks['a'])
        time.sleep(0.5)          # the seed's confirm (0.13 s) has run
        st = tclient.stats(socks['a'])['subscriptions']
        before = (st['counters']['recomputes'] -
                  st['counters']['reconfirms'])
        scatters = tclient.stats(socks['a'])['cluster']['counters'][
            'scatters']
        _publish(corpus, ds, socks['a'])
        polled = _ref_poll(ds)
        frames = [_next_with_payload(s, polled) for s in streams]
        assert {fr['seq'] for fr in frames} == {2}
        assert _poll(socks['a'], ds) == polled
        time.sleep(0.5)
        _settled(socks['a'], seq=2)
        st = tclient.stats(socks['a'])['subscriptions']
        assert st['counters']['recomputes'] - \
            st['counters']['reconfirms'] - before == 1
        assert st['groups'][0]['subscribers'] == 4
        cl = tclient.stats(socks['a'])['cluster']['counters']
        # the publish's scatter, its confirm's and the routed poll's
        assert cl['scatters'] - scatters >= 2
    finally:
        for s in streams:
            s.close()
        for srv in servers.values():
            srv.stop()


# -- the fleet watch and the /stats section ----------------------------------

def test_fleet_watch_pushes_fleet_doc(server, corpus):
    """watch=fleet frames carry the fleet_stats document on the
    subscriber's cadence: the one-member fleet of this server."""
    stream = tclient.subscribe_stream(
        server.socket_path,
        {'op': 'subscribe', 'watch': 'fleet', 'interval_ms': 150})
    try:
        first = next(stream)
        doc = json.loads(first['payload'].decode('utf-8'))
        assert doc['members_total'] == 1 and doc['members_up'] == 1
        assert list(doc['members']) == ['local']
        second = next(stream)
        assert second['seq'] == first['seq'] + 1
    finally:
        stream.close()


def test_stats_doc_shape(server, jax_server, corpus):
    """The /stats `subscriptions` section has the JAX package's shape
    (its keys, counters, group and subscriber rows)."""
    stream = tclient.subscribe_stream(server.socket_path,
                                      _sub_req(corpus, 'ds_dnc'))
    jstream = jclient.subscribe_stream(jax_server,
                                       _sub_req(corpus, 'ds_dnc'))
    try:
        next(stream)
        next(jstream)
        st = tclient.stats(server.socket_path)['subscriptions']
        jst = jclient.stats(jax_server)['subscriptions']
        assert st['enabled'] is True and st['active'] == 1
        assert set(st) == set(jst)
        assert set(st['counters']) == set(jst['counters'])
        assert set(st['groups'][0]) == set(jst['groups'][0])
        assert set(st['subscribers'][0]) == set(jst['subscribers'][0])
        assert st['groups'][0]['memo_shards'] == \
            jst['groups'][0]['memo_shards'] >= 1
        assert st['groups'][0]['payload_bytes'] == \
            jst['groups'][0]['payload_bytes']
    finally:
        stream.close()
        jstream.close()


def test_fleet_merge_carries_subscriptions(server, corpus):
    """merge_fleet and its Prometheus text over this server's stats
    equal the JAX package's over the same documents."""
    stream = tclient.subscribe_stream(server.socket_path,
                                      _sub_req(corpus, 'ds_dnc'))
    try:
        next(stream)
        st = tclient.stats(server.socket_path)
        args = (['a', 'b'], {'a': st, 'b': {}}, {}, {})
        doc = tfleet.merge_fleet(server, *args)
        jdoc = jfleet.merge_fleet(server, *args)
        doc.pop('ts'), jdoc.pop('ts')
        assert doc == jdoc
        assert doc['members']['a']['subscriptions'] == 1
        assert 'subscriptions' not in doc['members']['b']
        assert doc['aggregate']['subscription_pushes'] >= 1
        text = tfleet.fleet_prometheus_text(doc)
        assert text == jfleet.fleet_prometheus_text(jdoc)
        assert 'fleet_subscriptions 1' in text
    finally:
        stream.close()


# -- the CLI: dn subscribe JSONL, dn top --subscribe --------------------------

def test_dn_subscribe_cli_streams_jsonl(server, jax_server, corpus):
    """`dn subscribe --frames=1`: one JSON line whose payload is the
    polled bytes, as bin/dn's line against its own server."""
    args = ['--frames', '1', '-b', 'host', 'ds_sq']
    rc, out, err = run_port(['subscribe', '--remote', server.socket_path]
                            + args)
    assert rc == 0, err
    lines = out.decode('utf-8').splitlines()
    assert len(lines) == 1
    frame = json.loads(lines[0])
    assert frame['kind'] == 'full' and frame['seq'] == 1
    assert frame['token']['k']
    assert frame['payload'].encode('utf-8') == \
        _poll(server.socket_path, 'ds_sq')
    jrc, jout, jerr = run_ref(['subscribe', '--remote', jax_server]
                              + args)
    assert jrc == 0, jerr
    jframe = json.loads(jout.decode('utf-8'))
    assert sorted(jframe) == sorted(frame)
    assert (jframe['payload'], jframe['token']['k']) == \
        (frame['payload'], frame['token']['k'])


@pytest.mark.parametrize('args', [
    ['subscribe', 'ds_dnc'],
    ['subscribe', '--remote', '/nope.sock', '--frames', 'x', 'ds_dnc'],
    ['top'],
])
def test_dn_subscribe_cli_requires_remote_and_validates(corpus, args):
    """Usage and argument errors: rc and stderr as bin/dn's."""
    got = run_port(args)
    ref = run_ref(args)
    assert got[0] == ref[0] and got[0] in (1, 2)
    assert got[1] == b''
    assert b'--remote' in got[2] or b'--frames' in got[2]
    if got[0] == 1:
        assert got[2] == ref[2]


def test_dn_top_subscribe_rides_push_path(server, corpus):
    """`dn top --subscribe --once` renders a frame fed by a pushed
    fleet subscription, not a fleet_stats poll."""
    buf = io.StringIO()
    rc = ttop.top_main(server.socket_path, 200, once=True, out=buf,
                       subscribe=True)
    assert rc == 0
    assert 'members 1/1 up' in buf.getvalue()
    st = tclient.stats(server.socket_path)
    assert st['subscriptions']['counters']['registered'] >= 1
    assert st['requests']['by_op'].get('fleet_stats', 0) == 0


def test_dn_top_subscribe_falls_back_to_polling(corpus, tmp_path,
                                               monkeypatch):
    """Against a server with subscriptions off, --subscribe falls back
    to the fleet_stats poll with a notice."""
    srv = _start(tmp_path / 'nopush.sock', monkeypatch, DN_SUB_MAX='0')
    try:
        buf = io.StringIO()
        with tserver.thread_stdio() as cap:
            rc = ttop.top_main(srv.socket_path, 200, once=True, out=buf,
                               subscribe=True)
        _out, err = cap.finish()
        assert rc == 0
        assert 'members 1/1 up' in buf.getvalue()
        assert b'falling back to polling' in err
        assert tclient.stats(srv.socket_path)['requests']['by_op'][
            'fleet_stats'] == 1
    finally:
        srv.stop()


# -- the push codec against the reference's -----------------------------------

@settings(max_examples=200, deadline=None)
@given(old=st.binary(max_size=300), new=st.binary(max_size=300),
       seq=st.integers(1, 1 << 40), epoch=st.integers(0, 1 << 40),
       kind=st.sampled_from(['full', 'delta', 'current', 'end']))
def test_push_codec_matches_reference(old, new, seq, epoch, kind):
    delta = tprotocol.byte_delta(old, new)
    assert delta == jprotocol.byte_delta(old, new)
    off, keep, ins = delta
    assert tprotocol.apply_delta(old, off, keep, ins) == new == \
        jprotocol.apply_delta(old, off, keep, ins)
    extra = {'delta': {'off': off, 'keep': keep}, 'version': seq}
    frame = tprotocol.encode_push('s%d' % seq, seq, epoch, kind, ins,
                                  extra)
    assert frame == jprotocol.encode_push('s%d' % seq, seq, epoch, kind,
                                          ins, extra)
    header = json.loads(frame.split(b'\n', 1)[0])
    assert tprotocol.classify_frame(header) == \
        jprotocol.classify_frame(header) == 'push'
    for bad in ((-1, 0), (0, len(old) + 1), (True, 0)):
        with pytest.raises(tprotocol.FrameError):
            tprotocol.apply_delta(old, bad[0], bad[1], b'')


def test_classify_frame_both_ids_is_malformed():
    for mod in (tprotocol, jprotocol):
        assert mod.classify_frame({'id': 3}) == 'response'
        with pytest.raises(mod.FrameError):
            mod.classify_frame({'id': 3, 'sub': 's1'})


# -- publishes: the device build, follow, another process ---------------------

def test_write_hook_fires_for_device_build_and_follow(server, corpus,
                                                      tmp_path,
                                                      monkeypatch):
    """The port's write hook fires for the stacked device build's
    publish (DN_ENGINE=jax, the CPU device here) and for `follow`'s
    merge-publish; each wakes the subscription, whose push equals the
    poll."""
    ds = 'ds_dnc'
    fired = []

    def hook(indexroot, shard_paths):
        fired.append((indexroot, len(shard_paths)))

    tbuild.register_index_write_hook(hook)
    stream = tclient.subscribe_stream(server.socket_path,
                                      _sub_req(corpus, ds))
    try:
        next(stream)
        _publish(corpus, ds, None, engine='jax')
        assert fired and fired[-1][1] >= 1
        assert os.path.normpath(fired[-1][0]) == \
            os.path.normpath(corpus['idx'][ds])
        _next_with_payload(stream, _poll(server.socket_path, ds))
        nfired = len(fired)
        # follow ingests a file of just the new records (from offset
        # 0), which the datafile also gains, so the tree stays a build
        # of the datafile; a fixed free-space reading keeps the
        # governor from pausing the publish on a full disk
        start = corpus['n'][ds]
        newfile = str(tmp_path / 'new.log')
        _append(newfile, 40, start)
        _append(corpus['datafile'][ds], 40, start)
        corpus['n'][ds] += 40
        sim = tmp_path / 'disk_free_pct'
        sim.write_text('50\n')
        monkeypatch.setenv('DN_DISK_SIM_FILE', str(sim))
        monkeypatch.setenv('DN_INDEX_FORMAT', corpus['fmt'][ds])
        monkeypatch.setenv('DN_ENGINE', 'jax')
        rc, out, err = run_port(['follow', '--once', ds, newfile])
        assert rc == 0, err
        assert len(fired) > nfired
        polled = _poll(server.socket_path, ds)
        assert polled == _ref_poll(ds)
        _next_with_payload(stream, polled)
    finally:
        tbuild.unregister_index_write_hook(hook)
        stream.close()


def test_cross_process_publish_caught_by_revalidation(server, corpus):
    """A build in another process (`python -m dragnet_tpu_torch build`)
    fires no hook here: the revalidation tick sees the tree change,
    bumps the epoch, and the push equals the poll at that epoch."""
    ds = 'ds_sq'
    stream = tclient.subscribe_stream(server.socket_path,
                                      _sub_req(corpus, ds),
                                      timeout_s=WAIT_S)
    try:
        seed = next(stream)
        start = corpus['n'][ds]
        _append(corpus['datafile'][ds], 60, start)
        corpus['n'][ds] += 60
        env = dict(os.environ, DN_INDEX_FORMAT=corpus['fmt'][ds],
                   DN_TORCH_DEVICE='cpu')
        proc = subprocess.run(
            [sys.executable, '-m', 'dragnet_tpu_torch', 'build', ds],
            cwd=ROOT, env=env, capture_output=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        polled = _poll(server.socket_path, ds)
        assert polled == _ref_poll(ds)
        pushed = _next_with_payload(stream, polled)
        assert pushed['epoch'] > seed['epoch']
        assert _settled(server.socket_path) >= pushed['epoch']
        assert _poll(server.socket_path, ds) == pushed['payload']
    finally:
        stream.close()


def _plant_residue(indexroot, owner, seq):
    """What a publish whose renames failed leaves under `indexroot` for
    its (still live) process `owner`: its commit journal and a tmp.
    The journal names no entries, so no later sweep can roll the tmp
    over a shard of the shared corpus.  Returns both paths."""
    journal = os.path.join(indexroot, '.dn_build.%d.%d.json'
                           % (owner, seq))
    with open(journal, 'w') as f:
        json.dump({'pid': owner, 'entries': []}, f)
    tmp = os.path.join(indexroot, 'by_day', '2099-01-01.sqlite.%d.%d'
                       % (owner, seq))
    with open(tmp, 'wb') as f:
        f.write(b'never renamed')
    return [journal, tmp]


@pytest.fixture
def live_process():
    """Another live process (one that owns a tree's residue)."""
    proc = subprocess.Popen([sys.executable, '-c',
                             'import time; time.sleep(600)'])
    try:
        yield proc.pid
    finally:
        proc.kill()
        proc.wait()


def test_publish_in_flight_holds_only_fresh_residue_of_others(
        tmp_path, live_process):
    """The revalidation tick's hold: another live process's fresh tmp
    or journal holds it; this process's own residue, a dead process's,
    and residue unwritten for `stale_s` (a publish whose renames
    failed) hold nothing."""
    from dragnet_tpu_torch import index_journal as tjournal
    root = str(tmp_path)
    me = os.getpid()
    os.mkdir(os.path.join(root, 'by_day'))
    assert not tjournal.publish_in_flight(root, 2.0)
    mine = _plant_residue(root, me, 1)
    assert tjournal.publish_in_flight(root, 2.0)
    assert not tjournal.publish_in_flight(root, 2.0, ignore_pid=me)
    theirs = _plant_residue(root, live_process, 2)
    for fresh in theirs:
        for path in theirs:
            age = 0 if path == fresh else 10
            os.utime(path, (time.time() - age,) * 2)
        assert tjournal.publish_in_flight(root, 2.0, ignore_pid=me)
    for path in theirs:
        os.utime(path, (time.time() - 10,) * 2)
    assert not tjournal.publish_in_flight(root, 2.0, ignore_pid=me)
    assert tjournal.publish_in_flight(root, 60.0, ignore_pid=me)
    for path in mine + theirs:
        os.unlink(path)
    dead = subprocess.Popen([sys.executable, '-c', 'pass'])
    dead.wait()
    _plant_residue(root, dead.pid, 3)
    assert not tjournal.publish_in_flight(root, 60.0)


@pytest.mark.parametrize('owner', ['server', 'other'])
def test_failed_publish_residue_does_not_stall_pushes(
        server, corpus, live_process, owner):
    """A publish whose renames failed leaves its journal and tmps in
    place while its process lives on: the server's own (a served build
    --remote) or another process's (a `dn follow`).  A later publish by
    a third process is still pushed, equal to the poll, once that
    residue has gone unwritten for the hold's bound."""
    ds = 'ds_sq'
    pid = os.getpid() if owner == 'server' else live_process
    planted = _plant_residue(corpus['idx'][ds], pid, 9)
    # a push that never comes fails the read at WAIT_S, not the run
    stream = tclient.subscribe_stream(server.socket_path,
                                      _sub_req(corpus, ds),
                                      timeout_s=WAIT_S)
    try:
        seed = next(stream)
        start = corpus['n'][ds]
        _append(corpus['datafile'][ds], 60, start)
        corpus['n'][ds] += 60
        env = dict(os.environ, DN_INDEX_FORMAT=corpus['fmt'][ds],
                   DN_TORCH_DEVICE='cpu')
        proc = subprocess.run(
            [sys.executable, '-m', 'dragnet_tpu_torch', 'build', ds],
            cwd=ROOT, env=env, capture_output=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        polled = _poll(server.socket_path, ds)
        pushed = _next_with_payload(stream, polled)
        assert pushed['epoch'] > seed['epoch']
        assert all(os.path.exists(p) for p in planted)
    finally:
        stream.close()
        for path in planted:
            os.unlink(path)


def test_concurrent_subscribers_while_publishing(server, corpus):
    """Subscribers registering from several threads while a publish
    lands: every stream's latest frame equals the final poll."""
    ds = 'ds_dnc'
    streams = []
    lock = threading.Lock()

    def join():
        s = tclient.subscribe_stream(server.socket_path,
                                     _sub_req(corpus, ds))
        fr = next(s)
        with lock:
            streams.append([s, fr])

    threads = [threading.Thread(target=join) for _ in range(4)]
    for t in threads:
        t.start()
    _publish(corpus, ds, server.socket_path)
    for t in threads:
        t.join(WAIT_S)
    try:
        assert len(streams) == 4
        final = _poll(server.socket_path, ds)
        for ent in streams:
            while ent[1]['payload'] != final:
                ent[1] = next(ent[0])
    finally:
        for s, _ in streams:
            s.close()


# -- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_push_equals_poll_on_the_card(corpus, tmp_path, monkeypatch):
    """A server on the card (DN_ENGINE=jax): the publish goes through
    `build --remote` (folded on the card), the poll through the
    served device lane (K7), the frame equals the poll and the pusher
    thread never reaches a device entry."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from dragnet_tpu_torch import device_index as tdi
    from dragnet_tpu_torch import device_scan as tds
    from dragnet_tpu_torch.ops import cuda_kernels as ck
    monkeypatch.setenv('DN_SUB_COALESCE_MS', '30')
    monkeypatch.setenv('DN_ENGINE', 'jax')
    threads = set()

    def record(orig):
        def wrapped(*a, **k):
            threads.add(threading.current_thread().name)
            return orig(*a, **k)
        return wrapped
    monkeypatch.setattr(ck, 'onehot_dense_into',
                        record(ck.onehot_dense_into))
    monkeypatch.setattr(tdi, '_device_fold', record(tdi._device_fold))
    folds = []
    fold_staged = tds.DeviceScan._fold_staged

    def counted_fold(self, *a):
        folds.append(threading.current_thread().name)
        return fold_staged(self, *a)
    monkeypatch.setattr(tds.DeviceScan, '_fold_staged', counted_fold)
    srv = tserver.DnServer(socket_path=str(tmp_path / 'card.sock'),
                           conf=_conf(), device='cuda').start()
    ds = 'ds_dnc'
    try:
        stream = tclient.subscribe_stream(srv.socket_path,
                                          _sub_req(corpus, ds))
        try:
            seed = next(stream)
            assert seed['payload'] == _poll(srv.socket_path, ds)
            tdi._reset_engagement()
            del folds[:]
            _publish(corpus, ds, srv.socket_path)
            assert folds
            pushed = next(stream)
            assert pushed['payload'] == _poll(srv.socket_path, ds)
            assert tdi.stats_doc()['dispatches'] >= 1
            assert 'dn-subscribe' not in threads
        finally:
            stream.close()
    finally:
        srv.stop()
