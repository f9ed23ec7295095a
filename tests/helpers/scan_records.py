"""Fixture records for the scan program's tests (the CPU suite and the
card suite share them): every tag kind in the filter and key fields,
integer values at the bucketize edges, bad dates, signed weights."""

import json
import random

HOSTS = ['a', 'b', 'c', 'host-%d', None, True, False, {'x': 1}, 17, -3]
LATENCIES = [0, 1, 2, 3, 7, 16, 17, 200, 4095, 4096, 123456, 2147483647,
             -1, -2, -7, -100, -2147483648, '26', 'x', None, True]
CODES = [200, 204, 404, 500, '500', None]


def records(seed, n, skinner=False, latencies=LATENCIES):
    """Lines of every tag kind in the filter and key fields (strings,
    numbers, null, booleans, objects, missing), integer values at the
    bucketize edges (0, 1, 2^31 - 1, negatives, -2^31), valid and bad
    dates over three days, small signed `delta`s for linear buckets.
    json-skinner lines carry signed weights.  `latencies`: the values to
    draw from, or a (lo, hi) range of integers."""
    rng = random.Random(seed)
    lines = []
    for i in range(n):
        rec = {}
        h = rng.choice(HOSTS)
        if h == 'host-%d':
            h = 'host-%d' % rng.randrange(12)
        if rng.random() < 0.93:
            rec['host'] = h
        if rng.random() < 0.9:
            rec['req'] = {'method': rng.choice(['GET', 'PUT', None])}
        if rng.random() < 0.95:
            rec['latency'] = rng.choice(latencies) if isinstance(
                latencies, list) else rng.randrange(*latencies)
        if rng.random() < 0.95:
            rec['code'] = rng.choice(CODES)
        if rng.random() < 0.9:
            rec['delta'] = rng.choice([rng.randrange(-60, 60), 'n/a'])
        r = rng.random()
        if r < 0.9:
            rec['time'] = '2014-05-%02dT%02d:%02d:%02dZ' % (
                1 + i * 3 // n, rng.randrange(24), rng.randrange(60),
                rng.randrange(60))
        elif r < 0.95:
            rec['time'] = 'invalid'
        if skinner:
            rec = {'fields': rec, 'value': rng.randrange(-4, 9)}
        lines.append(json.dumps(rec))
    return lines


def write(tmp_path, lines, name='data.log'):
    path = str(tmp_path / name)
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return path
