"""The port stands alone: no module of dragnet_tpu_torch, nor
chip_smoke.py, imports jax or the JAX package (checked statically, since
the test process has jax loaded already), and no entry point falls back
to the CPU when CUDA was asked for but is missing."""

import ast
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'jaxlib', 'dragnet_tpu')


def _port_sources():
    out = [os.path.join(ROOT, 'chip_smoke.py')]
    pkg = os.path.join(ROOT, 'dragnet_tpu_torch')
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if not d.startswith(('_', '.'))]
        out += [os.path.join(dirpath, f) for f in filenames
                if f.endswith('.py')]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ''
        elif isinstance(node, ast.Call) and \
                getattr(node.func, 'id', None) == '__import__' and \
                node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_port_imports_neither_jax_nor_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 15
    bad = []
    for path in sources:
        for name in _imported_roots(path):
            if name.split('.')[0] in FORBIDDEN:
                bad.append((os.path.relpath(path, ROOT), name))
    assert not bad


def test_port_relative_imports_resolve():
    """Every relative import in the port names a module (or a name in
    one) that the port itself has: a copied module cannot reach back
    into a module the port left out."""
    import importlib
    missing = []
    for path in _port_sources():
        rel = os.path.relpath(path, ROOT)
        if not rel.startswith('dragnet_tpu_torch'):
            continue
        pkg = os.path.dirname(rel).split(os.sep)
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if not isinstance(node, ast.ImportFrom) or node.level == 0:
                continue
            base = pkg[:len(pkg) - (node.level - 1)]
            modname = '.'.join(base + ([node.module] if node.module
                                       else []))
            mod = importlib.import_module(modname)
            for a in node.names:
                if not hasattr(mod, a.name):
                    try:
                        importlib.import_module(modname + '.' + a.name)
                    except ImportError:
                        missing.append((rel, modname, a.name))
    assert not missing


def test_default_device_without_cuda_raises(monkeypatch, tmp_path):
    from dragnet_tpu_torch.errors import DNError
    from dragnet_tpu_torch.ops import resolve_device
    from dragnet_tpu_torch import query as tquery
    from dragnet_tpu_torch.datasource_file import DatasourceFile
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for dev in (None, 'cuda', 'cuda:0'):
        with pytest.raises(DNError, match='CUDA'):
            resolve_device(dev)
    assert resolve_device('cpu') == torch.device('cpu')
    data = tmp_path / 'd.log'
    data.write_text('{"host":"a"}\n')
    ds = DatasourceFile({'ds_backend': 'file', 'ds_format': 'json',
                         'ds_backend_config': {
                             'path': str(data),
                             'indexPath': str(tmp_path / 'idx')}})
    q = tquery.query_load({'breakdowns': [{'name': 'host'}]})
    with pytest.raises(DNError, match='CUDA'):
        ds.scan(q)
    assert ds.scan(q, device='cpu').points == [({'host': 'a'}, 1)]
    m = tquery.metric_deserialize({'name': 'm', 'breakdowns': [
        {'name': 'host', 'field': 'host'}]})
    for call in (ds.index_scan, ds.build):
        with pytest.raises(DNError, match='CUDA'):
            call([m], 'all')
    assert ds.index_scan([m], 'all', device='cpu').points == \
        [({'host': 'a', '__dn_metric': 0}, 1)]


def test_cli_scan_without_cuda_fails(monkeypatch, tmp_path, capsys):
    from dragnet_tpu_torch import cli
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setenv('DRAGNET_CONFIG', str(tmp_path / 'rc'))
    monkeypatch.delenv('DN_TORCH_DEVICE', raising=False)
    data = tmp_path / 'd.log'
    data.write_text('{"host":"a"}\n')
    assert cli.main(['datasource-add', 'd', '--path=' + str(data)]) == 0
    assert cli.main(['scan', '-b', 'host', 'd']) == 1
    assert 'CUDA' in capsys.readouterr().err
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    assert cli.main(['scan', '-b', 'host', 'd']) == 0
    assert 'a' in capsys.readouterr().out


def test_cli_build_without_cuda_fails(monkeypatch, tmp_path, capsys):
    """`build` and `index-scan` take the device from DN_TORCH_DEVICE as
    `scan` does: no CUDA, no silent CPU build."""
    from dragnet_tpu_torch import cli
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setenv('DRAGNET_CONFIG', str(tmp_path / 'rc'))
    monkeypatch.delenv('DN_TORCH_DEVICE', raising=False)
    data = tmp_path / 'd.log'
    data.write_text('{"host":"a"}\n')
    assert cli.main(['datasource-add', 'd', '--path=' + str(data),
                     '--index-path=' + str(tmp_path / 'idx')]) == 0
    assert cli.main(['metric-add', '-b', 'host', 'd', 'm']) == 0
    for cmd in (['build', '--interval=all', 'd'],
                ['index-scan', '--interval=all', 'd']):
        assert cli.main(cmd) == 1
        assert 'CUDA' in capsys.readouterr().err
    assert not (tmp_path / 'idx').exists()
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    assert cli.main(['build', '--interval=all', 'd']) == 0
    assert (tmp_path / 'idx' / 'all').exists()


def test_query_without_cuda_fails(monkeypatch, tmp_path, capsys):
    """`query` takes the device from DN_TORCH_DEVICE as `scan` does: no
    CUDA, no silent CPU query, whatever route the query would take."""
    from dragnet_tpu_torch import cli
    from dragnet_tpu_torch.errors import DNError
    from dragnet_tpu_torch import query as tquery
    from dragnet_tpu_torch.datasource_file import DatasourceFile
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setenv('DRAGNET_CONFIG', str(tmp_path / 'rc'))
    monkeypatch.delenv('DN_TORCH_DEVICE', raising=False)
    data = tmp_path / 'd.log'
    data.write_text('{"host":"a"}\n')
    assert cli.main(['datasource-add', 'd', '--path=' + str(data),
                     '--index-path=' + str(tmp_path / 'idx')]) == 0
    assert cli.main(['metric-add', '-b', 'host', 'd', 'm']) == 0
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    assert cli.main(['build', '--interval=all', 'd']) == 0
    monkeypatch.delenv('DN_TORCH_DEVICE')
    capsys.readouterr()
    for cmd in (['query', '--interval=all', '-b', 'host', 'd'],
                ['query', '--interval=all', 'd']):
        assert cli.main(cmd) == 1
        assert 'CUDA' in capsys.readouterr().err
    ds = DatasourceFile({'ds_backend': 'file', 'ds_format': 'json',
                         'ds_backend_config': {
                             'path': str(data),
                             'indexPath': str(tmp_path / 'idx')}})
    q = tquery.query_load({'breakdowns': [{'name': 'host'}]})
    with pytest.raises(DNError, match='CUDA'):
        ds.query(q, 'all')
    assert ds.query(q, 'all', device='cpu').points == [({'host': 'a'}, 1)]
    assert ds.query(q, 'all', engine='vector').points == \
        [({'host': 'a'}, 1)]
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    assert cli.main(['query', '--interval=all', '-b', 'host', 'd']) == 0
    assert 'a' in capsys.readouterr().out


@pytest.mark.parametrize('engine', [None, 'auto'])
def test_cli_auto_scan_without_cuda_fails(monkeypatch, tmp_path, capsys,
                                          engine):
    """The default engine (auto) starts on the host by design, but it
    asks for CUDA like the forced lane: without CUDA and without
    DN_TORCH_DEVICE=cpu, scan, build and query fail cleanly before any
    work, and with DN_TORCH_DEVICE=cpu auto is the host engine."""
    from dragnet_tpu_torch import cli
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setenv('DRAGNET_CONFIG', str(tmp_path / 'rc'))
    monkeypatch.delenv('DN_TORCH_DEVICE', raising=False)
    if engine is None:
        monkeypatch.delenv('DN_ENGINE', raising=False)
    else:
        monkeypatch.setenv('DN_ENGINE', engine)
    data = tmp_path / 'd.log'
    data.write_text('{"host":"a"}\n')
    assert cli.main(['datasource-add', 'd', '--path=' + str(data),
                     '--index-path=' + str(tmp_path / 'idx')]) == 0
    assert cli.main(['metric-add', '-b', 'host', 'd', 'm']) == 0
    capsys.readouterr()
    for cmd in (['scan', '-b', 'host', 'd'],
                ['build', '--interval=all', 'd'],
                ['query', '--interval=all', '-b', 'host', 'd']):
        assert cli.main(cmd) == 1
        out, err = capsys.readouterr()
        assert not out and 'CUDA' in err
    assert not (tmp_path / 'idx').exists()
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    assert cli.main(['scan', '-b', 'host', 'd']) == 0
    assert 'a' in capsys.readouterr().out


def test_serve_modules_import_neither_jax_nor_the_jax_package_lazily():
    """The walk reaches serve/**, and no serve module imports jax or the
    JAX package inside a function either (the reference's server
    imports lazily at many sites)."""
    sources = [p for p in _port_sources()
               if os.sep + 'serve' + os.sep in p]
    names = {os.path.basename(p) for p in sources}
    assert {'server.py', 'residency.py', 'client.py', 'admission.py',
            'protocol.py', 'ioloop.py', 'pool.py', 'qcache.py',
            'lifecycle.py'} <= names
    lazy = 0
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    mods = [node.module or ''] if node.level == 0 else []
                    lazy += 1
                else:
                    continue
                for m in mods:
                    assert m.split('.')[0] not in FORBIDDEN, (path, m)
    assert lazy > 10          # the walk saw the lazy imports
