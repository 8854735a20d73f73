"""Bucket storage of the port against the JAX package's: the GCS store's
lifecycle, `.skyignore`, named and sourced storage mounts, the mount and
copy commands, a task's `storage_mounts` and bucket `file_mounts`
applied to a local cluster through each package's backend, and the
storage CLI, each scenario run through both packages under HOMEs and
fake-GCS roots of their own and compared exactly (mirrors
tests/test_storage.py's bucket cases).  One case launches a port task
with a MOUNTed bucket end to end on the local cloud (the port's agent
only)."""
import os
import time

from tests.torch_parity import outcome, run_both
from torch_control import kill_with_env, reap_marked  # noqa: F401


def _fake_gcs(pkg, tmp_path, monkeypatch):
    root = tmp_path / pkg.name / 'fake-gcs'
    monkeypatch.setenv('SKYTPU_FAKE_GCS_ROOT', str(root))
    return root


def _src(root):
    src = root / 'src'
    (src / 'sub').mkdir(parents=True)
    (src / 'secrets').mkdir()
    (src / 'a.txt').write_text('A')
    (src / 'sub' / 'b.txt').write_text('B')
    (src / 'noise.log').write_text('x')
    (src / 'secrets' / 'key.pem').write_text('x')
    (src / '.skyignore').write_text('*.log\nsecrets/\n# comment\n')
    return src


def _tree(root):
    """{relative path: text} of every file under `root`, links followed."""
    out = {}
    for dirpath, _, files in os.walk(root, followlinks=True):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, encoding='utf-8') as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _both(scenario, tmp_path, monkeypatch):
    jax_side, port_side = run_both(scenario, tmp_path, monkeypatch)
    assert port_side == jax_side
    return port_side


def test_bucket_lifecycle_skyignore_and_named_mounts(tmp_path, monkeypatch):
    def scenario(pkg):
        storage = pkg('data.storage')
        root = _fake_gcs(pkg, tmp_path, monkeypatch)
        src = _src(tmp_path / pkg.name)
        out = {}
        store = storage.GcsStore('my-bucket')
        seen = [store.exists()]
        store.create()
        seen.append(store.exists())
        store.sync_up(str(src))
        seen.append(store.list_prefix())
        down = tmp_path / pkg.name / 'down'
        store.sync_down(str(down))
        seen.append(_tree(down))
        store.delete()
        seen.append(store.exists())
        out['lifecycle'] = seen
        out['bad_name'] = outcome(storage.GcsStore, 'bad/name')
        mount = storage.StorageMount.from_yaml_config(
            '/data', {'name': 'managed-bkt', 'source': str(src),
                      'mode': 'MOUNT'})
        out['named'] = (mount.materialize(), mount.mode.value,
                        storage.GcsStore('managed-bkt').list_prefix())
        out['no_source'] = outcome(storage.StorageMount.from_yaml_config,
                                   '/data', {'mode': 'MOUNT'})
        out['bad_store'] = outcome(storage.StorageMount.from_yaml_config,
                                   '/data', {'name': 'b', 'store': 'ftp'})
        out['fake_cmds'] = [
            c.replace(str(root), 'ROOT') for c in (
                storage.mount_command('gs://bkt/ckpts', '/mnt/ck'),
                storage.copy_command('gs://bkt/ckpts', '/dst'))]
        with monkeypatch.context() as m:
            m.delenv('SKYTPU_FAKE_GCS_ROOT')
            out['real_cmds'] = [
                storage.mount_command('gs://bkt', '/mnt/ck'),
                storage.mount_command('gs://bkt', '/mnt/ck', cached=True),
                storage.copy_command('gs://bkt/ckpts', '/dst'),
                outcome(storage.mount_command, 'ftp://bkt', '/mnt')]
        return out

    out = _both(scenario, tmp_path, monkeypatch)
    assert out['lifecycle'][2] == ['a.txt', 'sub/b.txt']
    assert out['bad_name'] == ('raise', 'StorageError')
    assert out['named'] == ('gs://managed-bkt', 'MOUNT',
                            ['a.txt', 'sub/b.txt'])
    assert out['no_source'] == ('raise', 'StorageError')
    assert 'ln -sfn' in out['fake_cmds'][0]
    assert 'gcsfuse' in out['real_cmds'][1]


def test_storage_mounts_and_bucket_file_mounts_on_a_cluster(tmp_path,
                                                            monkeypatch):
    """A task's storage_mounts (MOUNT of an existing bucket, COPY, and a
    named bucket made from a local source) and a bucket file mount,
    applied to a local cluster by each package's backend: the same files
    appear at the same places under the cluster's agent home, and a write
    through the MOUNT lands in the bucket.  The port's
    `mount_storage_mounts` and bucket fetch are the original's (before
    this slice its data/storage.py lacked them)."""
    def scenario(pkg):
        storage = pkg('data.storage')
        root = _fake_gcs(pkg, tmp_path, monkeypatch)
        src = _src(tmp_path / pkg.name)
        storage.GcsStore('ckpts').create()
        storage.GcsStore('ckpts').sync_up(str(src), 'run1')
        handle = pkg('global_user_state').ClusterHandle(
            'mt', 'local', 'local', 'local', {'infra': 'local'}, 1,
            [['127.0.0.1']], ['node-0'])
        backend = pkg('backends').TpuVmBackend()
        storage.mount_storage_mounts(backend, handle, {
            '/ckpt': {'source': 'gs://ckpts/run1', 'mode': 'MOUNT'},
            '/copy': {'source': 'gs://ckpts/run1', 'mode': 'COPY'},
            '/named': {'name': 'fresh', 'source': str(src)}})
        # A bucket file mount's destination is taken as it is, on the
        # local cloud too (no agent-home translation, as in the JAX
        # backend), so it points into this package's directory.
        fetched = str(tmp_path / pkg.name / 'fetched')
        backend.sync_file_mounts(handle, {fetched: 'gs://ckpts/run1'})
        home = backend._agent_home(handle)  # pylint: disable=protected-access
        with open(os.path.join(home, 'ckpt', 'written.txt'), 'w',
                  encoding='utf-8') as f:
            f.write('through the mount')
        return {
            'links': {d: (os.path.islink(os.path.join(home, d)),
                          os.path.realpath(os.path.join(home, d)).replace(
                              str(root), 'ROOT').replace(home, 'HOME'))
                      for d in ('ckpt', 'copy', 'named')},
            'trees': {os.path.basename(d): _tree(os.path.join(home, d))
                      for d in ('ckpt', 'copy', 'named', fetched)},
            'bucket': storage.GcsStore('ckpts').list_prefix('run1')}

    out = _both(scenario, tmp_path, monkeypatch)
    assert out['links']['ckpt'] == (True, 'ROOT/ckpts/run1')
    assert out['links']['copy'] == (False, 'HOME/copy')
    assert out['trees']['copy'] == {'a.txt': 'A', 'sub/b.txt': 'B'}
    assert out['trees']['fetched'] == out['trees']['copy']
    assert 'run1/written.txt' in out['bucket']


def test_storage_cli_crud(tmp_path, monkeypatch):
    """`storage create/upload/ls/download/delete` of each package's CLI
    over the fake store: the same exit codes and output."""
    from click.testing import CliRunner

    def scenario(pkg):
        root = _fake_gcs(pkg, tmp_path, monkeypatch)
        root.mkdir(parents=True)
        src = _src(tmp_path / pkg.name)
        down = tmp_path / pkg.name / 'down'
        cli = pkg('client.cli').cli
        runner = CliRunner()
        results = []
        for args in (['create', 'clib'], ['upload', 'clib', str(src)],
                     ['ls', 'clib'], ['download', 'clib', str(down)],
                     ['delete', 'clib', '--yes'], ['ls', 'clib']):
            r = runner.invoke(cli, ['storage'] + args)
            results.append((r.exit_code, r.output.replace(
                str(tmp_path / pkg.name), 'ROOT')))
        return results, _tree(down)

    results, tree = _both(scenario, tmp_path, monkeypatch)
    assert [code for code, _ in results][:5] == [0] * 5
    assert results[5][0] != 0
    assert tree == {'a.txt': 'A', 'sub/b.txt': 'B'}


def test_port_task_with_storage_mounts_launches(tmp_home, tmp_path,
                                                monkeypatch):
    """A port task whose `storage_mounts` MOUNTs a bucket, launched on
    the local cloud under the fake-GCS root: the job reads the bucket's
    file through the mount and its write lands in the bucket."""
    from skypilot_tpu_torch import core, execution, global_user_state
    from skypilot_tpu_torch import sky_config
    from skypilot_tpu_torch.agent.job_queue import JobStatus
    from skypilot_tpu_torch.data import storage
    from skypilot_tpu_torch.resources import Resources
    from skypilot_tpu_torch.task import Task

    monkeypatch.setenv('SKYTPU_ENABLED_CLOUDS', 'local')
    monkeypatch.setenv('SKYTPU_AGENT_PID_FILE', str(tmp_path / 'pids.txt'))
    sky_config.reset_cache_for_tests()
    root = tmp_path / 'fake-gcs'
    monkeypatch.setenv('SKYTPU_FAKE_GCS_ROOT', str(root))
    src = _src(tmp_path)
    storage.GcsStore('weights').create()
    storage.GcsStore('weights').sync_up(str(src), 'w1')
    task = Task('reader', run=(
        'cat "$SKYTPU_AGENT_HOME/mnt/w/sub/b.txt" && '
        'echo written > "$SKYTPU_AGENT_HOME/mnt/w/out.txt"'),
        storage_mounts={'/mnt/w': {'source': 'gs://weights/w1',
                                   'mode': 'MOUNT'}})
    task.set_resources(Resources.from_yaml_config({'infra': 'local'}))
    try:
        job_id, _ = execution.launch(task, 'smt', detach_run=True,
                                     quiet_optimizer=True)
        deadline = time.monotonic() + 60
        while True:
            rec = next(j for j in core.queue('smt')
                       if j['job_id'] == job_id)
            if JobStatus(rec['status']).is_terminal():
                break
            assert time.monotonic() < deadline, rec
            time.sleep(0.2)
        assert JobStatus(rec['status']) is JobStatus.SUCCEEDED
        assert (root / 'weights' / 'w1' / 'out.txt').read_text() == (
            'written\n')
    finally:
        if global_user_state.get_cluster('smt') is not None:
            core.down('smt')
        kill_with_env(f'HOME={tmp_home}')
        sky_config.reset_cache_for_tests()
