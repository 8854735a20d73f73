"""Helpers of the port's cross-package parity tests for the clouds,
their provisioners, the Docker runtime and bucket storage.

Each test runs one scenario twice, once through the JAX package and once
through the port, each under a HOME of its own and against fresh
instances of the same fakes (tests/fake_*_api.py, tests/fake_slurm.py,
PATH shims), and compares what both saw: records, statuses as their
values, error classes by name, the fake's state and the HTTP calls it
served.  The provisioning code is host code, so the comparison is exact.
"""
import contextlib
import importlib
import os
import re

PACKAGES = ('skypilot_tpu', 'skypilot_tpu_torch')


class Pkg:
    """One package's modules by their path under it: `pkg('provision')`
    is `skypilot_tpu.provision` or `skypilot_tpu_torch.provision`."""

    def __init__(self, name: str) -> None:
        self.name = name

    def __call__(self, module: str = ''):
        return importlib.import_module(
            f'{self.name}.{module}' if module else self.name)

    def reset_config(self) -> None:
        self('sky_config').reset_cache_for_tests()


def outcome(fn, *args, **kwargs):
    """('ok', value) or ('raise', the error's class name)."""
    try:
        return ('ok', fn(*args, **kwargs))
    except Exception as e:  # pylint: disable=broad-except
        return ('raise', type(e).__name__)


def statuses(mapping) -> dict:
    """An instance-status map with the enums as their values."""
    return {k: v.value for k, v in mapping.items()}


def record_calls(fake) -> list:
    """Make the fake HTTP server log each request it serves as (method,
    path); returns the log.  The server builds one handler object per
    request from its RequestHandlerClass, so a subclass swapped in sees
    every later request."""
    calls = []
    base = fake.server.RequestHandlerClass

    class Recording(base):  # pylint: disable=too-few-public-methods
        def parse_request(self):
            ok = super().parse_request()
            if ok:
                calls.append((self.command, self.path))
            return ok

    fake.server.RequestHandlerClass = Recording
    return calls


def normalized(calls) -> list:
    """The call log with the fake EC2's run-specific instance ids
    replaced by a placeholder."""
    return [(method, re.sub(r'i-[0-9a-f]{12}', 'i-ID', path))
            for method, path in calls]


@contextlib.contextmanager
def package_home(pkg: Pkg, root, monkeypatch):
    """HOME, the config files and the config caches of one package's run
    of a scenario, under `root`."""
    home = root / pkg.name / 'home'
    home.mkdir(parents=True)
    monkeypatch.setenv('HOME', str(home))
    monkeypatch.setenv('SKYTPU_GLOBAL_CONFIG',
                       str(home / '.skytpu' / 'config.yaml'))
    monkeypatch.setenv('SKYTPU_PROJECT_CONFIG', str(home / '.skytpu.yaml'))
    pkg.reset_config()
    try:
        yield home
    finally:
        pkg.reset_config()


def run_both(scenario, root, monkeypatch, fakes=()):
    """scenario(pkg, *fake_objects) once per package, each under its own
    HOME with a fresh instance of each fake: `fakes` holds (factory,
    env var) pairs, the env var set to the fake's endpoint.  Returns the
    two results, the JAX package's first."""
    results = []
    for name in PACKAGES:
        pkg = Pkg(name)
        made = []
        try:
            for factory, env in fakes:
                fake = factory()
                made.append(fake)
                if env:
                    monkeypatch.setenv(env, fake.endpoint)
            with package_home(pkg, root, monkeypatch):
                results.append(scenario(pkg, *made))
        finally:
            for fake in made:
                fake.close()
    return results


def shim(directory, name: str, text: str) -> str:
    """An executable `name` in `directory` holding `text`."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name)
    with open(path, 'w', encoding='utf-8') as f:
        f.write(text)
    os.chmod(path, 0o755)
    return path
