"""The port's placement validation (skypilot_tpu_torch/parallel/
validate.py) on H100 sizes: mirrors of tests/test_placement_validate.py's
analytic tests (a 70B refused on one node of 8 and accepted across
several, an 8B fitting 8 GPUs and not one, several nodes giving a `dcn`
axis, an unknown model refused, tensor against fsdp within rel 0.2),
the compiled tier refused, the state bytes held against the JAX
module's analytic count where both count the same thing, and no JAX
imported."""
import os
import subprocess
import sys

import pytest

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.parallel import validate as validate_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_70b_rejected_on_one_node():
    report = validate_lib.validate_placement('H100:8',
                                             model_name='llama3-70b',
                                             batch=8, seq=2048)
    assert not report.fits
    # Even params+optimizer alone exceed one 80 GB card.
    assert report.breakdown['params+optimizer_state'] > \
        report.hbm_bytes_per_device
    assert 'DOES NOT FIT' in report.summary()


@pytest.mark.parametrize('accelerator,n', [('H100:128', 128),
                                           ('H100:64x2', 128)])
def test_70b_accepted_across_nodes(accelerator, n):
    report = validate_lib.validate_placement(accelerator,
                                             model_name='llama3-70b',
                                             batch=256, seq=2048)
    assert report.fits
    assert report.mesh_plan.num_devices == n
    assert 0 < report.utilization < 1


def test_8b_fits_h100x8_not_h100x1():
    small = validate_lib.validate_placement('H100:1',
                                            model_name='llama3-8b')
    assert not small.fits
    big = validate_lib.validate_placement('H100:8', model_name='llama3-8b',
                                          batch=16)
    assert big.fits


def test_multinode_plan_gets_dcn_axis():
    report = validate_lib.validate_placement('H100:8x2',
                                             model_name='llama3-8b',
                                             batch=32)
    assert report.mesh_plan.dcn == 2
    assert report.mesh_plan.num_devices == 16
    assert report.fits


def test_unknown_model_rejected():
    with pytest.raises(exceptions.InvalidRequestError):
        validate_lib.validate_placement('H100:8', model_name='nope')
    with pytest.raises(exceptions.InvalidRequestError):
        validate_lib.validate_placement('tpu-v5e-8')


def test_tensor_axis_shrinks_per_device_state():
    base = validate_lib.validate_placement('H100:16',
                                           model_name='llama3-8b',
                                           batch=16)
    tp = validate_lib.validate_placement('H100:16', model_name='llama3-8b',
                                         batch=16, fsdp=4, tensor=4)
    # fsdp x tp shards params over all 16 devices either way.
    assert tp.breakdown['params+optimizer_state'] == pytest.approx(
        base.breakdown['params+optimizer_state'], rel=0.2)


def test_compile_tier_refused():
    with pytest.raises(ValueError, match='PJRT TPU topology'):
        validate_lib.validate_placement('H100:8', model_name='tiny',
                                        compile=True)


def test_state_bytes_match_the_jax_analytic_count():
    """The same plan's state bytes as the JAX module's analytic tier
    counts them (params + AdamW moments; the optimizer's step counters
    differ in size: optax keeps one int32 per moment tree, AdamW one f32
    per parameter)."""
    from skypilot_tpu.parallel import validate as jv
    for kw in (dict(), dict(fsdp=2, tensor=4)):
        want = jv.validate_placement('tpu-v5e-8', model_name='llama3-8b',
                                     **kw).breakdown
        got = validate_lib.validate_placement('H100:8',
                                              model_name='llama3-8b',
                                              **kw).breakdown
        assert got['gradients'] == want['gradients']
        assert got['activations_est'] == want['activations_est']
        assert got['params+optimizer_state'] == pytest.approx(
            want['params+optimizer_state'], rel=1e-6)


def test_validate_imports_no_jax():
    code = ('import sys\n'
            'from skypilot_tpu_torch.parallel import validate\n'
            'r = validate.validate_placement("H100:8")\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "flax", "skypilot_tpu")]\n'
            'assert not bad, bad\n'
            'print(r.fits)\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'True'
