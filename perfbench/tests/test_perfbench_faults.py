"""A tiny run with the timed path broken underneath comes out not
correct, once for each fault a cell can have; the card test reads the
control and the faults at a cell's own size."""

import pytest
import torch

from perfbench import check, faults
from perfbench.tests import tiny


@pytest.mark.parametrize('fault', faults.FAULTS)
def test_fault_is_caught(fault):
    with faults.planted(fault):
        result = tiny.run(seconds=0.5)
    assert result['correct'] is False
    assert result['failed'] >= 1


def test_sound_run_is_correct():
    result = tiny.run(seconds=0.5)
    assert result['correct'] is True


@pytest.mark.cuda
@pytest.mark.parametrize('cell', ['ag_r5f_v2.ag_bench20'])
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from perfbench import spec
    from perfbench.control import read_seed
    parts = spec.resolve(spec.benchmark(), cell)
    for seed in (101, 102, 103):
        line = read_seed(parts, seed, 3.0, torch.device('cuda', 0), True)
        compared = lambda side: [
            (i, {n: v for n, v in numbers.items() if n in parts['limits']})
            for i, numbers in line[side].items()]
        assert check.judged(compared('program'), parts['limits'])[1] == 0
        assert check.judged(compared('control'), parts['limits'])[1] >= 1
