"""The plain reference against the port's CPU path at a tiny size, the
control against the tiny limits, and the reference's independence."""

import ast
import os

import numpy as np
import pytest
import torch

from perfbench import check
from perfbench.generator import Workload
from perfbench.program import Program
from perfbench.reference.planner import judge, make_reference
from perfbench.tests import tiny

CPU = torch.device('cpu')


def f32_parts():
    parts = tiny.parts()
    parts['cfg']['dtype'] = 'float32'
    return parts


def test_rollout_matches_the_program():
    parts = f32_parts()
    cfg, traffic = parts['cfg'], parts['traffic']
    work = Workload(cfg, traffic, tiny.SEED, CPU, parts['arch'])
    prog = Program(cfg, traffic, work.weights, CPU)
    ref = parts['arch'].Reference(cfg, work.weights, 1, CPU)
    x = work.inputs(0)
    model = prog.models[0]
    images = torch.as_tensor(x['images'][0])
    distribs = torch.as_tensor(x['distribs'][0])
    states = torch.as_tensor(x['states'])
    actions = torch.as_tensor(x['actions'])
    plans = 0.1 * torch.randn(4, 5, cfg['adim'])
    latents = torch.randn(4, cfg['latent_dim'])
    with torch.no_grad():
        carry = model.encode_context(images[None], actions[None],
                                     states[None], distribs[None])
        from visual_foresight_torch.models.cdna import broadcast_carry
        got = model.rollout_from(broadcast_carry(carry, 4), plans,
                                 latent=latents)['gen_distribs']
    want = ref.rollout(ref.encode(images, distribs, states, actions), plans,
                       latents)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 1e-5


def test_replan_matches_the_program():
    """The program in float32 against the f32 reference: scores, best
    plans and the carried distributions."""
    parts = f32_parts()
    cfg, traffic = parts['cfg'], parts['traffic']
    work = Workload(cfg, traffic, tiny.SEED, CPU, parts['arch'])
    prog = Program(cfg, traffic, work.weights, CPU)
    records, carried = [], None
    for i in range(4):
        x = work.inputs(i, carried)
        out = prog.replan(x)
        out['distribs'] = x['distribs']
        records.append(out)
        carried = np.swapaxes(out['best_distribs'][-2:], 0, 1)
    ref = make_reference(parts['arch'], cfg, work.weights, traffic, CPU)
    for i in range(4):
        got = judge(ref, traffic, check.replan_inputs(work, records, i),
                    records[i]['scores'], keep_best=True)
        gap = lambda key, want: float(np.abs(records[i][key] - want).max())
        assert gap('scores', got['scores']) < 1e-4
        assert gap('best_actions', got['best_plans']) < 1e-6
        assert gap('best_distribs', got['best_distribs']) < 1e-5


def test_served_reference_sets_the_scale():
    """The bf16 program's score gap is of the size of the served
    reference's, and the control's many times larger."""
    from perfbench.control import read_seed
    line = read_seed(tiny.parts(), 5, 0.3, CPU, True)
    for numbers in line['program'].values():
        assert 0.2 < numbers['score_noise'] < 4
    for numbers in line['control'].values():
        assert numbers['score_noise'] > 8


def test_control_fails_the_tiny_limits():
    """The reference one precision below the program's in its place, on
    three seeds: over the score, plan and distribution limits."""
    from perfbench.control import read_seed
    parts = tiny.parts()
    limits = parts['limits']
    for seed in (5, 6, 7):
        line = read_seed(parts, seed, 0.3, CPU, True)
        numbers = [(i, {n: v for n, v in x.items() if n in limits})
                   for i, x in line['control'].items()]
        checks, failed = check.judged(numbers, limits)
        assert failed == len(numbers), checks
        for name in limits:
            assert checks[name]['value'] > limits[name], name


@pytest.mark.parametrize('folder', ['reference', 'archs'])
def test_reference_imports_nothing_of_the_program(folder):
    """The references, and the architecture modules that hand them out,
    import nothing but PyTorch, numpy, the standard library and the
    references."""
    here = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), folder)
    for name in os.listdir(here):
        if not name.endswith('.py'):
            continue
        with open(os.path.join(here, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or '']
            for mod in mods:
                top = mod.split('.')[0]
                assert top not in ('visual_foresight_torch', 'jax',
                                   'visual_foresight_tpu'), (name, mod)
                assert top in ('torch', 'numpy', 'math', 'collections',
                               'contextlib',
                               'perfbench'), (name, mod)
                if top == 'perfbench':
                    assert mod.startswith('perfbench.reference'), mod
