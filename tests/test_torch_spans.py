"""The replan's phase spans (``utils/profiling.py::span``): a tiny CPU
replan under ``torch.profiler`` records them with the nesting and counts
that ``planners/cem.py`` and ``models/cdna.py`` promise, in each sampling
mode; with the profiler off the replan opens no ``record_function``; and
the profiler changes no output."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.models.cdna import CDNAPredictor
from visual_foresight_torch.planners import costs, gaussian
from visual_foresight_torch.planners.cem import FusedCEMPlanner
from visual_foresight_torch.utils import profiling

H, W = 16, 32
M, K, ITERS, N_CTX = 16, 4, 3, 2
HP = {'initial_std': 0.05, 'initial_std_lift': 0.15,
      'initial_std_rot': np.pi / 18, 'initial_std_grasp': 2, 'nactions': 2,
      'repeat': 2, 'action_order': ['x', 'z', 'grasp']}
MPPI = {'kappa': 1.0, 'beta_0': 0.5, 'beta_1': 0.5, 'refit_cov': False,
        'mean_bias': None, 'per_dim_std': (0.05, 0.2, 1.0)}
CHUNK = 8
# mode: (planner options, cameras, latent dim)
MODES = {'gaussian': ({}, 2, 0), 'mppi': ({'mppi': MPPI}, 1, 0),
         'chunked': ({'sample_chunk': CHUNK}, 1, 0),
         'latent': ({}, 1, 2)}


def _setup(mode):
    opts, ncam, latent_dim = MODES[mode]
    torch.manual_seed(3)
    models = [CDNAPredictor((H, W), n_context=N_CTX, num_distribs=1,
                            num_masks=4, enc_features=(8, 16, 16),
                            lstm_kernel=3, separable_lstm=True,
                            std_factor=4, latent_dim=latent_dim).eval()
              for _ in range(ncam)]
    spec = gaussian.make_action_spec(HP, 3)
    planner = FusedCEMPlanner(spec, M, iterations=ITERS, k_elite=K,
                              n_vis=2, device='cpu', **opts)
    rng = np.random.RandomState(9)
    distribs = np.zeros((ncam, N_CTX, H, W, 1), np.float32)
    distribs[:, :, 8, 16, 0] = 1.0
    goal = np.tile(np.array([[[4.0, 25.0]]], np.float32), (ncam, 1, 1))
    args = (models, rng.rand(ncam, N_CTX, H, W, 3).astype(np.float32),
            np.zeros((N_CTX, 3), np.float32), distribs,
            np.zeros((N_CTX - 1, 3), np.float32),
            costs.distance_grid(goal, H, W),
            np.zeros(spec.nactions * spec.adim, np.float32),
            gaussian.initial_sigma(spec).numpy())
    return planner, args, ncam


def _replan(planner, args, seed=5):
    return planner.replan(*args,
                          generator=torch.Generator().manual_seed(seed))


def _vf_spans(prof):
    """(name, parent names outermost first) of each host ``vf.*`` span,
    in start order."""
    events = sorted(((e.start_ns(), -e.duration_ns(), e.name())
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith('vf.')))
    out, stack = [], []
    for start, neg, name in events:
        while stack and stack[-1][1] <= start:
            stack.pop()
        out.append((name, tuple(n for n, _ in stack)))
        stack.append((name, start - neg))
    return out


@pytest.mark.parametrize('mode', sorted(MODES))
def test_replan_records_its_phase_spans(mode):
    planner, args, ncam = _setup(mode)
    replans = 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(replans):
            horizon = _replan(planner, args, seed=i)['best_actions'].shape[1]
    spans = _vf_spans(prof)
    count = lambda name, inside=None: sum(
        1 for n, parents in spans
        if n == name and (inside is None or inside in parents)) / replans

    assert count('vf.replan') == 1
    assert all(parents[:1] == ('vf.replan',) for name, parents in spans
               if name != 'vf.replan')
    assert not any('vf.replan' in parents for name, parents in spans
                   if name == 'vf.replan')
    assert count('vf.encode') == 1
    assert count('vf.step', 'vf.encode') == ncam * (N_CTX - 1)
    assert count('vf.inputs') == 1 + ITERS
    for name in ('vf.sample', 'vf.select'):
        assert count(name) == ITERS, name
    assert count('vf.refit') == ITERS - 1
    assert count('vf.vis') == 1
    rollouts = ITERS * (M // CHUNK) + 1 if mode == 'chunked' else ITERS
    assert count('vf.rollout') == rollouts
    assert count('vf.rollout', 'vf.vis') == (mode == 'chunked')
    assert count('vf.score') == (ITERS * (M // CHUNK)
                                 if mode == 'chunked' else ITERS)
    assert count('vf.step', 'vf.rollout') == rollouts * horizon * ncam
    assert count('vf.step') == (rollouts * horizon + N_CTX - 1) * ncam
    # phases of one iteration do not nest in one another
    flat = {'vf.inputs', 'vf.sample', 'vf.select', 'vf.refit', 'vf.score'}
    assert not any(set(parents) & flat for _, parents in spans)


class _Counted(torch.profiler.record_function):
    opened = 0

    def __init__(self, *args, **kwargs):
        type(self).opened += 1
        super().__init__(*args, **kwargs)


def test_replan_opens_no_record_function_with_the_profiler_off(
        monkeypatch):
    monkeypatch.setattr(_Counted, 'opened', 0)
    monkeypatch.setattr(torch.profiler, 'record_function', _Counted)
    monkeypatch.setattr(torch.autograd.profiler, 'record_function',
                        _Counted)
    planner, args, _ = _setup('gaussian')
    _replan(planner, args)
    assert _Counted.opened == 0
    assert profiling.span('a') is profiling.span('b', '1')
    # the patch is seen: the same replan under the profiler opens spans
    with profile(activities=[ProfilerActivity.CPU]):
        _replan(planner, args)
    assert _Counted.opened > 0


@pytest.mark.parametrize('mode', ['chunked', 'latent'])
def test_replan_is_bit_for_bit_the_same_under_the_profiler(mode):
    planner, args, _ = _setup(mode)
    off = _replan(planner, args)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _replan(planner, args)
    for key in ('best_actions', 'best_scores', 'scores_per_itr', 'mean',
                'sigma'):
        assert torch.equal(on[key], off[key]), key
    for key in ('indices', 'gen_images', 'gen_distribs', 'scores'):
        assert torch.equal(on['vis'][key], off['vis'][key]), key
