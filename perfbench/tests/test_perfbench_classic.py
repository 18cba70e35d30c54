"""The classic configuration's plain reference against the program on the
CPU at a tiny size (the classic backbone at 16 x 24 with narrow features, a
latent and propagation): the port's f32 and bf16 rollouts, a tiny replan
judged correct, and faults of the classic step that ``correct`` must catch.

Tolerances: f32 1e-5 (the same f32 arithmetic in another order, as
``test_perfbench_reference.py`` holds the space-to-depth reference); bf16
within ``BF16_RATIO`` times the served reference's own rounding of the f32
reference (the port off the card rounds after every stock op, the served
reference once a stored tensor; the ratio reads 0.8 to 1.4 on four
seeds)."""

import pytest
import torch
import torch.nn.functional as F

from perfbench import program, spec
from perfbench.generator import Workload
from perfbench.program import Program
from perfbench.tests import tiny

CPU = torch.device('cpu')
BF16_RATIO = 3.0


def parts(**traffic):
    """The tiny cell with the classic configuration and architecture."""
    p = tiny.parts(**traffic)
    p['cfg'] = tiny.load('tiny_classic_config.json')
    p['arch'] = spec.arch('classic_cdna')
    p['counts'] = spec.counts('classic_cdna')
    return p


def run(seconds=0.5):
    import time

    from perfbench import run as run_lib
    torch.manual_seed(0)
    return run_lib.run_cell(parts(), tiny.SEED, seconds, 0, CPU,
                            time.perf_counter())


def rollouts(dtype, seed=tiny.SEED):
    """The program's rollout of 4 plans over 5 steps from replan 0's
    context at ``dtype``, and the reference's in each precision."""
    from visual_foresight_torch.models.cdna import broadcast_carry
    p = parts()
    cfg, traffic = dict(p['cfg'], dtype=dtype), p['traffic']
    work = Workload(cfg, traffic, seed, CPU, p['arch'])
    model = Program(cfg, traffic, work.weights, CPU).models[0]
    x = work.inputs(0)
    images, distribs, states, actions = (
        torch.as_tensor(x[k]) for k in ('images', 'distribs', 'states',
                                        'actions'))
    images, distribs = images[0], distribs[0]
    gen = torch.Generator().manual_seed(1)
    plans = 0.1 * torch.randn((4, 5, cfg['adim']), generator=gen)
    latents = torch.randn((4, cfg['latent_dim']), generator=gen)
    with torch.no_grad():
        carry = model.encode_context(images[None], actions[None],
                                     states[None], distribs[None])
        got = model.rollout_from(broadcast_carry(carry, 4), plans,
                                 latent=latents)['gen_distribs']
    refs = {}
    for precision in ('f32', 'served'):
        ref = p['arch'].Reference(cfg, work.weights, 1, CPU, precision)
        refs[precision] = ref.rollout(
            ref.encode(images, distribs, states, actions), plans, latents)
    return got, refs


def test_f32_rollout_matches_the_program():
    got, refs = rollouts('float32')
    assert got.shape == refs['f32'].shape == (4, 5, 16, 24, 1)
    assert float((got - refs['f32']).abs().max()) < 1e-5


@pytest.mark.parametrize('seed', [tiny.SEED, 7])
def test_bf16_rollout_within_the_served_rounding(seed):
    got, refs = rollouts('bfloat16', seed)
    rms = lambda t: float(t.pow(2).mean().sqrt())
    served = rms(refs['served'] - refs['f32'])
    assert served > 0
    assert rms(got - refs['f32']) <= BF16_RATIO * served


def test_tiny_classic_replan_is_correct():
    result = run()
    assert result['correct'] is True and result['failed'] == 0
    assert set(result['checks']) == {'score_noise', 'plan_gap',
                                     'distrib_noise'}


def _flip_dec1(step):
    deconv = step.dec1

    def flipped(x):
        # the kernel flipped: torch's transposed convolution as it comes
        w = deconv.weight.transpose(0, 1)
        out = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, deconv.bias,
                                 stride=2)
        return out[:, :, :-1, :-1].permute(0, 2, 3, 1)
    deconv.forward = flipped


def _drop_ln6(step):
    step.ln6 = torch.nn.Identity()


def _drop_smear(step):
    enc3, f3 = step.enc3, step.f3

    def unconditioned(x):
        x = torch.cat([x[..., :f3], torch.zeros_like(x[..., f3:])], dim=-1)
        return F.linear(x, enc3.weight, enc3.bias)
    enc3.forward = unconditioned


FAULTS = {'flipped-dec1-kernel': _flip_dec1, 'no-ln6': _drop_ln6,
          'no-smear': _drop_smear}


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_classic_fault_is_caught(fault, monkeypatch):
    """Each fault planted in every predictor the program builds: every
    replan checked is over a limit."""
    build = program.build_model

    def faulty(*args, **kw):
        model = build(*args, **kw)
        FAULTS[fault](model.step)
        return model
    monkeypatch.setattr(program, 'build_model', faulty)
    result = run()
    assert result['correct'] is False
    assert result['failed'] == len(result['checked_replans'])


class _Bf16Softmax:
    """``torch`` as ``models/cdna.py`` sees it, with the softmax taken on
    the logits in bf16."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def softmax(x, dim):
        return torch.softmax(x.to(torch.bfloat16), dim=dim)


def test_mask_softmax_in_bf16_leaves_the_served_masks_unchanged(
        monkeypatch):
    """Why a bf16 mask softmax is no fault that ``correct`` could catch:
    the classic step stores its f32 masks in bf16 before the tail, and
    torch's bf16 softmax accumulates in f32 and rounds once, so the
    program's distributions come out the same, bit for bit."""
    from visual_foresight_torch.models import cdna
    want, _ = rollouts('bfloat16')
    monkeypatch.setattr(cdna, 'torch', _Bf16Softmax())
    got, _ = rollouts('bfloat16')
    assert torch.equal(got, want)


def test_control_fails_the_tiny_limits():
    """The reference one precision below the program's in its place, on
    three seeds: every replan checked over the limits."""
    from perfbench import check
    from perfbench.control import read_seed
    p = parts()
    limits = p['limits']
    for seed in (5, 6, 7):
        line = read_seed(p, seed, 0.3, CPU, True)
        numbers = [(i, {n: v for n, v in x.items() if n in limits})
                   for i, x in line['control'].items()]
        checks, failed = check.judged(numbers, limits)
        assert failed == len(numbers), checks
