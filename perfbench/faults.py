"""Faults planted under the timed path, to show that ``correct`` catches
them (``perfbench/tests/test_perfbench_faults.py`` on the CPU, and
``perfbench/control.py --fault`` on the card).

- ``static_step``: every predictor step returns its state unchanged;
- ``half_batch``: a rollout runs the first half of the samples and the
  rest take copies of their results;
- ``altered_answer``: the best plan's first action is shifted where the
  planner returns it.

The exchange between chips has no fault here: every cell runs on one chip.
"""

import contextlib

import torch

FAULTS = ('static_step', 'half_batch', 'altered_answer')
SHIFT = 1e-2            # the altered action's shift


@contextlib.contextmanager
def planted(fault):
    """Within the block, the program runs with ``fault``."""
    from visual_foresight_torch.models.cdna import CDNAStep
    from visual_foresight_torch.planners.cem import FusedCEMPlanner
    if fault not in FAULTS:
        raise ValueError('unknown fault {}; have {}'.format(fault, FAULTS))
    if fault == 'static_step':
        owner, name = CDNAStep, 'forward'

        def patched(self, carry, x, plan_mode=True, decode=None):
            return carry, (carry[1], carry[2], carry[3])
    elif fault == 'half_batch':
        owner, name = FusedCEMPlanner, '_rollout'
        original = FusedCEMPlanner._rollout

        def patched(models, carries, plan, latent=None):
            b = plan.shape[0]
            half = (b + 1) // 2
            cut = lambda t: t if t is None else t[:half]
            outs = original(models, [_rows(c, half) for c in carries],
                            plan[:half], cut(latent))
            spread = lambda t: torch.cat([t, t], dim=0)[:b]
            return (spread(outs[0]), spread(outs[1]),
                    torch.cat([outs[2], outs[2]], dim=1)[:, :b])
        patched = staticmethod(patched)
    else:
        owner, name = FusedCEMPlanner, 'replan'
        original = FusedCEMPlanner.replan

        def patched(self, *args, **kw):
            out = original(self, *args, **kw)
            out['best_actions'] = out['best_actions'].clone()
            out['best_actions'][0, 0, 0] += SHIFT
            return out
    saved = owner.__dict__[name]
    setattr(owner, name, patched)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def _rows(carry, n):
    if isinstance(carry, tuple):
        return tuple(_rows(t, n) for t in carry)
    return None if carry is None else carry[:n]
