"""The comparison behind ``correct``: replans of the window, drawn from the
seed, recomputed by the plain reference and compared number by number.

For each replan checked, the reference recomputes, along the elites that
the program's own scores select (ties in a lower precision may order elites
otherwise, and one other elite changes every later plan), every sample's
score, the plans and the best plan's predicted distributions twice: in
float32, and with what a bf16 serving path stores rounded to bf16
('served').  The second sets the scale: how far the configuration's
precision itself moves a replan under the seed's weights, which differ
from seed to seed by a factor of ten.

- ``score_noise``: the root mean square gap between the program's scores
  and the f32 reference's, over every sample of every iteration, in units
  of the same gap of the served reference;
- ``plan_gap``: the widest gap between the program's best actions and the
  reference's plans at the elites of the last iteration;
- ``distrib_noise`` (under ``predictor_propagation``): the median over
  the steps of the root mean square gap of the best plan's predicted
  distributions, which the next replan takes as its context, in the same
  units.

The replans checked are the window's first (an episode's start, from the
one-hot pixel) and ``check_replans - 1`` more drawn from the seed.
"""

import numpy as np

from perfbench.reference.planner import judge, make_reference

CHECK_STREAM = 7


def picks(seed, n, count):
    """Indices of the replans checked among ``n``: 0 and ``count - 1`` more
    drawn without replacement from the seed."""
    rng = np.random.default_rng(
        np.random.SeedSequence([abs(int(seed)), int(seed < 0),
                                CHECK_STREAM]))
    rest = rng.choice(np.arange(1, n), size=min(count - 1, n - 1),
                      replace=False) if n > 1 else []
    return [0] + sorted(int(i) for i in rest)


def _rms(x):
    return float(np.sqrt(np.mean(np.square(x))))


def gaps(traffic, got, ref, served):
    """The numbers compared, for one replan: ``got`` holds 'scores',
    'best_actions' (and 'best_distribs'); ``ref`` and ``served`` are the
    f32 and the served reference's results."""
    scale = _rms(served['scores'] - ref['scores'])
    out = {'score_noise': _rms(got['scores'] - ref['scores']) / scale,
           'plan_gap': float(np.max(np.abs(got['best_actions'] -
                                           ref['best_plans'])))}
    if traffic['predictor_propagation']:
        out['distrib_noise'] = _step_median(got, ref) / \
            _step_median(served, ref)
    return out


def _step_median(got, ref):
    """The median over the steps of the root mean square gap of the best
    plan's predicted distributions: one step at which a kernel weight or a
    mask crosses a rounding edge moves no median."""
    gap = got['best_distribs'] - ref['best_distribs']
    steps = gap.reshape(gap.shape[0], -1)
    return float(np.median(np.sqrt(np.mean(np.square(steps), axis=1))))


def replan_inputs(work, records, i):
    """Replan ``i``'s inputs as the program got them, on the host."""
    x = work.inputs(i, records[i]['distribs'])
    x['grids'] = x['grids'].cpu().numpy()
    x['noise'] = x['noise'].cpu().numpy()
    for key in ('latents', 'vis_latents'):
        if x[key] is not None:
            x[key] = x[key].cpu().numpy()
    return x


def references(arch, cfg, traffic, work, records, chosen, device, block):
    """The f32 and the served reference of ``arch`` (the configuration's
    architecture module): their results on the replans ``chosen``, along
    the program's elites, as a list of (f32, served)."""
    keep = traffic['predictor_propagation']
    refs = [make_reference(arch, cfg, work.weights, traffic, device,
                           precision=p) for p in ('f32', 'served')]
    return [tuple(judge(ref, traffic, replan_inputs(work, records, i),
                        records[i]['scores'], block=block, keep_best=keep)
                  for ref in refs) for i in chosen]


def verify(arch, cfg, traffic, work, records, seed, device, block):
    """The numbers of each replan checked: a list of (index, {name:
    value})."""
    chosen = picks(seed, len(records), traffic['check_replans'])
    both = references(arch, cfg, traffic, work, records, chosen, device,
                      block)
    return [(i, gaps(traffic, records[i], ref, served))
            for i, (ref, served) in zip(chosen, both)]


def judged(per_replan, limits):
    """(name -> {'value', 'limit'} with the widest value of each number
    over the replans checked, the count of replans with a number over its
    limit).  A number that is not finite is over its limit."""
    names = sorted({n for _, numbers in per_replan for n in numbers})
    missing = sorted(set(names) - set(limits))
    if missing:
        raise KeyError('no limit for {}'.format(missing))
    over = lambda n, v: not (np.isfinite(v) and v <= limits[n])
    failed = sum(any(over(n, v) for n, v in numbers.items())
                 for _, numbers in per_replan)
    checks = {}
    for n in names:
        values = [numbers[n] for _, numbers in per_replan]
        bad = [v for v in values if not np.isfinite(v)]
        checks[n] = {'value': bad[0] if bad else max(values),
                     'limit': limits[n]}
    return checks, failed
