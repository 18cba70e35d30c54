"""CEM controller base class (PyTorch port).

Counterpart of ``visual_foresight_tpu/policy/cem_controllers/
cem_base_controller.py``: the hparam table shared by every CEM-family
controller, the elite count, the warm-up actions before planning starts,
the replan schedule, ``act``, and the host iterate-score-refit loop over a
pluggable sampler (``perform_CEM``), where subclasses provide
``evaluate_rollouts``.  Subclasses that plan on the device override
``perform_CEM``.

The samplers' host draws come from one ``np.random.RandomState`` seeded from
the ``seed`` hparam (0 where a controller has none), shared by every sampler
the controller makes, so that its draws run through one stream as the JAX
package's run through the global ``np.random``.

Hparam names and defaults match the reference so its experiment configs load
unmodified.
"""

import numpy as np

from visual_foresight_torch.policy.policy import Policy
from visual_foresight_torch.utils.logger import Logger
from .samplers.gaussian_sampler import GaussianCEMSampler

# Planning knobs shared by every CEM-family controller.  Names are public
# API (experiment hparams files set them); values mirror the reference.
_CEM_DEFAULTS = dict(
    append_action=None,             # constant dims appended to every action
    verbose=True,
    verbose_every_iter=False,
    logging_dir='',
    hard_coded_start_action=None,
    context_action_weight=[0.5, 0.5, 0.05, 1],
    zeros_for_start_frames=True,
    replan_interval=0,              # 0 = replan every step
    sampler=GaussianCEMSampler,
    T=15,                           # planning horizon
    iterations=3,
    num_samples=200,
    sample_chunk=0,                 # >0: device microbatch over the sample axis
    stochastic_penalty=0.0,         # >0 with stochastic_planning=(K,): elite
                                    # selection on mean + lambda*std across the
                                    # K latent copies of each unique plan
    selection_frac=0.,              # elite fraction (0 = minimum_selection)
    start_planning=0,
    minimum_selection=10,
)


class CEMBaseController(Policy):
    """Iterative stochastic plan optimizer (cross-entropy method)."""

    def __init__(self, ag_params, policyparams):
        self._hp = self._default_hparams()
        self._override_defaults(policyparams)
        self.agentparams = ag_params

        if self._hp.logging_dir:
            logname = 'cem{}log.txt'.format(ag_params.get('gpu_id', 0))
            self._logger = Logger(self._hp.logging_dir, logname)
        else:
            self._logger = Logger(printout=True)
        self._logger.log('init CEM controller')

        self._adim, self._sdim = ag_params['adim'], ag_params['sdim']
        self._n_iter = self._hp.iterations
        self._np_rng = np.random.RandomState(
            int(self._hp.seed) if 'seed' in self._hp else 0)
        self._t = None
        self._state = None
        self._t_since_replan = None
        self._sampler = None
        self._best_indices = None
        self._best_actions = None
        if self._hp.minimum_selection <= 0:
            raise AssertionError('must select at least one elite for refitting')

    def _default_hparams(self):
        hp = super()._default_hparams()
        for name, default in _CEM_DEFAULTS.items():
            hp.add_hparam(name, default)
        return hp

    def _override_defaults(self, policyparams):
        # the chosen sampler contributes its own hparams to the controller's
        # namespace before user overrides are applied
        sampler_cls = policyparams.get('sampler', GaussianCEMSampler)
        for name, value in sampler_cls.get_default_hparams().items():
            if name in self._hp:
                print('Warning: default value for {} already set'.format(name))
                self._hp.set_hparam(name, value)
            else:
                self._hp.add_hparam(name, value)
        super()._override_defaults(policyparams)
        self._hp.sampler = sampler_cls

    def reset(self):
        self._sampler = self._make_sampler()
        self._best_indices = self._best_actions = None
        self._t_since_replan = None
        self.plan_stat = {}

    @property
    def elite_count(self):
        """Number of top-scoring plans kept for distribution refitting."""
        by_frac = int(self._hp.selection_frac * self._hp.num_samples)
        return max(by_frac, self._hp.minimum_selection)

    def _make_sampler(self):
        return self._hp.sampler(self._hp, self._adim, self._sdim,
                                rng=self._np_rng)

    def _append_dims(self, actions):
        """Concatenate the constant ``append_action`` dims onto every plan."""
        n, horizon = actions.shape[:2]
        tail = np.broadcast_to(
            np.asarray(self._hp.append_action, dtype=actions.dtype),
            (n, horizon, len(self._hp.append_action)))
        return np.concatenate([actions, tail], axis=-1)

    def perform_CEM(self, state):
        """Run the full iterate-score-refit loop; leaves the elite set in
        ``self._best_actions`` (sorted best-first) and resets the replan
        clock."""
        self._logger.log('starting cem at t{}...'.format(self._t))
        K = self.elite_count
        actions = self._sampler.sample_initial_actions(
            self._t, self._hp.num_samples, state[-1])

        for itr in range(self._n_iter):
            if self._hp.append_action:
                actions = self._append_dims(actions)
            self._logger.log('iteration: ', itr)

            scores = self.evaluate_rollouts(actions, itr)
            if scores.shape != (actions.shape[0],):
                raise AssertionError('score shape should be (n_actions,)')

            order = np.argsort(scores)
            self._best_indices = order[:K]
            self._best_actions = actions[self._best_indices]
            self.plan_stat['scores_itr{}'.format(itr)] = scores

            last_iter = itr == self._n_iter - 1
            if not last_iter:
                elites = self._best_actions.copy()
                if self._hp.append_action:
                    # refit only over the sampled dims
                    elites = elites[..., :-len(self._hp.append_action)]
                actions = self._sampler.sample_next_actions(
                    self._hp.num_samples, elites,
                    scores[self._best_indices].copy())

        self._t_since_replan = 0

    def evaluate_rollouts(self, actions, cem_itr):
        """Subclass hook: (n_samples, T, adim) plans -> (n_samples,) costs."""
        raise NotImplementedError

    def _verbose_condition(self, cem_itr):
        if not self._hp.verbose:
            return False
        return self._hp.verbose_every_iter or cem_itr == self._n_iter - 1

    def _warmup_action(self, t, state):
        """Action for steps before ``start_planning`` (context frames)."""
        if self._hp.zeros_for_start_frames:
            assert self._hp.hard_coded_start_action is None
            return np.zeros(self._adim)
        if self._hp.hard_coded_start_action:
            return np.array(self._hp.hard_coded_start_action)
        # single draw from a fresh sampler, scaled down per-dim
        warm_sampler = self._make_sampler()
        draw = warm_sampler.sample_initial_actions(t, 1, state[-1])[0, 0]
        action = draw * np.array(
            self._hp.context_action_weight)[:self._adim]
        if self._hp.append_action:
            action = np.concatenate([action, self._hp.append_action], axis=0)
        return action

    def _replan_due(self):
        if not self._hp.replan_interval:
            return True
        return self._t_since_replan is None or \
            self._t_since_replan + 1 >= self._hp.replan_interval

    def act(self, t=None, i_tr=None, state=None):
        self._state = state
        self.i_tr = i_tr
        self._t = t

        if t < self._hp.start_planning:
            action = self._warmup_action(t, state)
        else:
            if self._replan_due():
                self.perform_CEM(state)
            else:
                self._t_since_replan += 1
            action = self._best_actions[0, self._t_since_replan]

        if action.shape != (self._adim,):
            raise AssertionError('action shape does not match adim!')
        self._logger.log('time {}, action - {}'.format(t, action))

        if self._best_actions is None:
            self._sampler.log_best_action(action, None)
        else:
            remaining = min(self._t_since_replan + 1, self._hp.T - 1)
            self._sampler.log_best_action(
                action, self._best_actions[:, remaining:])

        return {'actions': action, 'plan_stat': self.plan_stat}
