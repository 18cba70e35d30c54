"""Offline agent: emulates rollouts from logged data
(reference ``agent/offline_agent.py`` — completed; the reference stub wrote
into an undefined dict).

The port's own copy of ``visual_foresight_tpu/agent/offline_agent.py``.
"""

from .general_agent import GeneralAgent


class OfflineAgent(GeneralAgent):
    def _required_rollout_metadata(self, agent_data, traj_ok, t, i_traj, i_tr,
                                   reset_state):
        super()._required_rollout_metadata(agent_data, traj_ok, t, i_traj,
                                           i_tr, reset_state)
        agent_data['offline_replay'] = True
