"""Benchmark start/goal configuration generator
(reference ``sim/util/config_agent.py``).

A GeneralAgent variant whose rollout calls ``env.generate_task()`` to
synthesize a start configuration, records it, then teleports objects to create
the goal; the two snapshots form one benchmark config consumable by
BenchmarkAgent."""

from visual_foresight_torch.agent.general_agent import GeneralAgent


class CreateConfigAgent(GeneralAgent):
    def rollout(self, policy, i_trial, i_traj):
        self._init()
        agent_data, policy_outputs = {}, []

        initial_env_obs, reset_state = self.env.reset()
        self.env.generate_task()
        obs = self._post_process_obs(self.env.current_obs(), agent_data, True)
        # second snapshot after the goal placement
        self.env.move_objects()
        obs = self._post_process_obs(self.env.current_obs(), agent_data)

        agent_data['traj_ok'] = True
        agent_data['reset_state'] = reset_state
        obs['reset_state'] = reset_state
        return agent_data, obs, policy_outputs
