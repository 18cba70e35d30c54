"""Context and batching helpers of the reference predictor API, numpy only.

Counterpart of ``visual_foresight_tpu/prediction/pred_util.py`` (the
reference's ``video_prediction/pred_util.py``).  ``rollout_predictions``
chunks the CEM batch into fixed-size predictor calls: the fused planner
does not need it, but a custom predictor with a hard batch limit does.
"""

import numpy as np


def get_context(n_context, t, state, images, hp=None):
    """The last ``n_context`` frames (as float32 in [0, 1]) and states up to
    step ``t``, each with a leading batch axis of 1; ``hp.state_append``,
    where set, is appended to every state."""
    last_frames = images[t - n_context + 1:t + 1]
    last_frames = last_frames.astype(np.float32, copy=False) / 255.0
    last_frames = last_frames[None]
    last_states = state[t - n_context + 1:t + 1]
    last_states = last_states[None]
    if hp is not None and getattr(hp, 'state_append', None):
        append = np.tile(np.array([[hp.state_append]]), (1, n_context, 1))
        last_states = np.concatenate((last_states, append), -1)
    return last_frames, last_states


def rollout_predictions(predictor, b_size, actions, context_frames,
                        context_states=None, input_distribs=None, logger=None):
    """Run ``predictor`` on the N action samples in batches of ``b_size``,
    the last one padded with zero actions, and return the per-batch lists
    of images, distributions and states, each cut back to its real rows."""
    num_actions = actions.shape[0]
    nruns = max(1, -(-num_actions // b_size))

    def check_and_slice(arr, n):
        return arr[:n] if arr is not None else None

    gen_images, gen_distrib, gen_state = [], [], []
    for run in range(nruns):
        action_batch = actions[run * b_size:(run + 1) * b_size]
        if run == nruns - 1 and action_batch.shape[0] < b_size:
            T, adim = action_batch.shape[1:]
            padded = np.zeros((b_size, T, adim))
            padded[:action_batch.shape[0]] = action_batch
        else:
            padded = action_batch
        if logger:
            logger.log('vpred run {} with {} actions'.format(
                run, action_batch.shape[0]))
        _imgs, _distrib, _state = predictor(
            input_images=context_frames, input_state=context_states,
            input_actions=padded, input_one_hot_images=input_distribs)
        gen_images.append(check_and_slice(_imgs, action_batch.shape[0]))
        gen_distrib.append(check_and_slice(_distrib, action_batch.shape[0]))
        gen_state.append(check_and_slice(_state, action_batch.shape[0]))
    return gen_images, gen_distrib, gen_state
