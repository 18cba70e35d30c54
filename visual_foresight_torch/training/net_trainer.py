"""What the trainers of the standalone networks share (the GDN, the success
classifier, the NCE embedding and the inverse net).

- ``prepare``: the network's initial weights (a flax tree given, or flax's
  default initialization drawn from a torch generator seeded with
  ``--seed``), the device (``--device``, the card by default) and
  ``optax.adam(lr)`` over its parameters;
- ``run``: the JAX trainers' loop, one Adam step a batch, the metrics
  logged every ``--log_every`` steps and at the last;
- ``save_network``: in ``--model_dir``, the orbax ``step_<N>/`` that the
  JAX trainers write (``prediction/checkpoints.py``, numpy alone), the
  port's ``params.npz`` (the flax tree, keys joined with '/', f32), both
  read by ``models/convert.py::restore_network`` and the controllers, and
  ``net_config.json``, with the step in ``checkpoint.json``.
"""

import json
import os
import time

import numpy as np
import torch

from visual_foresight_torch.device import resolve_device
from visual_foresight_torch.models.convert import (flatten_flax,
                                                   load_flax_params,
                                                   params_to_flax)
from visual_foresight_torch.prediction import checkpoints
from visual_foresight_torch.training.train_predictor import adam, init_params

NET_CONFIG = 'net_config.json'
STEP_FILE = 'checkpoint.json'


def prepare(module, args, init=None):
    """``module`` with its initial weights (``init``, a flax tree of numpy
    arrays such as JAX's ``init`` gives, else seeded with ``args.seed``) on
    ``args.device``; returns (module, device, optimizer)."""
    device = resolve_device(getattr(args, 'device', 'cuda'))
    if init is not None:
        load_flax_params(module, init)
    else:
        init_params(module, seed=args.seed)
    module.to(device).train()
    return module, device, adam(list(module.named_parameters()), args.lr)


def make_step(tx, loss_fn):
    """One Adam step of ``loss_fn(*batch) -> (loss, metrics)``; returns the
    metrics, detached."""
    def step(*batch):
        tx.zero_grad()
        loss, metrics = loss_fn(*batch)
        loss.backward()
        tx.step()
        return {k: v.detach() for k, v in metrics.items()}
    return step


def run(args, step_fn, batches, device, on_step=None):
    """``args.steps`` steps of ``step_fn`` on ``next(batches)`` (tuples of
    numpy arrays, moved to ``device``), the metrics of every
    ``args.log_every``-th and the last step printed as JSON.  ``on_step(step)``
    runs after each step.  Returns the logged metrics."""
    t0 = time.time()
    history = []
    for step in range(args.steps):
        batch = [torch.as_tensor(x, device=device) for x in next(batches)]
        metrics = step_fn(*batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m.update(step=step, sec=round(time.time() - t0, 1))
            history.append(m)
            print(json.dumps(m), flush=True)
        if on_step is not None:
            on_step(step)
    return history


def save_network(module, model_dir, net_config, step):
    """Write ``model_dir/step_<step>/`` (the flax tree, as the JAX trainers
    save it), ``params.npz``, ``net_config.json`` and the step; returns the
    directory."""
    os.makedirs(model_dir, exist_ok=True)
    tree = params_to_flax(module.state_dict())
    checkpoints.save_params(tree, model_dir, step)
    flat = flatten_flax(tree)
    tmp = os.path.join(model_dir, 'params.tmp.npz')
    np.savez(tmp, **flat)
    os.replace(tmp, os.path.join(model_dir, 'params.npz'))
    with open(os.path.join(model_dir, NET_CONFIG), 'w') as f:
        json.dump(net_config, f, indent=1)
    with open(os.path.join(model_dir, STEP_FILE), 'w') as f:
        json.dump({'step': int(step)}, f)
    return model_dir
