"""NCE-embedding cost controller (PyTorch port).

Counterpart of ``visual_foresight_tpu/policy/cem_controllers/variants/
nce_cost_controller.py``: the cost is the negated dot product of the
L2-normalised embeddings of the last ``final_frames`` predicted frames of
camera 0 with the goal image's embedding, made once a replan.  The paths,
the device and the draws are ``ClassifierController``'s; the embedding is
``NCEEmbedding()`` at its default widths, restored from ``embedding_path``
by ``models/convert.py::restore_network``: its latest orbax ``step_<N>/``,
as the JAX controller reads it, else its ``params.npz`` (seeded weights,
with a warning, where it has neither).
"""

import torch

from visual_foresight_torch.models.classifier import NCEEmbedding
from visual_foresight_torch.models.convert import restore_network
from .classifier_controller import ClassifierController


class NCECostController(ClassifierController):
    def _restore_scorer(self):
        self.embedding = NCEEmbedding()
        self.embedding_restored = restore_network(self.embedding,
                                                  self._hp.embedding_path)
        self.embedding.to(self.device).eval()

    def _default_hparams(self):
        parent_params = super()._default_hparams()
        parent_params.add_hparam('embedding_path', '')
        return parent_params

    @torch.no_grad()
    def _cost_context(self):
        """The goal image's embedding (embed_dim,) on the device."""
        goal = torch.as_tensor(self._goal_tensor(), device=self.device)
        return self.embedding(goal[None])[0]

    @torch.no_grad()
    def _frame_cost(self, gen_images, goal_emb):
        flat, b, tt = self._tail_frames(gen_images)
        emb = self.embedding(flat).reshape(b, tt, -1)
        return -torch.einsum('btd,d->bt', emb, goal_emb).mean(dim=1)
