"""The numpy export of ag_r5f_v2 (latent_dim 8, adim 4, sdim 5) and its
golden replan, kept honest as ``tests/test_torch_weights.py`` keeps the
flagship's, with that file's checks and tolerances."""

import pytest

from test_torch_weights import (AG_R5F_V2, _check_export_bit_for_bit,
                                _check_golden_is_live, _check_port_replays,
                                _check_port_restores, _load, _restore_jax)


@pytest.fixture(scope='module')
def jax_ag_r5f_v2():
    return _restore_jax(AG_R5F_V2)


def test_ag_r5f_v2_export_equals_orbax_restore_bit_for_bit(jax_ag_r5f_v2):
    got = _check_export_bit_for_bit(AG_R5F_V2, jax_ag_r5f_v2)
    # the latent widens cond_proj alone: 5 states + 4 actions + 8 latents
    assert got['params/step/cond_proj/kernel'].shape == (17, 1024)
    assert got['params/step/state_head/kernel'].shape == (9, 5)


def test_port_restores_the_ag_r5f_v2_export():
    """``TorchPredictor(dir, {})`` adopts latent_dim 8, adim 4 and sdim 5
    from the export's ``model_config.json``."""
    tp = _check_port_restores(AG_R5F_V2)
    assert (tp._hp['latent_dim'], tp._hp['adim'], tp._hp['sdim']) == (8, 4, 5)
    assert tp.models[0].latent_dim == 8


def test_ag_r5f_v2_golden_equals_live_jax_replan(jax_ag_r5f_v2):
    golden = _load(AG_R5F_V2.golden_path)
    assert golden['latents'].shape == (3, 24, 8)
    _check_golden_is_live(AG_R5F_V2, jax_ag_r5f_v2, golden)


def test_port_replays_ag_r5f_v2_golden_on_cpu():
    _check_port_replays(AG_R5F_V2, _load(AG_R5F_V2.golden_path))
