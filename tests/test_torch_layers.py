"""Port parity: ``visual_foresight_torch.models.layers`` against the flax
layers, with the flax parameters carried over by ``params_from_flax``.
Tolerance 1e-5: f32 on both sides, the same arithmetic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_foresight_tpu.models import layers as jlayers
from visual_foresight_torch.models import layers as tlayers
from visual_foresight_torch.models.convert import (load_flax_params,
                                                   params_from_flax)
from visual_foresight_torch.ops.dispatch import route

TOL = 1e-5


def route_on_card(*tensors):
    """``route`` as it answers for tensors on a CUDA device: its device
    test stood in for, its grad test as it is."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, 'is_cuda', property(lambda t: True))
        return route(*tensors)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _perturbed(params, seed):
    """Random non-zero values everywhere (flax initializes biases to 0)."""
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.RandomState(seed)
    return jax.tree.unflatten(tree, [
        jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.3)
        for x in leaves])


@pytest.mark.parametrize('form', ['dense', 'separable', 'external_x'])
def test_conv_lstm_cell_matches_flax(form):
    rng = np.random.RandomState(0)
    b, h, w, cin, feat, k = 2, 6, 8, 5, 4, 3
    xin = 4 * feat if form == 'external_x' else cin
    x = rng.randn(b, h, w, xin).astype(np.float32)
    c0 = rng.randn(b, h, w, feat).astype(np.float32)
    h0 = rng.randn(b, h, w, feat).astype(np.float32)
    jcell = jlayers.ConvLSTMCell(feat, (k, k), separable=form == 'separable',
                                 external_x=form == 'external_x')
    params = _perturbed(jcell.init(jax.random.PRNGKey(0), (c0, h0), x), 1)
    (jc, jh), _ = jcell.apply(params, (c0, h0), x)

    tcell = tlayers.ConvLSTMCell(cin, feat, (k, k),
                                 separable=form == 'separable',
                                 external_x=form == 'external_x')
    load_flax_params(tcell, _np_tree(params))
    with torch.no_grad():
        (tc, th), out = tcell((torch.tensor(c0), torch.tensor(h0)),
                              torch.tensor(x))
    assert out is th
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL)


def test_layer_norm_matches_flax():
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 4, 5, 16) * 2 + 1).astype(np.float32)
    jln = jlayers.LayerNorm()
    params = _perturbed(jln.init(jax.random.PRNGKey(0), x), 2)
    want = np.asarray(jln.apply(params, x))
    tln = tlayers.LayerNorm(16)
    load_flax_params(tln, _np_tree(params))
    with torch.no_grad():
        got = tln(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_layer_norm_bf16_keeps_dtype():
    tln = tlayers.LayerNorm(8)
    x = torch.randn(2, 3, 8).to(torch.bfloat16)
    with torch.no_grad():
        y = tln(x)
    assert y.dtype == torch.bfloat16
    ref = torch.nn.functional.layer_norm(x.float(), (8,), eps=1e-6)
    assert float((y.float() - ref).abs().max()) < 2e-2


@pytest.mark.parametrize('size,stride,k', [(12, 2, 3), (4, 2, 3), (7, 2, 3),
                                           (8, 1, 3), (9, 3, 5)])
def test_same_pad_matches_numpy_oracle(size, stride, k):
    from numpy_cdna_ref import same_pad_amounts
    assert tlayers.same_pad(size, stride, k) == same_pad_amounts(size,
                                                                 stride, k)


def test_params_from_flax_layouts_and_errors():
    rng = np.random.RandomState(3)
    tree = {'params': {
        'conv': {'kernel': rng.randn(3, 3, 2, 5), 'bias': rng.randn(5)},
        'dw': {'kernel': rng.randn(3, 3, 1, 4)},
        'pw': {'kernel': rng.randn(1, 1, 4, 6)},
        'dense': {'kernel': rng.randn(7, 2)},
        'norm': {'ln': {'scale': rng.randn(4), 'bias': rng.randn(4)}},
    }}
    sd = params_from_flax(tree)
    t = tree['params']
    np.testing.assert_array_equal(sd['conv.weight'].numpy(),
                                  t['conv']['kernel'].transpose(3, 2, 0, 1)
                                  .astype(np.float32))
    assert tuple(sd['dw.weight'].shape) == (4, 1, 3, 3)
    np.testing.assert_array_equal(sd['pw.weight'].numpy(),
                                  t['pw']['kernel'][0, 0].T
                                  .astype(np.float32))
    np.testing.assert_array_equal(sd['dense.weight'].numpy(),
                                  t['dense']['kernel'].T.astype(np.float32))
    assert set(sd) >= {'norm.weight', 'norm.bias', 'conv.bias'}
    with pytest.raises(ValueError, match='cannot place'):
        params_from_flax({'x': {'embedding': np.zeros((2, 2))}})
    # a leaf without a port parameter, and a parameter without a leaf
    tln = tlayers.LayerNorm(4)
    with pytest.raises(ValueError, match='unconsumed'):
        load_flax_params(tln, {'ln': {'scale': np.ones(4), 'bias': np.ones(4)},
                               'extra': {'bias': np.ones(4)}})
    with pytest.raises(ValueError, match='unfilled'):
        load_flax_params(tln, {'ln': {'scale': np.ones(4)}})


def _stock_cell_and_norm(cell, ln, state, x):
    """``ConvLSTMCell.forward`` followed by ``LayerNorm.forward`` as the
    port ran them before ``forward_norm``: one stock op at a time."""
    c, h = state
    if cell.external_x:
        gates = x + cell.gates_pw(tlayers.conv_nhwc(h, cell.gates_dw, 'SAME'))
    elif cell.separable:
        xh = torch.cat([x, h], dim=-1)
        gates = cell.gates_pw(tlayers.conv_nhwc(xh, cell.gates_dw, 'SAME'))
    else:
        xh = torch.cat([x, h], dim=-1)
        gates = tlayers.conv_nhwc(xh, cell.gates, 'SAME')
    i, g, f, o = torch.split(gates, cell.features, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + 1.0)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    new_c = f * c + i * g
    new_h = o * torch.tanh(new_c)
    y = torch.nn.functional.layer_norm(
        new_h.float(), (new_h.shape[-1],), ln.weight.float(), ln.bias.float(),
        eps=tlayers.LN_EPS).to(new_h.dtype)
    return new_c, new_h, y


def _cell_case(form, dtype, feat=8, seed=0):
    torch.manual_seed(seed)
    b, h, w, cin, k = 2, 6, 8, 5, 3
    cell = tlayers.ConvLSTMCell(cin, feat, (k, k),
                                separable=form == 'separable',
                                external_x=form == 'external_x', dtype=dtype)
    ln = tlayers.LayerNorm(feat)
    with torch.no_grad():
        for p in list(cell.parameters()) + list(ln.parameters()):
            p.copy_(torch.randn(p.shape) * 0.3)
    xin = 4 * feat if form == 'external_x' else cin
    x = torch.randn(b, h, w, xin).to(dtype)
    state = (torch.randn(b, h, w, feat).to(dtype),
             torch.randn(b, h, w, feat).to(dtype))
    return cell, ln, state, x


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('grad', [False, True], ids=['no_grad', 'grad'])
@pytest.mark.parametrize('form', ['dense', 'separable', 'external_x'])
def test_forward_norm_plain_route_is_the_stock_chain(form, grad, dtype):
    """Off the card ``forward_norm`` returns bit for bit what the cell
    followed by its LayerNorm returned, in every form, with and without
    grad; ``forward`` keeps its (c', h'), h' contract."""
    from visual_foresight_torch.ops.conv_lstm_ln import conv_lstm_ln
    cell, ln, state, x = _cell_case(form, dtype)
    before = conv_lstm_ln.launches
    with torch.set_grad_enabled(grad):
        (c1, h1), y = cell.forward_norm(state, x, ln)
        want = _stock_cell_and_norm(cell, ln, state, x)
        (c2, h2), out = cell(state, x)
    for got, ref in zip((c1, h1, y), want):
        assert got.dtype == dtype and torch.equal(got, ref)
    assert out is h2 and torch.equal(c2, want[0]) and torch.equal(h2, want[1])
    assert conv_lstm_ln.launches == before


@pytest.mark.parametrize('with_r', [False, True], ids=['x', 'x+r'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_conv_lstm_ln_on_cpu_is_its_plain_version(dtype, with_r):
    """The wrapper on CPU tensors is its plain version exactly and counts
    no launch."""
    from visual_foresight_torch.ops.conv_lstm_ln import (
        conv_lstm_ln, conv_lstm_ln_reference)
    gen = torch.Generator().manual_seed(3)
    n, feat = 37, 16
    x = torch.randn(n, 4 * feat, generator=gen).to(dtype)
    r = torch.randn(n, 4 * feat, generator=gen).to(dtype) if with_r else None
    c = torch.randn(n, feat, generator=gen).to(dtype)
    w, b = torch.randn(feat, generator=gen), torch.randn(feat, generator=gen)
    before = conv_lstm_ln.launches
    got = conv_lstm_ln(x, r, c, w, b, tlayers.LN_EPS)
    want = conv_lstm_ln_reference(x, r, c, w, b, tlayers.LN_EPS)
    assert conv_lstm_ln.launches == before
    for g, ref in zip(got, want):
        assert g.shape == c.shape and torch.equal(g, ref)


@pytest.mark.parametrize('form', ['dense', 'separable', 'external_x'])
def test_forward_norm_routes_by_grad_need(form, monkeypatch):
    """The route's grad half, asked of ``route`` with its device test
    stood in for (``route_on_card``): ``'graph'`` only under grad mode
    with a tensor that needs a gradient, and there the cell keeps the stock
    ops and their gradients; off the card ``route`` says ``'plain'`` and the
    kernel's entry is never called, in any grad mode.  The card's half is
    ``tests/test_torch_cuda.py::test_forward_norm_routes_by_grad_need_on_card``.
    """
    from visual_foresight_torch.ops.conv_lstm_ln import conv_lstm_ln_reference
    calls = []

    def entry(*args):
        calls.append(args)
        return conv_lstm_ln_reference(*args)

    monkeypatch.setattr(tlayers, 'conv_lstm_ln', entry)
    cell, ln, state, x = _cell_case(form, torch.float32)
    params = list(cell.parameters()) + list(ln.parameters())
    want = _stock_cell_and_norm(cell, ln, state, x)
    with torch.no_grad():
        assert route_on_card(x, None, *params) == 'kernel'
        assert route(x, None, *params) == 'plain'
        (c, h), y = cell.forward_norm(state, x, ln)
    for got, ref in zip((c, h, y), want):
        assert torch.equal(got, ref)

    assert route_on_card(x, None, *params) == 'graph'
    assert route_on_card(x, None, *state) == 'kernel'
    (c, h), y = cell.forward_norm(state, x, ln)       # grad: stock ops
    assert y.requires_grad
    (y.sum() + c.sum()).backward()
    got_grads = [p.grad.clone() for p in cell.parameters()] + \
        [ln.weight.grad.clone()]
    for p in params:
        p.grad = None
    ref_c, _, ref_y = _stock_cell_and_norm(cell, ln, state, x)
    (ref_y.sum() + ref_c.sum()).backward()
    ref_grads = [p.grad for p in cell.parameters()] + [ln.weight.grad]
    for g, ref in zip(got_grads, ref_grads):
        assert torch.equal(g, ref)

    for p in params:
        p.requires_grad_(False)
    assert route_on_card(x, None, *params) == 'kernel'
    (c, h), y = cell.forward_norm(state, x, ln)  # grad on, nothing needs one
    assert not y.requires_grad and torch.equal(y, want[2])
    assert calls == []


@pytest.mark.parametrize('feat,dtype,takes', [
    (8, torch.bfloat16, True), (128, torch.bfloat16, True),
    (256, torch.bfloat16, True), (1024, torch.bfloat16, True),
    (2048, torch.bfloat16, False), (12, torch.bfloat16, False),
    (24, torch.bfloat16, False), (4, torch.bfloat16, False),
    (4, torch.float32, True), (12, torch.float32, False),
    (512, torch.float32, True), (1024, torch.float32, False),
    (8, torch.float16, False)])
def test_conv_lstm_ln_widths(feat, dtype, takes):
    """The kernel takes a power of two of 16-byte words a row, up to 128;
    the wrapper raises for any other width on the card."""
    from visual_foresight_torch.ops.conv_lstm_ln import takes_width
    assert takes_width(feat, dtype) is takes


def _norm_case(dtype, layout, with_bias, feat=16, seed=5):
    """(x, conv_bias, weight, bias): x contiguous (2, 6, 8, feat), or the
    crop of an uncropped (2, 7, 9, feat) product, as ``dec3``'s."""
    gen = torch.Generator().manual_seed(seed)
    pad = 1 if layout == 'crop' else 0
    full = (2.0 * torch.randn(2, 6 + pad, 8 + pad, feat, generator=gen) +
            0.5).to(dtype)
    x = full[:, :6, :8] if pad else full
    conv_bias = torch.randn(feat, generator=gen).to(dtype) if with_bias \
        else None
    return (x, conv_bias, 1.0 + 0.3 * torch.randn(feat, generator=gen),
            0.3 * torch.randn(feat, generator=gen))


@pytest.mark.parametrize('with_bias', [False, True], ids=['no-bias', 'bias'])
@pytest.mark.parametrize('layout', ['contiguous', 'crop'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_bias_layer_norm_on_cpu_is_its_plain_version(dtype, layout,
                                                     with_bias):
    """On CPU tensors ``bias_layer_norm`` is ``layer_norm_reference`` of
    the input plus the bias, added in the input's type, bit for bit; it
    counts no launch."""
    from visual_foresight_torch.ops.conv_lstm_ln import (
        bias_layer_norm, layer_norm_reference)
    x, conv_bias, w, b = _norm_case(dtype, layout, with_bias)
    before = bias_layer_norm.launches
    got = bias_layer_norm(x, conv_bias, w, b, tlayers.LN_EPS)
    biased = x if conv_bias is None else x + conv_bias
    assert biased.dtype == dtype
    want = layer_norm_reference(biased, w, b, tlayers.LN_EPS)
    assert bias_layer_norm.launches == before
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, want)


def _conv_norm_case(route, dtype, seed=0):
    """A convolution, its LayerNorm and an input, with random parameters:
    ``enc0`` (a 5x5 stride-2 ``nn.Conv2d``, 3 to 8 channels, SAME) or
    ``dec3`` (a ``ConvTranspose``, 8 to 8)."""
    torch.manual_seed(seed)
    feat = 8
    if route == 'enc0':
        conv = torch.nn.Conv2d(3, feat, 5, stride=2, dtype=dtype)
        x = torch.rand(2, 12, 16, 3).to(dtype)
    else:
        conv = tlayers.ConvTranspose(feat, feat, dtype=dtype)
        x = torch.randn(2, 6, 8, feat).to(dtype)
    ln = tlayers.LayerNorm(feat)
    with torch.no_grad():
        for p in list(conv.parameters()) + list(ln.parameters()):
            p.copy_(torch.randn(p.shape) * 0.3)
    return conv, ln, x


def _conv_norm_routes(route, conv, ln, x):
    """(the route's output, the stock chain's)."""
    if route == 'enc0':
        return (tlayers.conv_nhwc_norm(x, conv, ln, 'SAME'),
                ln(tlayers.conv_nhwc(x, conv, 'SAME')))
    return conv.forward_norm(x, ln), ln(conv(x))


@pytest.mark.parametrize('grad', [False, True], ids=['no_grad', 'grad'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('route', ['enc0', 'dec3'])
def test_conv_norm_route_is_the_stock_chain_on_cpu(route, dtype, grad,
                                                   monkeypatch):
    """Off the card ``conv_nhwc_norm`` and ``ConvTranspose.forward_norm``
    return bit for bit what the convolution followed by its LayerNorm
    returned, with and without grad, and never call the kernel's entry."""
    calls = []
    monkeypatch.setattr(tlayers, 'bias_layer_norm',
                        lambda *a: calls.append(a))
    conv, ln, x = _conv_norm_case(route, dtype)
    with torch.set_grad_enabled(grad):
        got, want = _conv_norm_routes(route, conv, ln, x)
    assert got.dtype == dtype and torch.equal(got, want)
    assert got.requires_grad == grad and calls == []


@pytest.mark.parametrize('route', ['enc0', 'dec3'])
def test_conv_norm_fold_is_the_stock_chain_in_f32(route):
    """What the card's route computes, with the CPU's plain version of the
    kernel: the convolution without its bias (``dec3``'s product uncropped,
    the crop a view), then ``bias_layer_norm`` with the bias; in f32 the
    CPU's convolution adds its bias exactly as a separate add does, so this
    is the stock chain bit for bit."""
    from visual_foresight_torch.ops.conv_lstm_ln import bias_layer_norm
    conv, ln, x = _conv_norm_case(route, torch.float32)
    if route == 'enc0':
        product = tlayers.conv_nhwc(x, conv, 'SAME', with_bias=False)
    else:
        product = conv._uncropped(x, None)[:, :-1, :-1]
        assert not product.is_contiguous()
    with torch.no_grad():
        got = bias_layer_norm(product, conv.bias, ln.weight, ln.bias,
                              tlayers.LN_EPS)
        _, want = _conv_norm_routes(route, conv, ln, x)
    assert torch.equal(got, want)


def test_layer_norm_routes_by_device_and_grad(monkeypatch):
    """``LayerNorm.forward`` off the card never calls the kernel's entry,
    in any grad mode (``route`` says ``'plain'`` there); on the card it
    would say ``'graph'`` only under grad mode with a tensor that needs a
    gradient."""
    calls = []
    monkeypatch.setattr(tlayers, 'bias_layer_norm',
                        lambda *a: calls.append(a))
    ln = tlayers.LayerNorm(8)
    x = torch.randn(2, 3, 8)
    want = torch.nn.functional.layer_norm(x, (8,), ln.weight, ln.bias,
                                          eps=tlayers.LN_EPS)
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            assert torch.equal(ln(x), want)
            assert route(x, ln.weight, ln.bias) == 'plain'
    assert calls == []
    assert route_on_card(x, None, ln.weight) == 'graph'
    with torch.no_grad():
        assert route_on_card(x, None, ln.weight) == 'kernel'


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_classic_step_through_the_norm_routes_is_the_old_chain(dtype,
                                                               monkeypatch):
    """A classic backbone's step (F 8/16/16, 16x16) gives bit for bit what
    it gave with ``ln0(conv_nhwc(...))`` and ``ln6(dec3(...))`` as stock
    modules."""
    from visual_foresight_torch.models import cdna
    torch.manual_seed(0)
    model = cdna.CDNAPredictor((16, 16), num_distribs=1, num_masks=2,
                               enc_features=(8, 16, 16), lstm_kernel=3,
                               separable_lstm=True, std_factor=0,
                               dtype=dtype).eval()
    images = torch.rand((2, 3, 16, 16, 3))
    actions = 0.1 * torch.randn((2, 3, 3))
    states = 0.1 * torch.randn((2, 3, 3))
    distribs = torch.rand((2, 3, 16, 16, 1))

    def run():
        with torch.no_grad():
            return model(images, actions, states, distribs)

    got = run()
    monkeypatch.setattr(cdna, 'conv_nhwc_norm',
                        lambda x, conv, ln, padding: ln(
                            tlayers.conv_nhwc(x, conv, padding)))
    monkeypatch.setattr(tlayers.ConvTranspose, 'forward_norm',
                        lambda self, x, ln: ln(self(x)))
    want = run()
    assert set(got) == set(want)
    for key in got:
        assert torch.equal(got[key], want[key]), key
