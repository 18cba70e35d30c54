"""Fused CDNA warp-and-composite tail: the CUDA kernel and its plain version.

Counterpart of ``visual_foresight_tpu/ops/pallas_cdna.py``.  The kernel
(``csrc/cdna_tail.cu``) also folds in the mask x CDNA-kernel contraction, so
it takes the raw normalized CDNA kernels and the full mask stack, like the
Pallas module's ``fused_warp_composite`` wrapper.

The masks come at full resolution, (B, H, W, nc), or blocked, (B, H/r, W/r,
r*r*nc) with ``mask_block=r``, as the model's low-resolution mask head
leaves them (pixel (r*h+i, r*w+j), mask m at channel (i*r+j)*nc + m): the
kernel indexes either, so the blocked form needs no ``depth_to_space`` copy.

Dispatch is by ``dispatch.route``: a CUDA tensor launches the kernel or
raises; a CPU tensor takes :func:`fused_warp_composite_reference`.  The
kernel is tiled (shared-memory tiles, 16-byte accesses, four pixels a
thread) and reads block factors 2 and 4; masks of any other block factor,
which no model builds, are expanded to full resolution before the launch.

:func:`fused_warp_composite_eff` serves the Pallas function's own contract:
the per-pixel kernel field (B, H, W, K*K) and the background masks come
from the caller.  :func:`fused_warp_composite_dna` is DNA's tail: it takes
the DNA head's logits and the softmax masks and makes the field itself, as
the JAX step does before its tail.  Both launch the same source's second
kernel (tiled like the first; its DNA mode for the latter) on the card and
take their plain versions on the CPU, by the same rules.

Gradients (P = 0, the trainer's contract): on the CPU autograd
differentiates the plain version.  On the card the folded entry runs as a
``torch.autograd.Function`` whose forward launches the forward kernel and
whose backward launches ``csrc/cdna_tail_bwd.cu``
(:func:`fused_warp_composite_backward`; its plain version is
:func:`fused_warp_composite_backward_reference`).  The field-given entry and
the DNA mode have no backward kernel yet: on the card they raise when asked
for a gradient, as the folded entry does with P > 0, rather than return a
result cut off from the graph.
"""

import ctypes

import torch

from visual_foresight_torch.ops.cdna_warp import (RELU_SHIFT, dna_warp,
                                                  effective_pixel_kernels,
                                                  extract_patches)
from visual_foresight_torch.ops.dispatch import (DTYPES, Entry, no_backward,
                                                 route)
from visual_foresight_torch.ops.layout import depth_to_space, space_to_depth

SOURCE = 'cdna_tail.cu'
BWD_SOURCE = 'cdna_tail_bwd.cu'
_BWD_TILE = (8, 32)                   # rows, columns of a backward tile
_MAX_CHANNELS = 4
_MAX_MASKS = 16
_KERNEL_BLOCKS = (0, 1, 2, 4)         # the mask block factors the kernel reads
_PTRS = [ctypes.c_void_p] * 8         # a forward's six inputs, two outputs
_FORWARD = Entry(SOURCE, 'cdna_tail_forward', _PTRS + [ctypes.c_int] * 10)
_EFF = Entry(SOURCE, 'cdna_tail_eff_forward', _PTRS + [ctypes.c_int] * 9)
_DNA = Entry(SOURCE, 'cdna_tail_dna_forward', _PTRS + [ctypes.c_int] * 10)
_BACKWARD = Entry(BWD_SOURCE, 'cdna_tail_backward',
                  [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9)


def fused_warp_composite_reference(prev, first, prev_distrib, first_distrib,
                                   kernels, masks, sna=True, mask_block=0):
    """Plain version: ``effective_pixel_kernels`` + ``dna_warp`` +
    compositing, computed in f32 and cast to the input dtype.

    :param prev: (B, H, W, C) previous frame
    :param first: (B, H, W, C) SNA background (ignored if ``sna`` is False)
    :param prev_distrib: (B, H, W, P) pixel distributions (P may be 0)
    :param first_distrib: (B, H, W, P)
    :param kernels: (B, K, K, M) normalized CDNA kernels
    :param masks: (B, H, W, nc) compositing masks, nc = M + (2 if sna else
        1); or, with ``mask_block`` = r > 1, (B, H/r, W/r, r*r*nc)
    :param mask_block: block factor r of the mask layout (0 or 1: full
        resolution)
    :return: (gen_image (B,H,W,C), gen_distrib_unnormalized (B,H,W,P))
    """
    offset = 2 if sna else 1
    if mask_block > 1:
        masks = depth_to_space(masks, mask_block)
    c = prev.shape[-1]
    masks32 = masks.float()
    eff = effective_pixel_kernels(kernels.float(), masks32, offset)
    x = torch.cat([prev.float(), prev_distrib.float()], dim=-1)
    out = x * masks32[..., 0:1]
    if sna:
        out = out + torch.cat([first.float(), first_distrib.float()],
                              dim=-1) * masks32[..., 1:2]
    out = out + dna_warp(x, eff)
    return out[..., :c].to(prev.dtype), out[..., c:].to(prev_distrib.dtype)


def _check_tensors(tensors, shapes):
    """The checks both entries share: ``tensors`` (name -> tensor, ``prev``
    first) on one device, of one supported dtype, contiguous, of the
    ``shapes`` given (name -> shape), with 1..4 frame and 0..4 distribution
    channels."""
    prev = tensors['prev']
    for name, t in tensors.items():
        if t.device != prev.device:
            raise ValueError('{} is on {}, prev on {}'.format(
                name, t.device, prev.device))
        if t.dtype != prev.dtype:
            raise ValueError('{} is {}, prev is {}'.format(
                name, t.dtype, prev.dtype))
        if not t.is_contiguous():
            raise ValueError('{} must be contiguous'.format(name))
    if prev.dtype not in DTYPES:
        raise ValueError('unsupported dtype {}'.format(prev.dtype))
    for name, shape in shapes.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError('{} has shape {}, expected {}'.format(
                name, tuple(tensors[name].shape), shape))
    c, p = prev.shape[-1], tensors['prev_distrib'].shape[-1]
    if not (1 <= c <= _MAX_CHANNELS and 0 <= p <= _MAX_CHANNELS):
        raise ValueError('kernel takes 1..{0} frame and 0..{0} distribution '
                         'channels, got C={1}, P={2}'.format(
                             _MAX_CHANNELS, c, p))


def _check(prev, first, prev_distrib, first_distrib, kernels, masks, sna,
           mask_block):
    b, h, w, c = prev.shape
    p = prev_distrib.shape[-1]
    ksize, m = kernels.shape[1], kernels.shape[3]
    nc = m + (2 if sna else 1)
    r = mask_block
    if r < 0 or (r > 1 and (h % r or w % r)):
        raise ValueError('mask_block {} does not divide the image {}x{}'
                         .format(r, h, w))
    mask_shape = (b, h // r, w // r, r * r * nc) if r > 1 else (b, h, w, nc)
    _check_tensors(
        {'prev': prev, 'first': first, 'prev_distrib': prev_distrib,
         'first_distrib': first_distrib, 'kernels': kernels, 'masks': masks},
        {'first': (b, h, w, c), 'prev_distrib': (b, h, w, p),
         'first_distrib': (b, h, w, p), 'kernels': (b, ksize, ksize, m),
         'masks': mask_shape})
    if ksize not in (3, 5, 7) or not 1 <= m <= _MAX_MASKS or b > 65535:
        raise ValueError('kernel takes K in (3, 5, 7), M <= {}, B <= 65535; '
                         'got K={}, M={}, B={}'.format(_MAX_MASKS, ksize, m,
                                                       b))


def fused_warp_composite(prev, first, prev_distrib, first_distrib, kernels,
                         masks, sna=True, mask_block=0):
    """Fused warp + composite of the frame and the pixel distributions.

    Same contract (NHWC in and out) as
    :func:`fused_warp_composite_reference`; all six tensors share one device
    and one dtype (float32 or bfloat16) and are contiguous.  On a CUDA device
    it launches ``csrc/cdna_tail.cu`` and counts the launch in
    ``fused_warp_composite.launches`` and, where the kernel reads the masks
    blocked (r = 2 or 4), in ``fused_warp_composite.blocked_launches``;
    masks of another block factor are expanded to full resolution first.
    Where an input needs a gradient (grad mode on), the launch records an
    autograd node whose backward is :func:`fused_warp_composite_backward`;
    that needs P = 0 and raises otherwise.
    """
    way = route(prev, first, prev_distrib, first_distrib, kernels, masks)
    if way == 'plain':
        return fused_warp_composite_reference(
            prev, first, prev_distrib, first_distrib, kernels, masks, sna,
            mask_block)
    if mask_block not in _KERNEL_BLOCKS:
        _check(prev, first, prev_distrib, first_distrib, kernels, masks, sna,
               mask_block)
        masks, mask_block = depth_to_space(masks, mask_block).contiguous(), 0
    if way == 'graph':
        if prev_distrib.shape[-1]:
            raise RuntimeError(
                'the CDNA tail backward kernel takes no distribution '
                'channels (P = {}; ROADMAP.md queue 2, "the backward for '
                'the other entries"): call it under torch.no_grad()'
                .format(prev_distrib.shape[-1]))
        return _FoldedTail.apply(prev, first, prev_distrib, first_distrib,
                                 kernels, masks, sna, mask_block)
    return _launch(prev, first, prev_distrib, first_distrib, kernels, masks,
                   sna, mask_block)


def _launch(prev, first, prev_distrib, first_distrib, kernels, masks, sna,
            mask_block):
    """One launch of the folded entry on the card (no autograd node)."""
    _check(prev, first, prev_distrib, first_distrib, kernels, masks, sna,
           mask_block)
    b, h, w, c = prev.shape
    out_img = torch.empty_like(prev)
    out_distrib = torch.empty_like(prev_distrib)
    _FORWARD.launch(
        prev.device, prev.data_ptr(), first.data_ptr(),
        prev_distrib.data_ptr(), first_distrib.data_ptr(), kernels.data_ptr(),
        masks.data_ptr(), out_img.data_ptr(), out_distrib.data_ptr(), b, h, w,
        c, prev_distrib.shape[-1], kernels.shape[1], kernels.shape[3],
        int(sna), DTYPES[prev.dtype], mask_block)
    fused_warp_composite.launches += 1
    fused_warp_composite.blocked_launches += mask_block > 1
    return out_img, out_distrib


fused_warp_composite.launches = 0
fused_warp_composite.blocked_launches = 0


class _FoldedTail(torch.autograd.Function):
    """The folded entry on the card with its backward kernel.  It saves its
    four inputs, not the effective field: the backward makes the field
    again where it needs it."""

    @staticmethod
    def forward(ctx, prev, first, prev_distrib, first_distrib, kernels,
                masks, sna, mask_block):
        out_img, out_distrib = _launch(prev, first, prev_distrib,
                                       first_distrib, kernels, masks, sna,
                                       mask_block)
        ctx.save_for_backward(prev, first, kernels, masks)
        ctx.sna, ctx.mask_block = sna, mask_block
        ctx.mark_non_differentiable(out_distrib)
        return out_img, out_distrib

    @staticmethod
    def backward(ctx, grad_img, grad_distrib):
        prev, first, kernels, masks = ctx.saved_tensors
        need = ctx.needs_input_grad
        g_prev, g_first, g_kernels, g_masks = fused_warp_composite_backward(
            grad_img, prev, first, kernels, masks, ctx.sna, ctx.mask_block,
            needs=(need[0], need[1], need[4], need[5]))
        return g_prev, g_first, None, None, g_kernels, g_masks, None, None


def fused_warp_composite_backward_reference(grad_img, prev, first, kernels,
                                            masks, sna=True, mask_block=0):
    """Plain backward of :func:`fused_warp_composite_reference` for P = 0,
    in explicit formulas, computed in f32.  With ``eff[p, t] = sum_k
    masks[p, off+k] * kern[t, k]`` and ``d(t)`` tap t's offset:

    - ``g_eff[p, t] = sum_c g[p, c] * prev[p + d(t), c]`` (zero outside);
    - ``g_masks[p, 0] = sum_c g * prev``, ``g_masks[p, 1] = sum_c g *
      first`` (SNA), ``g_masks[p, off+k] = sum_t g_eff[p, t] * kern[t, k]``;
    - ``g_first = m1 * g`` (zero without SNA);
    - ``g_kernels[t, k] = sum_p masks[p, off+k] * g_eff[p, t]``;
    - ``g_prev[q] = m0 * g[q] + sum_t eff[q - d(t), t] * g[q - d(t)]``.

    :param grad_img: (B, H, W, C) gradient of the loss by ``gen_image``
    :return: (g_prev, g_first, g_kernels, g_masks), each in its input's
        dtype and layout (``g_masks`` blocked where the masks are)
    """
    offset = 2 if sna else 1
    b, h, w, c = prev.shape
    ksize, m = kernels.shape[1], kernels.shape[3]
    pad = ksize // 2
    g = grad_img.float()
    x = prev.float()
    mk = (depth_to_space(masks, mask_block) if mask_block > 1
          else masks).float()
    kflat = kernels.float().reshape(b, ksize * ksize, m)
    g_eff = torch.einsum('bhwc,bhwct->bhwt', g, extract_patches(x, ksize))
    g_m = torch.cat([
        (g * x).sum(-1, keepdim=True),
        (g * first.float()).sum(-1, keepdim=True) if sna else g[..., :0],
        torch.einsum('bhwt,btm->bhwm', g_eff, kflat)], dim=-1)
    g_kernels = torch.einsum('bhwm,bhwt->btm', mk[..., offset:], g_eff)
    g_first = g * mk[..., 1:2] if sna else torch.zeros_like(g)
    eff = effective_pixel_kernels(kernels.float(), mk, offset)
    spread = g.new_zeros((b, h + 2 * pad, w + 2 * pad, c))
    for i in range(ksize):
        for j in range(ksize):
            spread[:, i:i + h, j:j + w] += eff[..., i * ksize + j, None] * g
    g_prev = g * mk[..., 0:1] + spread[:, pad:pad + h, pad:pad + w]
    if mask_block > 1:
        g_m = space_to_depth(g_m, mask_block)
    return (g_prev.to(prev.dtype), g_first.to(first.dtype),
            g_kernels.reshape(kernels.shape).to(kernels.dtype),
            g_m.to(masks.dtype))


def backward_partials_shape(b, h, w, ksize, m, mask_block=0):
    """Shape of the backward kernel's f32 scratch for the kernels' gradient:
    one K*K*M partial sum for each tile of 8 x 32 pixels of each sample,
    which its second launch sums over the tiles in a fixed order.  The
    tiles are the same in both mask layouts (a blocked layout's cells of r =
    2 or 4 fill them whole); ``mask_block`` must divide the image."""
    if mask_block > 1 and (h % mask_block or w % mask_block):
        raise ValueError('mask_block {} does not divide the image {}x{}'
                         .format(mask_block, h, w))
    tiles = -(-h // _BWD_TILE[0]) * -(-w // _BWD_TILE[1])
    return (b, tiles, ksize * ksize * m)


def fused_warp_composite_backward(grad_img, prev, first, kernels, masks,
                                  sna=True, mask_block=0,
                                  needs=(True, True, True, True)):
    """Gradients of the folded tail (P = 0) by ``prev``, ``first``,
    ``kernels`` and ``masks``, as
    :func:`fused_warp_composite_backward_reference` computes them; ``needs``
    names the ones wanted, and the others come back as None.  On a CUDA
    device it launches ``csrc/cdna_tail_bwd.cu`` (a pass over tiles of 8 x
    32 pixels and, where the kernels' gradient is wanted, a fixed-order sum
    of its per-tile partials, :func:`backward_partials_shape`, so two runs
    give the same bits) and counts the call in
    ``fused_warp_composite_backward.launches``.
    """
    if route(prev) == 'plain':
        grads = fused_warp_composite_backward_reference(
            grad_img, prev, first, kernels, masks, sna, mask_block)
        return tuple(gr if n else None for gr, n in zip(grads, needs))
    grad_img = grad_img.contiguous()
    empty = prev.new_zeros(prev.shape[:3] + (0,))
    _check(prev, first, empty, empty, kernels, masks, sna, mask_block)
    _check_tensors({'prev': prev, 'grad_img': grad_img,
                    'prev_distrib': empty}, {'grad_img': tuple(prev.shape)})
    b, h, w, c = prev.shape
    ksize, m = kernels.shape[1], kernels.shape[3]
    outs = [torch.empty_like(t) if n else None
            for t, n in zip((prev, first, kernels, masks), needs)]
    partials = torch.empty(
        backward_partials_shape(b, h, w, ksize, m, mask_block),
        dtype=torch.float32, device=prev.device) if needs[2] else None
    ptr = lambda t: 0 if t is None else t.data_ptr()
    _BACKWARD.launch(prev.device, grad_img.data_ptr(), prev.data_ptr(),
                     first.data_ptr(), kernels.data_ptr(), masks.data_ptr(),
                     *map(ptr, outs), ptr(partials), b, h, w, c, ksize, m,
                     int(sna), DTYPES[prev.dtype], mask_block)
    fused_warp_composite_backward.launches += 1
    return tuple(outs)


fused_warp_composite_backward.launches = 0


def fused_warp_composite_eff_reference(prev, first, prev_distrib,
                                       first_distrib, eff_kernels, bg_masks,
                                       sna=True):
    """Plain version of the effective-kernel contract: ``dna_warp`` of the
    frame and the distributions by the given field plus compositing,
    computed in f32 and cast to the input dtype.

    :param eff_kernels: (B, H, W, K*K) per-pixel kernels
    :param bg_masks: (B, H, W, 1 or 2) background masks: channel 0 weighs
        the previous frame, channel 1 (read only with ``sna``) the first
    :return: (gen_image (B,H,W,C), gen_distrib_unnormalized (B,H,W,P))
    """
    c = prev.shape[-1]
    masks32 = bg_masks.float()
    x = torch.cat([prev.float(), prev_distrib.float()], dim=-1)
    out = x * masks32[..., 0:1] + dna_warp(x, eff_kernels.float())
    if sna:
        out = out + torch.cat([first.float(), first_distrib.float()],
                              dim=-1) * masks32[..., 1:2]
    return out[..., :c].to(prev.dtype), out[..., c:].to(prev_distrib.dtype)


def _check_eff(prev, first, prev_distrib, first_distrib, eff_kernels,
               bg_masks, sna):
    b, h, w, c = prev.shape
    p, kk, nbg = (prev_distrib.shape[-1], eff_kernels.shape[-1],
                  bg_masks.shape[-1])
    _check_tensors(
        {'prev': prev, 'first': first, 'prev_distrib': prev_distrib,
         'first_distrib': first_distrib, 'eff_kernels': eff_kernels,
         'bg_masks': bg_masks},
        {'first': (b, h, w, c), 'prev_distrib': (b, h, w, p),
         'first_distrib': (b, h, w, p), 'eff_kernels': (b, h, w, kk),
         'bg_masks': (b, h, w, nbg)})
    if kk not in (9, 25, 49) or nbg not in (1, 2) or (sna and nbg < 2) or \
            b > 65535:
        raise ValueError('kernel takes K*K in (9, 25, 49), 1 or 2 background '
                         'masks (2 with SNA), B <= 65535; got K*K={}, {} '
                         'masks, B={}'.format(kk, nbg, b))


def fused_warp_composite_eff(prev, first, prev_distrib, first_distrib,
                             eff_kernels, bg_masks, sna=True):
    """Warp + composite of the frame and the pixel distributions by a given
    per-pixel kernel field: the contract of the Pallas
    ``fused_warp_composite_eff`` (NHWC in and out, distributions returned
    unnormalized), as :func:`fused_warp_composite_eff_reference` computes
    it.  All six tensors share one device and one dtype (float32 or
    bfloat16) and are contiguous.  On a CUDA device it launches the
    effective-kernel entry of ``csrc/cdna_tail.cu`` and counts the launch
    in ``fused_warp_composite_eff.launches``.  It has no backward kernel:
    on the card, asked for a gradient, it raises.
    """
    way = route(prev, first, prev_distrib, first_distrib, eff_kernels,
                bg_masks)
    if way == 'plain':
        return fused_warp_composite_eff_reference(
            prev, first, prev_distrib, first_distrib, eff_kernels, bg_masks,
            sna)
    if way == 'graph':
        no_backward('fused_warp_composite_eff')
    _check_eff(prev, first, prev_distrib, first_distrib, eff_kernels,
               bg_masks, sna)
    b, h, w, c = prev.shape
    ksize = int(round(eff_kernels.shape[-1] ** 0.5))
    out_img = torch.empty_like(prev)
    out_distrib = torch.empty_like(prev_distrib)
    _EFF.launch(prev.device, prev.data_ptr(), first.data_ptr(),
                prev_distrib.data_ptr(), first_distrib.data_ptr(),
                eff_kernels.data_ptr(), bg_masks.data_ptr(),
                out_img.data_ptr(), out_distrib.data_ptr(), b, h, w, c,
                prev_distrib.shape[-1], ksize, bg_masks.shape[-1], int(sna),
                DTYPES[prev.dtype])
    fused_warp_composite_eff.launches += 1
    return out_img, out_distrib


fused_warp_composite_eff.launches = 0


def fused_warp_composite_dna_reference(prev, first, prev_distrib,
                                       first_distrib, dna_logits, masks,
                                       sna=True):
    """Plain version of DNA's tail: the field made from the DNA head's
    logits as the JAX step makes it (``models/cdna.py`` :461-466 of the JAX
    package), then :func:`fused_warp_composite_eff_reference`.

    :param dna_logits: (B, H, W, K*K) per-pixel kernel logits
    :param masks: (B, H, W, nc) softmax masks, nc = transform masks + (2 if
        sna else 1): the background masks first, then the transform masks
        whose total weighs the field
    :return: (gen_image (B,H,W,C), gen_distrib_unnormalized (B,H,W,P))
    """
    offset = 2 if sna else 1
    dt = prev.dtype
    pk = torch.relu(dna_logits.float() - RELU_SHIFT) + RELU_SHIFT
    pk = pk / pk.sum(dim=-1, keepdim=True)
    eff = pk * masks[..., offset:].sum(dim=-1, keepdim=True)
    return fused_warp_composite_eff_reference(
        prev, first, prev_distrib, first_distrib, eff.to(dt),
        masks[..., :offset].to(dt), sna)


def _check_dna(prev, first, prev_distrib, first_distrib, dna_logits, masks,
               sna):
    b, h, w, c = prev.shape
    p, kk, nc = prev_distrib.shape[-1], dna_logits.shape[-1], masks.shape[-1]
    _check_tensors(
        {'prev': prev, 'first': first, 'prev_distrib': prev_distrib,
         'first_distrib': first_distrib, 'dna_logits': dna_logits},
        {'first': (b, h, w, c), 'prev_distrib': (b, h, w, p),
         'first_distrib': (b, h, w, p), 'dna_logits': (b, h, w, kk)})
    if masks.device != prev.device or not masks.is_contiguous():
        raise ValueError('masks must be contiguous and on {}'.format(
            prev.device))
    if masks.dtype not in (torch.float32, prev.dtype):
        raise ValueError('masks are {}; the kernel takes float32 or {}'
                         .format(masks.dtype, prev.dtype))
    if masks.dim() != 4 or tuple(masks.shape[:3]) != (b, h, w):
        raise ValueError('masks has shape {}, expected ({}, {}, {}, nc)'
                         .format(tuple(masks.shape), b, h, w))
    offset = 2 if sna else 1
    if kk not in (9, 25, 49) or not offset < nc <= _MAX_MASKS + offset or \
            b > 65535:
        raise ValueError('kernel takes K*K in (9, 25, 49), {} to {} masks '
                         '({} background), B <= 65535; got K*K={}, {} '
                         'masks, B={}'.format(offset + 1, _MAX_MASKS + offset,
                                              offset, kk, nc, b))


def fused_warp_composite_dna(prev, first, prev_distrib, first_distrib,
                             dna_logits, masks, sna=True):
    """DNA's warp + composite of the frame and the pixel distributions, the
    field made inside the kernel from the DNA head's logits and the masks,
    as :func:`fused_warp_composite_dna_reference` computes it.  ``prev``,
    ``first``, the distributions and ``dna_logits`` share one device and one
    dtype (float32 or bfloat16); ``masks`` are in that dtype or float32 (the
    classic backbone's softmax).  All are contiguous.  On a CUDA device it
    launches the DNA mode of ``csrc/cdna_tail.cu`` and counts the launch in
    ``fused_warp_composite_dna.launches``.  It has no backward kernel: on
    the card, asked for a gradient, it raises.
    """
    way = route(prev, first, prev_distrib, first_distrib, dna_logits, masks)
    if way == 'plain':
        return fused_warp_composite_dna_reference(
            prev, first, prev_distrib, first_distrib, dna_logits, masks, sna)
    if way == 'graph':
        no_backward('fused_warp_composite_dna')
    _check_dna(prev, first, prev_distrib, first_distrib, dna_logits, masks,
               sna)
    b, h, w, c = prev.shape
    ksize = int(round(dna_logits.shape[-1] ** 0.5))
    out_img = torch.empty_like(prev)
    out_distrib = torch.empty_like(prev_distrib)
    _DNA.launch(prev.device, prev.data_ptr(), first.data_ptr(),
                prev_distrib.data_ptr(), first_distrib.data_ptr(),
                dna_logits.data_ptr(), masks.data_ptr(), out_img.data_ptr(),
                out_distrib.data_ptr(), b, h, w, c, prev_distrib.shape[-1],
                ksize, masks.shape[-1], int(sna), DTYPES[prev.dtype],
                DTYPES[masks.dtype])
    fused_warp_composite_dna.launches += 1
    return out_img, out_distrib


fused_warp_composite_dna.launches = 0
