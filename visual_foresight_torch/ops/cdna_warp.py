"""CDNA transformed-convolution warp, plain PyTorch.

Counterpart of ``visual_foresight_tpu/ops/cdna_warp.py`` (NHWC throughout):
every sample predicts its own ``M`` K x K kernels, each warps the previous
frame into a candidate, and softmax masks blend the candidates.  The same
kernels and masks warp the designated-pixel distributions.

These functions are the plain versions that the CUDA tail kernel
(``ops/cdna_tail.py``) is held against; the serving path does not call them
on the card.
"""

import torch
import torch.nn.functional as F

RELU_SHIFT = 1e-12


def normalize_kernels(raw_kernels):
    """ReLU + eps, normalized so each kernel sums to 1.

    raw_kernels: (B, K, K, M) -> same shape, sum over (K, K) == 1.
    """
    k = torch.relu(raw_kernels - RELU_SHIFT) + RELU_SHIFT
    return k / k.sum(dim=(1, 2), keepdim=True)


def _pad_hw(images, pad):
    """Zero-pad the H and W axes of an NHWC tensor by ``pad`` on each side."""
    return F.pad(images, (0, 0, pad, pad, pad, pad))


def extract_patches(images, ksize):
    """(B, H, W, C) -> (B, H, W, C, ksize*ksize) patches with SAME padding.

    The patch index is ``kh * ksize + kw``, as in
    ``lax.conv_general_dilated_patches``.
    """
    b, h, w, c = images.shape
    x = _pad_hw(images, ksize // 2)
    taps = [x[:, i:i + h, j:j + w, :]
            for i in range(ksize) for j in range(ksize)]
    return torch.stack(taps, dim=-1)


def cdna_warp(images, kernels):
    """Apply per-sample CDNA kernels to images.

    :param images: (B, H, W, C) previous frames
    :param kernels: (B, K, K, M) normalized transformation kernels
    :return: (B, H, W, C, M) transformed candidate frames
    """
    b, ksize, _, m = kernels.shape
    patches = extract_patches(images, ksize)
    kflat = kernels.reshape(b, ksize * ksize, m)
    out = torch.einsum('bhwck,bkm->bhwcm', patches.float(), kflat.float())
    return out.to(images.dtype)


def effective_pixel_kernels(kernels, masks, mask_offset):
    """Collapse per-sample CDNA kernels and compositing masks into a
    per-pixel effective kernel field (compositing is linear, so
    ``sum_m mask_m * (k_m corr I) == (sum_m mask_m * k_m) corr I``).

    :param kernels: (B, K, K, M) normalized CDNA kernels
    :param masks: (B, H, W, num_candidates) softmax masks
    :param mask_offset: index of the first transform mask (1, or 2 with SNA)
    :return: (B, H, W, K*K) effective kernels, accumulated in the mask dtype
    """
    b, ksize, _, m = kernels.shape
    kflat = kernels.reshape(b, ksize * ksize, m).to(masks.dtype)
    out = masks.new_zeros(masks.shape[:3] + (ksize * ksize,))
    for i in range(m):
        out = out + masks[..., mask_offset + i, None] * \
            kflat[:, None, None, :, i]
    return out


def dna_warp(images, pixel_kernels):
    """A distinct kernel per output pixel, by shift-and-accumulate:
    ``out[h,w] = sum_(i,j) img[h+i-pad, w+j-pad] * k[h,w,i*K+j]``,
    accumulated in the image dtype.

    :param images: (B, H, W, C)
    :param pixel_kernels: (B, H, W, K*K)
    :return: (B, H, W, C)
    """
    ksize = int(round(pixel_kernels.shape[-1] ** 0.5))
    b, h, w, c = images.shape
    x = _pad_hw(images, ksize // 2)
    out = images.new_zeros((b, h, w, c))
    for i in range(ksize):
        for j in range(ksize):
            tap = pixel_kernels[..., i * ksize + j, None].to(images.dtype)
            out = out + x[:, i:i + h, j:j + w, :] * tap
    return out


def composite(background, transformed, masks):
    """Blend candidates with compositing masks.

    :param background: (B, H, W, C) candidate under mask 0
    :param transformed: (B, H, W, C, M) warped candidates
    :param masks: (B, H, W, M+1) softmax masks; channel 0 is the background
    :return: (B, H, W, C)
    """
    out = background * masks[..., 0:1]
    blend = torch.einsum('bhwcm,bhwm->bhwc', transformed.float(),
                         masks[..., 1:].float())
    return out + blend.to(background.dtype)


def warp_and_composite(prev_image, background, kernels, masks):
    """Warp ``prev_image`` with ``kernels`` then composite."""
    return composite(background, cdna_warp(prev_image, kernels), masks)


def warp_distribution(prev_distrib, background_distrib, kernels, masks,
                      renormalize=True):
    """Warp pixel probability distributions with the same kernels/masks.

    :param prev_distrib: (B, H, W, P) probability maps
    :param background_distrib: (B, H, W, P) distribution blended under mask 0
    :return: (B, H, W, P), renormalized to sum 1 over (H, W) when requested
    """
    warped = warp_and_composite(prev_distrib, background_distrib, kernels,
                                masks)
    if renormalize:
        total = warped.sum(dim=(1, 2), keepdim=True)
        warped = warped / torch.clamp(total, min=1e-12)
    return warped
