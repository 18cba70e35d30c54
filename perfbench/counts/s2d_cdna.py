"""Operations and bytes of the space-to-depth CDNA/SNA predictor, from the
configuration's shapes alone.

Frozen with the benchmark: these count what the architecture needs, never
what an implementation runs, so a fused or re-laid-out kernel moves the
measured time and not the yardstick.

- :func:`step_flops`: a step's multiply-adds times two in every
  convolution and dense layer (bias adds, activations and LayerNorm
  excluded, as model-FLOP counts leave them out), plus the tail's.
- :func:`tail_cost`: one warp-and-composite call, bytes and f32
  operations.  Bytes count each input read once and each output written
  once at the configuration's dtype: the previous and first frames and
  their distributions, the CDNA kernels and the masks (nc channels a
  pixel), the new frame and distribution.  Operations count the taps that
  fall inside the image (zero padding needs no work): each makes an
  effective-kernel term for every CDNA kernel and warps every frame and
  distribution channel; compositing adds the background (and SNA) terms.
"""

BYTES = {'bfloat16': 2, 'float32': 4}
CHANNELS = 3                    # RGB


def _in_bounds(size, k):
    """(output position, tap) pairs along one axis that read inside an
    axis of ``size`` under zero padding of k // 2."""
    pad = k // 2
    return k * size - 2 * sum(range(1, pad + 1))


def tail_macs(cfg, batch, num_distribs):
    """Multiply-adds of one tail call."""
    h, w = cfg['img_dims']
    k, m = cfg['kernel_size'], cfg['num_masks']
    c = CHANNELS + num_distribs
    taps = batch * _in_bounds(h, k) * _in_bounds(w, k)
    background = 2 if cfg['sna'] else 1
    return taps * (m + c) + batch * h * w * c * background


def tail_cost(cfg, batch, num_distribs):
    """(bytes, f32 FLOPs) of one tail call at ``batch``."""
    h, w = cfg['img_dims']
    k, m = cfg['kernel_size'], cfg['num_masks']
    nc = m + (2 if cfg['sna'] else 1)
    per_pixel = 2 * CHANNELS + 2 * num_distribs + nc + \
        CHANNELS + num_distribs
    elements = batch * (h * w * per_pixel + k * k * m)
    return elements * BYTES[cfg['dtype']], \
        2 * tail_macs(cfg, batch, num_distribs)


def step_flops(cfg, batch, num_distribs):
    """FLOPs of one predictor step at ``batch``."""
    r = cfg['std_factor']
    f1, f2, _ = cfg['enc_features']
    h, w = cfg['img_dims']
    k, m, lk = cfg['kernel_size'], cfg['num_masks'], cfg['lstm_kernel']
    nc = m + (2 if cfg['sna'] else 1)
    cond = cfg['sdim'] + cfg['adim'] + cfg['latent_dim']
    lo = (h // r) * (w // r)                    # cells at H/r
    bottom = (h // (2 * r)) * (w // (2 * r))    # cells at H/2r
    lstm = lambda cells, f: cells * (f * lk * lk + f * 4 * f)
    macs = (lo * 4 * f1 * CHANNELS * r * r      # enc0
            + lstm(lo, f1)                      # lstm1's recurrent gates
            + bottom * f2 * f1 * 9              # enc1
            + bottom * f2 * 4 * f2              # enc3
            + cond * 4 * f2                     # cond_proj
            + lstm(bottom, f2)                  # lstm3
            + bottom * f2 * 4 * f1              # dec1
            + lo * f1 * 4 * f1 * 2              # dec1_gates, skip1
            + lstm(lo, f1)                      # lstm4
            + lo * f1 * r * r * nc              # mask_head
            + bottom * f2 * m * k * k           # cdna_head
            + (cfg['sdim'] + cfg['adim']) * cfg['sdim'])  # state_head
    return 2 * batch * macs + 2 * tail_macs(cfg, batch, num_distribs)
