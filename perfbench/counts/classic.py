"""Operations of the classic three-scale CDNA/SNA predictor, from the
configuration's shapes alone.

Frozen with the benchmark, as ``counts/s2d_cdna.py``: these count what the
architecture needs, never what an implementation launches.

- :func:`step_flops`: a step's multiply-adds times two in every
  convolution (each output cell's k x k taps, as the strided and the
  depthwise convolutions count them in ``counts/s2d_cdna.py``), transposed
  convolution (each input cell through its 3 x 3 taps, the dilation's
  zeros excluded), separable gate and dense layer (the smear is a part of
  ``enc3``'s input), bias adds, activations and LayerNorm excluded, plus
  the tail's.
- :func:`tail_cost` is ``counts/s2d_cdna.py``'s: the classic masks come at
  full resolution, (B, H, W, nc), where that backbone's may come blocked,
  (B, H/r, W/r, r*r*nc); either way nc values a pixel, so the bytes and
  operations of one tail call are the same.
"""

from perfbench.counts.s2d_cdna import (CHANNELS, tail_cost,  # noqa: F401
                                       tail_macs)


def step_flops(cfg, batch, num_distribs):
    """FLOPs of one predictor step at ``batch``."""
    f1, f2, f3 = cfg['enc_features']
    h, w = cfg['img_dims']
    k, m, lk = cfg['kernel_size'], cfg['num_masks'], cfg['lstm_kernel']
    nc = m + (2 if cfg['sna'] else 1)
    cond = cfg['sdim'] + cfg['adim'] + cfg['latent_dim']
    cells = lambda d: (h // d) * (w // d)
    # a cell over [x, h]: depthwise lk x lk, then pointwise to 4 f
    lstm = lambda d, cin, f: cells(d) * ((cin + f) * lk * lk +
                                         (cin + f) * 4 * f)
    deconv = lambda d_in, cin, cout: cells(d_in) * 9 * cin * cout
    macs = (cells(2) * f1 * CHANNELS * 25             # enc0, 5x5 stride 2
            + lstm(2, f1, f1)                         # lstm1
            + cells(4) * f2 * f1 * 9                  # enc1
            + lstm(4, f2, f2)                         # lstm2
            + cells(8) * f3 * f2 * 9                  # enc2
            + cells(8) * (f3 + cond) * f3             # enc3 over the smear
            + lstm(8, f3, f3)                         # lstm3
            + deconv(8, f3, f2)                       # dec1
            + lstm(4, 2 * f2, f2)                     # lstm4 over [dec1, enc1]
            + deconv(4, f2, f1)                       # dec2
            + lstm(2, 2 * f1, f1)                     # lstm5 over [dec2, enc0]
            + deconv(2, f1, f1)                       # dec3
            + cells(1) * f1 * nc                      # mask_head
            + cells(8) * f3 * m * k * k               # cdna_head
            + (cfg['sdim'] + cfg['adim']) * cfg['sdim'])  # state_head
    return 2 * batch * macs + 2 * tail_macs(cfg, batch, num_distribs)
