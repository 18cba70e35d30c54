"""Space-to-depth and back for NHWC tensors, subpixel-major channels.

Counterpart of ``space_to_depth`` / ``depth_to_space`` in
``visual_foresight_tpu/models/cdna.py``.
"""


def space_to_depth(x, r):
    """(B, H, W, C) -> (B, H/r, W/r, C*r*r); channel ``(i*r + j)*C + c``
    holds pixel (r*h + i, r*w + j), channel c."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // r, w // r, r * r * c)


def depth_to_space(x, r):
    """Inverse of :func:`space_to_depth` (subpixel-major channels, unlike
    ``F.pixel_shuffle``)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, r, r, c // (r * r))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h * r, w * r, c // (r * r))
