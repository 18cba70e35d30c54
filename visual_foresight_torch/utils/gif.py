"""A GIF89a writer in numpy, with no imaging library.

The JAX package writes its plan dumps and trajectory movies through
``imageio``.  The port writes them here instead, so that one tree writes
the same bytes wherever it runs, whether or not ``imageio`` is installed.

Layout: one global colour table, a looping (NETSCAPE2.0) extension when
there is more than one frame, then per frame a graphic control extension
(the delay, ``round(100 / fps)`` hundredths of a second) and one image
block, LZW-coded with the table cleared when it fills.

Colours: where all the frames together hold at most 256 colours (the plan
dumps' viridis heatmaps, for one), the palette is exactly those colours and
the file is lossless.  Otherwise every pixel is quantised to the fixed
3-3-2 palette (8 levels of red and green, 4 of blue, each rounded to the
nearest level), which is off by at most ``QUANT_ERROR`` per channel and
needs no search over the frames.
"""

import os

import numpy as np

# the most a 3-3-2 colour differs from its input, per channel (r, g, b):
# half the gap between levels 255/7 and 255/3 apart, rounded down
QUANT_ERROR = (18, 18, 42)

_LEVELS = (7, 7, 3)                                # r, g, b: levels - 1
_MAX_CODE = 4095


def quantize(frames):
    """(N, H, W, 3) uint8 -> (palette (n, 3) uint8, indices (N, H, W) uint8).

    Exact where the frames hold at most 256 colours, else the 3-3-2
    palette."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    flat = frames.reshape(-1, 3).astype(np.uint32)
    keys = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
    colours, inverse = np.unique(keys, return_inverse=True)
    if colours.shape[0] <= 256:
        palette = np.stack([colours >> 16, (colours >> 8) & 255,
                            colours & 255], axis=1).astype(np.uint8)
        return palette, inverse.reshape(frames.shape[:3]).astype(np.uint8)
    r, g, b = (np.rint(frames[..., i] * (n / 255.0)).astype(np.int32)
               for i, n in enumerate(_LEVELS))
    indices = ((r << 5) | (g << 2) | b).astype(np.uint8)
    code = np.arange(256)
    palette = np.stack(
        [np.rint((code >> 5) * (255.0 / 7)), np.rint(((code >> 2) & 7)
                                                      * (255.0 / 7)),
         np.rint((code & 3) * (255.0 / 3))], axis=1).astype(np.uint8)
    return palette, indices


def _pack(codes, sizes):
    """Variable-width codes, least significant bit first, into bytes."""
    codes = np.asarray(codes, np.int64)
    sizes = np.asarray(sizes, np.int64)
    bits = (codes[:, None] >> np.arange(12)[None]) & 1
    keep = np.arange(12)[None] < sizes[:, None]
    return np.packbits(bits[keep].astype(np.uint8),
                       bitorder='little').tobytes()


def lzw_encode(indices, min_code_size):
    """GIF's LZW code stream of a flat sequence of palette indices."""
    clear = 1 << min_code_size
    eoi = clear + 1
    codes, sizes = [clear], [min_code_size + 1]
    table, next_code, size = {}, eoi + 1, min_code_size + 1
    pixels = np.asarray(indices, np.uint8).ravel().tolist()
    if not pixels:
        return _pack(codes + [eoi], sizes + [size])
    prefix = pixels[0]
    for k in pixels[1:]:
        key = (prefix << 8) | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        codes.append(prefix)
        sizes.append(size)
        if next_code <= _MAX_CODE:
            table[key] = next_code
            if next_code == 1 << size and size < 12:
                size += 1
            next_code += 1
        else:
            # the table is full: start a new one
            codes.append(clear)
            sizes.append(size)
            table, next_code, size = {}, eoi + 1, min_code_size + 1
        prefix = k
    codes.append(prefix)
    sizes.append(size)
    # the decoder adds its entry for the last code before it reads the end
    if next_code == 1 << size and size < 12:
        size += 1
    codes.append(eoi)
    sizes.append(size)
    return _pack(codes, sizes)


def _sub_blocks(data):
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out.append(len(chunk))
        out += chunk
    out.append(0)
    return bytes(out)


def encode_gif(frames, fps=4):
    """The bytes of a GIF89a of ``frames`` ((N, H, W, 3) uint8 or a list of
    (H, W, 3) frames), looping forever, ``fps`` frames a second."""
    frames = np.stack([np.asarray(f, dtype=np.uint8) for f in frames])
    if frames.ndim != 4 or frames.shape[-1] != 3 or frames.shape[0] == 0:
        raise ValueError('expected (N, H, W, 3) frames, got shape {}'.format(
            frames.shape))
    n, height, width = frames.shape[:3]
    palette, indices = quantize(frames)
    table_bits = max(1, int(np.ceil(np.log2(palette.shape[0]))))
    table = np.zeros((1 << table_bits, 3), np.uint8)
    table[:palette.shape[0]] = palette
    min_code_size = max(2, table_bits)
    delay = int(round(100.0 / fps))

    out = bytearray(b'GIF89a')
    out += np.array([width, height], '<u2').tobytes()
    out += bytes([0x80 | (7 << 4) | (table_bits - 1), 0, 0])
    out += table.tobytes()
    if n > 1:
        out += b'\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00'
    for i in range(n):
        out += b'\x21\xf9\x04\x00' + np.array([delay], '<u2').tobytes() + \
            b'\x00\x00'
        out += b'\x2c' + np.array([0, 0, width, height], '<u2').tobytes() + \
            b'\x00'
        out.append(min_code_size)
        out += _sub_blocks(lzw_encode(indices[i], min_code_size))
    out.append(0x3b)
    return bytes(out)


def write_gif(filename, frames, fps=4):
    """Write ``frames`` to ``filename`` as a GIF89a (see ``encode_gif``)."""
    data = encode_gif(frames, fps)
    parent = os.path.dirname(filename)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(filename, 'wb') as f:
        f.write(data)
