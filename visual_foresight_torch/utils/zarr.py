"""zarr v2 arrays on an OCDBT store (``utils/ocdbt.py``), as orbax keeps them.

An array ``name`` is the key ``name/.zarray`` (its JSON metadata) and one
key per chunk, ``name/<i>.<j>...`` (``name/0`` for a 0-d array).  The
reader assembles the chunk grid, crops the edge chunks, and fills a missing
chunk with ``fill_value`` (zeros where it is null).  Its compressors are
``zstd`` (the port's own decoder) and ``null``; its dtypes those of the JAX
trees: ``<f4``, ``<f8``, ``<i4``, ``<i8``, ``<u4``, ``|b1`` and the other
plain numpy types, and ``bfloat16``, read as raw 16-bit words and handed back
as a ``torch.bfloat16`` tensor by a view, as ``prediction/tf1_bundle.py``
does.  The writer stores one chunk an array, uncompressed.
"""

import itertools
import json

import numpy as np
import torch

BFLOAT16 = 'bfloat16'


def _numpy_dtype(name):
    return np.dtype('<u2') if name == BFLOAT16 else np.dtype(name)


def _chunk_key(name, index, separator):
    return '{}/{}'.format(name, separator.join(str(i) for i in index)
                          if index else '0')


def _fill(meta):
    value = meta.get('fill_value')
    if value is None:
        return 0
    if isinstance(value, str):          # "NaN", "Infinity", "-Infinity"
        return float(value.replace('Infinity', 'inf'))
    return value


def read_array(store, name):
    """Array ``name`` of ``store`` (an OCDBT reader): a numpy array, or a
    ``torch.bfloat16`` tensor for a bfloat16 array."""
    meta = json.loads(store.read('{}/.zarray'.format(name)))
    if meta.get('zarr_format') != 2:
        raise ValueError('{}: zarr format {}'.format(
            name, meta.get('zarr_format')))
    if meta.get('filters'):
        raise ValueError('{}: zarr filters are not supported'.format(name))
    compressor = meta.get('compressor')
    if compressor is not None and compressor.get('id') != 'zstd':
        raise ValueError('{}: compressor {}'.format(name, compressor))
    order = meta.get('order', 'C')
    dtype = _numpy_dtype(meta['dtype'])
    shape = tuple(meta['shape'])
    chunks = tuple(meta['chunks'])
    separator = meta.get('dimension_separator', '.')
    if len(chunks) != len(shape):
        raise ValueError('{}: chunks {} for shape {}'.format(name, chunks,
                                                             shape))
    out = np.full(shape, _fill(meta), dtype=dtype)
    grid = [range(-(-s // c)) if c else range(0)
            for s, c in zip(shape, chunks)]
    for index in itertools.product(*grid):
        key = _chunk_key(name, index, separator)
        if key not in store:
            continue
        raw = store.read(key)
        if compressor is not None:
            from visual_foresight_torch.utils import zstd
            raw = zstd.decompress(raw)
        count = int(np.prod(chunks, dtype=np.int64))
        if len(raw) != count * dtype.itemsize:
            raise ValueError('{}: chunk of {} bytes, expected {}'.format(
                key, len(raw), count * dtype.itemsize))
        chunk = np.frombuffer(raw, dtype=dtype).reshape(chunks, order=order)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    if meta['dtype'] == BFLOAT16:
        return torch.from_numpy(out.view(np.int16).copy()).view(
            torch.bfloat16)
    return out


def encode_array(name, value):
    """{key: bytes} of array ``name`` holding ``value`` (a numpy array or
    scalar, or a tensor; a ``torch.bfloat16`` tensor is stored as
    ``bfloat16``): its ``.zarray`` and one uncompressed chunk."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            words = value.contiguous().view(torch.int16).numpy().view('<u2')
            return _encode(name, words, BFLOAT16)
        value = value.numpy()
    arr = np.asarray(value)
    if arr.dtype.name == BFLOAT16:              # an ml_dtypes array
        return _encode(name, arr.view('<u2'), BFLOAT16)
    if arr.dtype.kind not in 'biuf' or arr.dtype.byteorder == '>':
        raise ValueError('{}: cannot store dtype {}'.format(name, arr.dtype))
    return _encode(name, arr, arr.dtype.str)


def _encode(name, arr, dtype_name):
    meta = {'chunks': [max(int(s), 1) for s in arr.shape],
            'compressor': None, 'dimension_separator': '.',
            'dtype': dtype_name, 'fill_value': None, 'filters': None,
            'order': 'C', 'shape': [int(s) for s in arr.shape],
            'zarr_format': 2}
    out = {'{}/.zarray'.format(name): json.dumps(
        meta, separators=(',', ':'), sort_keys=True).encode()}
    if arr.size:
        out[_chunk_key(name, (0,) * arr.ndim, '.')] = \
            np.ascontiguousarray(arr).tobytes()
    return out
