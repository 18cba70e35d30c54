"""Reader and writer of TF1 TensorBundle checkpoints, without TensorFlow.

The port's own copy of ``visual_foresight_tpu/prediction/tf1_bundle.py``,
with the same names and the same bytes.  The on-disk format:

* ``<prefix>.index``: a leveldb-format table (SSTable) of prefix-compressed
  key/value blocks with restart arrays, block trailers (a compression byte
  and a masked CRC32C), an index block addressing the data blocks, and a
  48-byte footer ending in the magic ``0xdb4775248b80fb57``.  Keys are
  tensor names (the empty key holds a ``BundleHeaderProto``); values are
  ``BundleEntryProto`` messages {dtype, shape, shard_id, offset, size, crc}.
* ``<prefix>.data-00000-of-NNNNN``: the tensors' little-endian bytes at the
  offsets the index records.

The protobuf walker and the CRC32C come from ``data/tfrecord_io.py``:
``google_crc32c`` where it imports, else ``crc32c_numpy`` (the same
checksums, more slowly).  A bfloat16 tensor (DT_BFLOAT16) is read as its raw
16-bit words and handed back as a ``torch.bfloat16`` tensor by a view; no
``ml_dtypes`` is needed.  Snappy block compression is not supported: TF
writes bundle index blocks uncompressed.
"""

import os
import struct

import numpy as np
import torch

from visual_foresight_torch.data.tfrecord_io import (_iter_fields,
                                                     _masked_crc32c,
                                                     _read_varint, _tag,
                                                     _varint)

_TABLE_MAGIC = 0xdb4775248b80fb57

DT_BFLOAT16 = 14

# tensorflow/core/framework/types.proto enum -> numpy
_DTYPES = {
    1: np.dtype('<f4'),     # DT_FLOAT
    2: np.dtype('<f8'),     # DT_DOUBLE
    3: np.dtype('<i4'),     # DT_INT32
    4: np.dtype('<u1'),     # DT_UINT8
    5: np.dtype('<i2'),     # DT_INT16
    6: np.dtype('<i1'),     # DT_INT8
    9: np.dtype('<i8'),     # DT_INT64
    10: np.dtype('bool'),   # DT_BOOL
    DT_BFLOAT16: np.dtype('<u2'),   # the raw 16-bit words
    19: np.dtype('<f2'),    # DT_HALF
    22: np.dtype('<u4'),    # DT_UINT32
    23: np.dtype('<u8'),    # DT_UINT64
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items() if k != DT_BFLOAT16}

_masked_crc = _masked_crc32c


def _unmasked_ok(data, masked):
    return _masked_crc(data) == masked


# ---------------------------------------------------------------------------
# leveldb table primitives
# ---------------------------------------------------------------------------

def _decode_block(buf):
    """Yield (key, value) pairs from one leveldb block (without trailer)."""
    if len(buf) < 4:
        return
    (num_restarts,) = struct.unpack_from('<I', buf, len(buf) - 4)
    data_end = len(buf) - 4 - 4 * num_restarts
    pos, key = 0, b''
    while pos < data_end:
        shared, pos = _read_varint(buf, pos)
        non_shared, pos = _read_varint(buf, pos)
        value_len, pos = _read_varint(buf, pos)
        key = key[:shared] + bytes(buf[pos:pos + non_shared])
        pos += non_shared
        value = bytes(buf[pos:pos + value_len])
        pos += value_len
        yield key, value


def _encode_block(items):
    """A leveldb block with a restart point at every key (shared is always
    0)."""
    out = bytearray()
    restarts = []
    for key, value in items:
        restarts.append(len(out))
        out += _varint(0) + _varint(len(key)) + _varint(len(value))
        out += key + value
    if not restarts:
        restarts = [0]
    for r in restarts:
        out += struct.pack('<I', r)
    out += struct.pack('<I', len(restarts))
    return bytes(out)


def _read_raw_block(data, offset, size, validate=True):
    block = data[offset:offset + size]
    compression = data[offset + size]
    if validate:
        (crc,) = struct.unpack_from('<I', data, offset + size + 1)
        if not _unmasked_ok(data[offset:offset + size + 1], crc):
            raise ValueError('bundle index: corrupt block crc at {}'.format(
                offset))
    if compression == 1:
        raise NotImplementedError('snappy-compressed bundle index block')
    if compression != 0:
        raise ValueError('unknown block compression {}'.format(compression))
    return block


def _block_handle(buf, pos=0):
    offset, pos = _read_varint(buf, pos)
    size, pos = _read_varint(buf, pos)
    return offset, size, pos


def _read_table(path):
    """All (key, value) pairs of a leveldb-format table file, in order."""
    with open(path, 'rb') as f:
        data = f.read()
    if len(data) < 48:
        raise ValueError('{}: too short for a bundle index'.format(path))
    footer = data[-48:]
    (magic,) = struct.unpack_from('<Q', footer, 40)
    if magic != _TABLE_MAGIC:
        raise ValueError('{}: bad table magic {:#x}'.format(path, magic))
    _, _, pos = _block_handle(footer, 0)          # metaindex (unused)
    index_off, index_size, _ = _block_handle(footer, pos)
    index_block = _read_raw_block(data, index_off, index_size)
    out = []
    for _, handle in _decode_block(index_block):
        off, size, _ = _block_handle(handle)
        block = _read_raw_block(data, off, size)
        out.extend(_decode_block(block))
    return out


def _write_table(path, items):
    """Write sorted (key, value) pairs as a single-data-block table."""
    items = sorted(items)
    out = bytearray()

    def append_block(block):
        off = len(out)
        out.extend(block)
        out.append(0)  # no compression
        out.extend(struct.pack('<I', _masked_crc(bytes(block) + b'\x00')))
        return _varint(off) + _varint(len(block))

    data_handle = append_block(_encode_block(items))
    last_key = items[-1][0] if items else b''
    index_handle = append_block(
        _encode_block([(last_key + b'\x00', data_handle)]))
    meta_handle = append_block(_encode_block([]))
    footer = meta_handle + index_handle
    footer += b'\x00' * (40 - len(footer))
    footer += struct.pack('<Q', _TABLE_MAGIC)
    out += footer
    with open(path, 'wb') as f:
        f.write(out)


# ---------------------------------------------------------------------------
# bundle entry protos
# ---------------------------------------------------------------------------

def _encode_shape(shape):
    dims = b''
    for s in shape:
        dim = _tag(1, 0) + _varint(int(s))
        dims += _tag(2, 2) + _varint(len(dim)) + dim
    return dims


def _decode_shape(span, buf):
    shape = []
    for f, w, v in _iter_fields(buf, *span):
        if f == 2 and w == 2:  # Dim message
            size = 0
            for f2, w2, v2 in _iter_fields(buf, *v):
                if f2 == 1 and w2 == 0:
                    size = v2
            shape.append(size)
    return tuple(shape)


def _encode_entry(dtype_code, shape, shard_id, offset, size, crc):
    msg = _tag(1, 0) + _varint(dtype_code)
    shp = _encode_shape(shape)
    msg += _tag(2, 2) + _varint(len(shp)) + shp
    if shard_id:
        msg += _tag(3, 0) + _varint(shard_id)
    if offset:
        msg += _tag(4, 0) + _varint(offset)
    msg += _tag(5, 0) + _varint(size)
    msg += _tag(6, 5) + struct.pack('<I', crc)
    return msg


def _decode_entry(payload):
    buf = memoryview(payload)
    entry = {'dtype': 0, 'shape': (), 'shard_id': 0, 'offset': 0, 'size': 0,
             'crc32c': 0}
    for f, w, v in _iter_fields(buf):
        if f == 1 and w == 0:
            entry['dtype'] = v
        elif f == 2 and w == 2:
            entry['shape'] = _decode_shape(v, buf)
        elif f == 3 and w == 0:
            entry['shard_id'] = v
        elif f == 4 and w == 0:
            entry['offset'] = v
        elif f == 5 and w == 0:
            entry['size'] = v
        elif f == 6 and w == 5:
            entry['crc32c'] = v
        elif f == 7 and w == 2:
            # BundleEntryProto.slices: a partitioned variable's full-tensor
            # entry has size 0 and its data in slice entries
            raise NotImplementedError(
                'sliced/partitioned TF1 variables are not supported '
                '(BundleEntryProto.slices present)')
    return entry


def _encode_header(num_shards):
    # BundleHeaderProto: num_shards, endianness LITTLE (0, the default),
    # version {producer: 1}
    version = _tag(1, 0) + _varint(1)
    return (_tag(1, 0) + _varint(num_shards)
            + _tag(3, 2) + _varint(len(version)) + version)


def _decode_header(payload):
    num_shards = 1
    for f, w, v in _iter_fields(memoryview(payload)):
        if f == 1 and w == 0:
            num_shards = v
        elif f == 2 and w == 0 and v != 0:
            raise ValueError('big-endian TF bundle not supported')
    return {'num_shards': num_shards}


def _bf16_tensor(words, shape):
    """Raw bfloat16 words (uint16) -> a ``torch.bfloat16`` tensor."""
    return torch.from_numpy(words.view(np.int16).copy()).view(
        torch.bfloat16).reshape(shape)


def _payload(name, value, code=None):
    """(dtype code, shape, bytes) of one tensor to write.  A bf16 torch
    tensor, or an array of raw 16-bit words given ``code`` 14, is written as
    DT_BFLOAT16."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            words = value.contiguous().view(torch.int16).numpy()
            return DT_BFLOAT16, tuple(value.shape), words.tobytes()
        value = value.numpy()
    # np.asarray keeps 0-d scalars 0-d; .tobytes() handles non-contiguous
    arr = np.asarray(value)
    if code == DT_BFLOAT16 or arr.dtype.name == 'bfloat16':
        if arr.dtype.itemsize != 2:
            raise ValueError('{}: bfloat16 words must be 16-bit, got {}'
                             .format(name, arr.dtype))
        return DT_BFLOAT16, arr.shape, arr.view('<u2').tobytes()
    dt = np.dtype(arr.dtype).newbyteorder('<')
    if dt not in _DTYPE_CODES or (code is not None
                                  and code != _DTYPE_CODES[dt]):
        raise ValueError('unsupported dtype {} for {}'.format(arr.dtype,
                                                             name))
    return _DTYPE_CODES[dt], arr.shape, arr.astype(dt).tobytes()


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _shard_path(prefix, shard_id, num_shards):
    return '{}.data-{:05d}-of-{:05d}'.format(prefix, shard_id, num_shards)


def list_variables(prefix):
    """{name: (shape, numpy dtype)} for every tensor in the bundle (the
    analog of ``reader.get_variable_to_shape_map``; bfloat16 tensors are
    listed with their raw ``<u2`` words' dtype)."""
    out = {}
    for key, value in _read_table(prefix + '.index'):
        if not key:
            continue
        entry = _decode_entry(value)
        if entry['dtype'] not in _DTYPES:
            continue  # strings / resources: not weight tensors
        out[key.decode('utf-8')] = (entry['shape'], _DTYPES[entry['dtype']])
    return out


def read_bundle(prefix, names=None, validate=True):
    """Load tensors from a TF1 checkpoint prefix into {name: array}.

    ``names`` restricts loading; every tensor's CRC32C is checked unless
    ``validate`` is off.  bfloat16 tensors come back as ``torch.bfloat16``
    tensors, the others as numpy arrays.
    """
    header = None
    entries = {}
    for key, value in _read_table(prefix + '.index'):
        if not key:
            header = _decode_header(value)
        else:
            entries[key.decode('utf-8')] = _decode_entry(value)
    num_shards = (header or {'num_shards': 1})['num_shards']

    shards = {}
    out = {}
    for name, entry in entries.items():
        if names is not None and name not in names:
            continue
        if entry['dtype'] not in _DTYPES:
            continue
        sid = entry['shard_id']
        if sid not in shards:
            with open(_shard_path(prefix, sid, num_shards), 'rb') as f:
                shards[sid] = f.read()
        raw = shards[sid][entry['offset']:entry['offset'] + entry['size']]
        if validate and entry['crc32c'] and \
                not _unmasked_ok(raw, entry['crc32c']):
            raise ValueError('crc mismatch for tensor {}'.format(name))
        flat = np.frombuffer(raw, dtype=_DTYPES[entry['dtype']])
        if entry['dtype'] == DT_BFLOAT16:
            out[name] = _bf16_tensor(flat, entry['shape'])
        else:
            out[name] = flat.reshape(entry['shape'])
    return out


def write_bundle(prefix, tensors, dtype_codes=None):
    """Write {name: array or tensor} as a single-shard TF1 TensorBundle.
    ``dtype_codes`` ({name: code}) names the TF dtype where the array's own
    does not: 14 (DT_BFLOAT16) for an array of raw 16-bit words."""
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    codes = dtype_codes or {}
    data = bytearray()
    items = []
    for name in sorted(tensors):
        code, shape, payload = _payload(name, tensors[name], codes.get(name))
        offset = len(data)
        data += payload
        entry = _encode_entry(code, shape, 0, offset, len(payload),
                              _masked_crc(payload))
        items.append((name.encode('utf-8'), entry))
    items.append((b'', _encode_header(1)))
    with open(_shard_path(prefix, 0, 1), 'wb') as f:
        f.write(data)
    _write_table(prefix + '.index', items)
    return prefix
