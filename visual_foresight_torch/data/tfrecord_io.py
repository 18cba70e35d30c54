"""Dependency-free TFRecord + ``tf.train.Example`` codec.

The port's own copy of ``visual_foresight_tpu/data/tfrecord_io.py`` (that
package imports JAX), with the same names and the same bytes:

* **TFRecord framing**: ``uint64 length | masked crc32c(length) | payload |
  masked crc32c(payload)``; the GZIP variant is a plain gzip stream of
  records.
* **Example protobuf**: ``Example{features: Features{feature: map<string,
  Feature{bytes_list|float_list|int64_list}>}}`` encoded and decoded by a
  minimal protobuf walker (packed and unpacked repeated fields both read).

CRC32C comes from ``google_crc32c`` where it imports, and otherwise from
:func:`crc32c_numpy`, the Castagnoli table vectorised with numpy: the same
checksums, more slowly.  ``gzip.open`` stamps the time into each file's
header, so two writers' files agree in their decompressed streams, not byte
for byte.
"""

import functools
import gzip
import struct

import numpy as np

# -- crc32c ----------------------------------------------------------------------

_CRC_MASK_DELTA = 0xA282EAD8
_POLY = 0x82F63B78          # Castagnoli, bit-reflected
_LANE = 256                 # bytes a lane of the vectorised CRC


def _byte_table():
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(_POLY), t >> 1)
    return t.astype(np.uint32)


_TABLE = _byte_table()
_TABLE_LIST = _TABLE.tolist()


def _apply(cols, state):
    """A GF(2) 32 x 32 matrix (its columns) times the 32-bit ``state``."""
    out, i = 0, 0
    while state:
        if state & 1:
            out ^= cols[i]
        state >>= 1
        i += 1
    return out


@functools.lru_cache(maxsize=64)
def _zeros_operator(n):
    """Columns of the linear map that feeds ``n`` zero bytes through the
    CRC register (by repeated squaring of the one-byte map)."""
    one = [_TABLE_LIST[(1 << i) & 0xFF] ^ ((1 << i) >> 8) for i in range(32)]
    result = [1 << i for i in range(32)]
    while n:
        if n & 1:
            result = [_apply(one, c) for c in result]
        one = [_apply(one, c) for c in one]
        n >>= 1
    return result


def _raw_bytes(state, data):
    for b in data:
        state = _TABLE_LIST[(state ^ b) & 0xFF] ^ (state >> 8)
    return state


def crc32c_numpy(data):
    """CRC32C of ``data`` (bytes-like) without ``google_crc32c``.

    The register is linear over GF(2), so the bytes are cut into lanes of
    ``_LANE`` bytes, every lane's zero-start register runs at once in numpy,
    and the lanes are joined by the zero-feed operator: crc(A || B) =
    Z_len(B)(crc(A)) ^ crc(B); the last bytes run on from the joined
    register.  The 0xFFFFFFFF start and final xor are applied around
    that."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    n = buf.size
    lanes = n // _LANE
    raw = 0
    if lanes:
        block = buf[:lanes * _LANE].reshape(lanes, _LANE)
        reg = np.zeros(lanes, np.uint32)
        for j in range(_LANE):
            reg = _TABLE[(reg ^ block[:, j]) & 0xFF] ^ (reg >> 8)
        shift = _zeros_operator(_LANE)
        for value in reg.tolist():
            raw = _apply(shift, raw) ^ value
    raw = _raw_bytes(raw, buf[lanes * _LANE:].tolist())
    return (_apply(_zeros_operator(n), 0xFFFFFFFF) ^ raw) ^ 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def crc32c_impl():
    """The CRC32C function in use: ``google_crc32c``'s where it imports,
    else :func:`crc32c_numpy`."""
    try:
        import google_crc32c
    except ImportError:
        return crc32c_numpy
    return lambda data: int.from_bytes(
        google_crc32c.Checksum(bytes(data)).digest(), 'big')


def _masked_crc32c(data):
    crc = crc32c_impl()(data)
    return (((crc >> 15) | (crc << 17)) + _CRC_MASK_DELTA) & 0xFFFFFFFF


def write_record(fobj, payload):
    length = struct.pack('<Q', len(payload))
    fobj.write(length)
    fobj.write(struct.pack('<I', _masked_crc32c(length)))
    fobj.write(payload)
    fobj.write(struct.pack('<I', _masked_crc32c(payload)))


def read_records(fobj, validate=False):
    """Yield record payloads from a (possibly gzip-wrapped) TFRecord
    stream."""
    while True:
        header = fobj.read(12)
        if len(header) < 12:
            return
        (length,) = struct.unpack('<Q', header[:8])
        if validate:
            (length_crc,) = struct.unpack('<I', header[8:12])
            assert length_crc == _masked_crc32c(header[:8]), \
                'corrupt length crc'
        payload = fobj.read(length)
        footer = fobj.read(4)
        if len(payload) < length or len(footer) < 4:
            return  # truncated tail
        if validate:
            (data_crc,) = struct.unpack('<I', footer)
            assert data_crc == _masked_crc32c(payload), 'corrupt data crc'
        yield payload


class TFRecordWriter:
    """File-level writer; ``compression='GZIP'`` is TF's
    ``TFRecordCompressionType.GZIP``."""

    def __init__(self, path, compression='GZIP'):
        if compression == 'GZIP':
            self._f = gzip.open(path, 'wb')
        elif compression in (None, ''):
            self._f = open(path, 'wb')
        else:
            raise ValueError('unsupported compression {}'.format(compression))

    def write(self, payload):
        write_record(self._f, payload)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def tfrecord_iterator(path, compression='GZIP'):
    opener = gzip.open if compression == 'GZIP' else open
    with opener(path, 'rb') as f:
        yield from read_records(f)


# -- protobuf encoding --------------------------------------------------------------

def _varint(value):
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _signed_varint(value):
    # proto int64: negatives encode as 10-byte two's complement varints
    if value < 0:
        value += 1 << 64
    return _varint(value)


def _tag(field_number, wire_type):
    return _varint((field_number << 3) | wire_type)


def _len_delimited(field_number, payload):
    return _tag(field_number, 2) + _varint(len(payload)) + payload


class Feature:
    """One typed feature; ``kind`` in {'bytes', 'float', 'int64'}."""

    __slots__ = ('kind', 'values')

    def __init__(self, kind, values):
        self.kind = kind
        self.values = values

    def encode(self):
        if self.kind == 'bytes':
            inner = b''.join(_len_delimited(1, v) for v in self.values)
            return _len_delimited(1, inner)
        if self.kind == 'float':
            arr = np.asarray(self.values, dtype='<f4')
            inner = _tag(1, 2) + _varint(arr.nbytes) + arr.tobytes()
            return _len_delimited(2, inner)
        if self.kind == 'int64':
            packed = b''.join(_signed_varint(int(v)) for v in self.values)
            inner = _tag(1, 2) + _varint(len(packed)) + packed
            return _len_delimited(3, inner)
        raise ValueError('unknown feature kind {}'.format(self.kind))


def bytes_feature(value):
    return Feature('bytes', [value])


def float_feature(values):
    return Feature('float', values)


def int64_feature(values):
    return Feature('int64', values)


def encode_example(feature_dict):
    """Serialize {name: Feature} into a tf.train.Example payload."""
    entries = []
    for name, feat in feature_dict.items():
        key_bytes = name.encode('utf-8')
        entry = _len_delimited(1, key_bytes) + _len_delimited(2, feat.encode())
        entries.append(_len_delimited(1, entry))
    features_msg = b''.join(entries)
    return _len_delimited(1, features_msg)


# -- protobuf decoding ---------------------------------------------------------------

def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _iter_fields(buf, start=0, end=None):
    """Yield (field_number, wire_type, value_or_span) triples."""
    pos = start
    end = len(buf) if end is None else end
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            yield field, wire, (pos, pos + length)
            pos += length
        elif wire == 5:
            yield field, wire, struct.unpack_from('<I', buf, pos)[0]
            pos += 4
        elif wire == 1:
            yield field, wire, struct.unpack_from('<Q', buf, pos)[0]
            pos += 8
        else:
            raise ValueError('unsupported wire type {}'.format(wire))


def _to_signed64(v):
    return v - (1 << 64) if v >= (1 << 63) else v


def _decode_feature(buf, span):
    """Decode a Feature message span -> (kind, values)."""
    for field, wire, val in _iter_fields(buf, *span):
        if field == 1:  # BytesList
            values = []
            for f2, w2, v2 in _iter_fields(buf, *val):
                if f2 == 1:
                    values.append(bytes(buf[v2[0]:v2[1]]))
            return 'bytes', values
        if field == 2:  # FloatList
            packed_parts, unpacked = [], []
            for f2, w2, v2 in _iter_fields(buf, *val):
                if f2 == 1 and w2 == 2:  # packed
                    packed_parts.append(
                        np.frombuffer(buf[v2[0]:v2[1]], dtype='<f4'))
                elif f2 == 1 and w2 == 5:  # unpacked
                    unpacked.append(
                        struct.unpack('<f', struct.pack('<I', v2))[0])
            if packed_parts:
                return 'float', (packed_parts[0] if len(packed_parts) == 1
                                 else np.concatenate(packed_parts))
            return 'float', np.asarray(unpacked, dtype=np.float32)
        if field == 3:  # Int64List
            values = []
            for f2, w2, v2 in _iter_fields(buf, *val):
                if f2 == 1 and w2 == 2:  # packed varints
                    pos, endp = v2
                    while pos < endp:
                        v, pos = _read_varint(buf, pos)
                        values.append(_to_signed64(v))
                elif f2 == 1 and w2 == 0:
                    values.append(_to_signed64(v2))
            return 'int64', np.asarray(values, dtype=np.int64)
    return 'bytes', []


def decode_example(payload, keys=None):
    """Parse a tf.train.Example payload into {name: (kind, values)}.

    With ``keys`` given, only those feature names are decoded (the rest are
    skipped cheaply)."""
    buf = memoryview(payload)
    out = {}
    for field, wire, span in _iter_fields(buf):
        if field != 1:
            continue
        for f2, w2, entry_span in _iter_fields(buf, *span):
            if f2 != 1:
                continue
            key, feat_span = None, None
            for f3, w3, v3 in _iter_fields(buf, *entry_span):
                if f3 == 1:
                    key = bytes(buf[v3[0]:v3[1]]).decode('utf-8')
                elif f3 == 2:
                    feat_span = v3
            if key is None or feat_span is None:
                continue
            if keys is not None and key not in keys:
                continue
            out[key] = _decode_feature(buf, feat_span)
    return out
