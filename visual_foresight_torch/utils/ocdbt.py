"""TensorStore's OCDBT key-value store, read and written with numpy alone.

An orbax step directory written with ``use_ocdbt`` is such a store: a
``manifest.ocdbt`` at its root, b-tree nodes and values in data files under
``d/`` (the values of the vendored checkpoints sit in
``ocdbt.process_0/d/``, which the root's nodes name relative to the step
directory).  The format is TensorStore's "OCDBT on-disk format".

Every manifest, b-tree node and version-tree node is framed the same way:
a 4-byte magic, the framed length as 8 bytes little-endian, varints for the
format version and the compression (0 none, 1 zstd), the body, and a CRC32C
of all the bytes before it.  The reader checks each length and CRC and
raises ValueError on a mismatch.  zstd bodies go through the port's own
decoder (``utils/zstd.py``).

``OcdbtReader`` reads a manifest whose version tree is inline (the single-
file manifest that orbax writes), its version-tree nodes, the interior and
leaf b-tree nodes with their prefix-compressed keys, and each value, inline
or a reference (data file, offset, length).  ``write_store`` writes one
version: a leaf node and its values in one data file, uncompressed.
"""

import os
import struct
import time
import uuid

from visual_foresight_torch.data.tfrecord_io import crc32c_impl

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_TREE_MAGIC = 0x0CDB1234
MANIFEST_FILE = 'manifest.ocdbt'
COMPRESSION_NONE, COMPRESSION_ZSTD = 0, 1
# what orbax writes: 1 KiB inline values, 100 MB nodes, arity 16
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100000000
VERSION_TREE_ARITY_LOG2 = 4


class _Cursor:
    """A read position in a decoded body."""

    def __init__(self, data, what):
        self.data = memoryview(data)
        self.pos = 0
        self.what = what

    def _need(self, n):
        if self.pos + n > len(self.data):
            raise ValueError('{}: truncated'.format(self.what))

    def varint(self):
        value, shift = 0, 0
        while True:
            self._need(1)
            byte = self.data[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            if byte < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError('{}: varint too long'.format(self.what))

    def varints(self, n):
        return [self.varint() for _ in range(n)]

    def take(self, n):
        self._need(n)
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def u8(self):
        return self.take(1)[0]

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def done(self):
        if self.pos != len(self.data):
            raise ValueError('{}: {} bytes after its end'.format(
                self.what, len(self.data) - self.pos))


def _varint(value):
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _varints(values):
    return b''.join(_varint(v) for v in values)


def decode_framed(data, magic, what):
    """The body of a framed file (manifest or node), after its length, CRC,
    version and compression are checked and its body decompressed."""
    data = bytes(data)
    if len(data) < 4 + 8 + 2 + 4:
        raise ValueError('{}: {} bytes is too short'.format(what, len(data)))
    got_magic, length = struct.unpack('>I', data[:4])[0], \
        struct.unpack('<Q', data[4:12])[0]
    if got_magic != magic:
        raise ValueError('{}: magic {:08x}, expected {:08x}'.format(
            what, got_magic, magic))
    if length != len(data):
        raise ValueError('{}: says {} bytes, holds {}'.format(
            what, length, len(data)))
    crc = struct.unpack('<I', data[-4:])[0]
    if crc32c_impl()(data[:-4]) != crc:
        raise ValueError('{}: CRC32C mismatch'.format(what))
    cur = _Cursor(data[:-4], what)
    cur.pos = 12
    version, compression = cur.varint(), cur.varint()
    if version != 0:
        raise ValueError('{}: format version {}'.format(what, version))
    body = data[cur.pos:-4]
    if compression == COMPRESSION_ZSTD:
        from visual_foresight_torch.utils import zstd
        return zstd.decompress(body)
    if compression != COMPRESSION_NONE:
        raise ValueError('{}: compression {}'.format(what, compression))
    return body


def encode_framed(body, magic):
    """A framed file holding ``body`` uncompressed."""
    head = struct.pack('>I', magic)
    rest = _varint(0) + _varint(COMPRESSION_NONE) + bytes(body)
    length = len(head) + 8 + len(rest) + 4
    data = head + struct.pack('<Q', length) + rest
    return data + struct.pack('<I', crc32c_impl()(data))


def _read_data_file_table(cur):
    """[path relative to the store's root] of a node's data file table."""
    n = cur.varint()
    prefix = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    base = cur.varints(n)
    paths, prev = [], b''
    for i in range(n):
        path = prev[:prefix[i]] + cur.take(suffix[i])
        if prefix[i] > len(prev) or base[i] > len(path):
            raise ValueError('{}: bad data file table'.format(cur.what))
        paths.append(path.decode())
        prev = path
    return paths


def _write_data_file_table(paths):
    encoded = [p.encode() for p in paths]
    prefix, suffix, prev = [], [], b''
    for i, path in enumerate(encoded):
        common = _common_prefix(prev, path) if i else 0
        prefix.append(common)
        suffix.append(path[common:])
        prev = path
    return (_varint(len(encoded)) + _varints(prefix[1:]) +
            _varints(len(s) for s in suffix) + _varints([0] * len(encoded)) +
            b''.join(suffix))


def _common_prefix(a, b):
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _read_keys(cur, n, with_subtree_prefix=False):
    prefix = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    subtree = cur.varints(n) if with_subtree_prefix else None
    keys, prev = [], b''
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError('{}: bad key prefix'.format(cur.what))
        key = prev[:prefix[i]] + cur.take(suffix[i])
        keys.append(key)
        prev = key
    return keys, subtree


def _read_refs(cur, n, paths, lengths=None):
    """n references (path, offset, length): the file ids, the offsets and,
    unless given, the lengths, each as an array."""
    ids = cur.varints(n)
    offsets = cur.varints(n)
    lengths = cur.varints(n) if lengths is None else lengths
    refs = []
    for i in range(n):
        if ids[i] >= len(paths):
            raise ValueError('{}: data file {} of {}'.format(
                cur.what, ids[i], len(paths)))
        refs.append((paths[ids[i]], offsets[i], lengths[i]))
    return refs


def _read_generations(cur, n, paths):
    """A version-tree leaf's entries (also the manifest's inline versions):
    one b-tree root a generation."""
    gens = cur.varints(n)
    heights = [cur.u8() for _ in range(n)]
    roots = _read_refs(cur, n, paths)
    stats = [cur.varints(n) for _ in range(3)]
    times = [cur.unpack('<Q') for _ in range(n)]
    return [{'generation': gens[i], 'root_height': heights[i],
             'root': roots[i], 'num_keys': stats[0][i],
             'num_tree_bytes': stats[1][i],
             'num_indirect_value_bytes': stats[2][i],
             'commit_time': times[i]} for i in range(n)]


def _read_version_refs(cur, n, paths, heights=None):
    """References to version-tree nodes: the manifest's carry their heights
    after the other arrays; a node's children are one level below it."""
    gens = cur.varints(n)
    refs = _read_refs(cur, n, paths)
    counts = cur.varints(n)
    times = [cur.unpack('<Q') for _ in range(n)]
    if heights is None:
        heights = [cur.u8() for _ in range(n)]
    return [{'generation': gens[i], 'node': refs[i], 'num_generations':
             counts[i], 'commit_time': times[i], 'height': heights[i]}
            for i in range(n)]


class OcdbtReader:
    """The latest version of the OCDBT store at ``root``: its keys, as
    strings in byte order, and their values."""

    def __init__(self, root):
        self.root = os.path.abspath(str(root))
        self._files = {}
        path = os.path.join(self.root, MANIFEST_FILE)
        if not os.path.isfile(path):
            raise FileNotFoundError('no {} in {}'.format(MANIFEST_FILE,
                                                         self.root))
        with open(path, 'rb') as f:
            body = decode_framed(f.read(), MANIFEST_MAGIC, path)
        cur = _Cursor(body, path)
        self.config = self._read_config(cur)
        if self.config['manifest_kind'] != 0:
            raise ValueError('{}: numbered manifests are not supported'
                             .format(path))
        paths = _read_data_file_table(cur)
        self._inline_versions = _read_generations(cur, cur.varint(), paths)
        self._version_nodes = _read_version_refs(cur, cur.varint(), paths)
        cur.done()
        if not self._inline_versions:
            raise ValueError('{}: no version'.format(path))
        self.latest = self._inline_versions[-1]
        self._entries = None

    @staticmethod
    def _read_config(cur):
        config = {'uuid': cur.take(16).hex(), 'manifest_kind': cur.varint(),
                  'max_inline_value_bytes': cur.varint(),
                  'max_decoded_node_bytes': cur.varint(),
                  'version_tree_arity_log2': cur.u8(),
                  'compression': cur.varint()}
        if config['compression'] == COMPRESSION_ZSTD:
            config['zstd_level'] = cur.unpack('<i')
        elif config['compression'] != COMPRESSION_NONE:
            raise ValueError('{}: compression {}'.format(
                cur.what, config['compression']))
        return config

    def _bytes(self, path, offset, length):
        full = os.path.join(self.root, path)
        data = self._files.get(full)
        if data is None:
            with open(full, 'rb') as f:
                data = self._files[full] = f.read()
        if offset + length > len(data):
            raise ValueError('{}: [{}, +{}) past its {} bytes'.format(
                full, offset, length, len(data)))
        return data[offset:offset + length]

    def versions(self):
        """Every generation, oldest first: the version-tree nodes' leaves,
        then the manifest's inline versions."""
        out = []
        for ref in self._version_nodes:
            out.extend(self._version_node(ref['node'], ref['height']))
        return out + list(self._inline_versions)

    def _version_node(self, ref, height):
        path, offset, length = ref
        what = '{}@{}'.format(path, offset)
        cur = _Cursor(decode_framed(self._bytes(path, offset, length),
                                    VERSION_TREE_MAGIC, what), what)
        cur.u8()                                    # arity log2
        node_height = cur.u8()
        if node_height != height:
            raise ValueError('{}: height {}, expected {}'.format(
                what, node_height, height))
        paths = _read_data_file_table(cur)
        n = cur.varint()
        if height == 0:
            entries = _read_generations(cur, n, paths)
            cur.done()
            return entries
        children = _read_version_refs(cur, n, paths, [height - 1] * n)
        cur.done()
        out = []
        for child in children:
            out.extend(self._version_node(child['node'], height - 1))
        return out

    def _walk(self, ref, height, prefix, out):
        path, offset, length = ref
        what = '{}@{}'.format(path, offset)
        cur = _Cursor(decode_framed(self._bytes(path, offset, length),
                                    BTREE_MAGIC, what), what)
        if cur.u8() != height:
            raise ValueError('{}: b-tree node height differs from its '
                             'reference'.format(what))
        paths = _read_data_file_table(cur)
        n = cur.varint()
        if height == 0:
            keys, _ = _read_keys(cur, n)
            lengths = cur.varints(n)
            kinds = cur.varints(n)
            if any(k > 1 for k in kinds):
                raise ValueError('{}: value kind {}'.format(what, max(kinds)))
            indirect = [i for i in range(n) if kinds[i] == 1]
            refs = _read_refs(cur, len(indirect), paths,
                              [lengths[i] for i in indirect])
            refs = dict(zip(indirect, refs))
            for i in range(n):
                value = refs[i] if kinds[i] == 1 else cur.take(lengths[i])
                out.append((prefix + keys[i], value))
            cur.done()
            return
        keys, subtree = _read_keys(cur, n, with_subtree_prefix=True)
        refs = _read_refs(cur, n, paths)
        for _ in range(3):                   # keys, tree and value bytes
            cur.varints(n)
        cur.done()
        for key, common, child in zip(keys, subtree, refs):
            if common > len(key):
                raise ValueError('{}: bad subtree prefix'.format(what))
            self._walk(child, height - 1, prefix + key[:common], out)

    def _all(self):
        if self._entries is None:
            root = self.latest['root']
            out = []
            if root[2]:                     # an empty tree has no root node
                self._walk(root, self.latest['root_height'], b'', out)
            self._entries = {k.decode(): v for k, v in out}
        return self._entries

    def keys(self):
        return list(self._all())

    def __contains__(self, key):
        return key in self._all()

    def read(self, key):
        """The value of ``key`` (bytes); KeyError where it is absent."""
        value = self._all()[key]
        if isinstance(value, tuple):
            return self._bytes(*value)
        return value

    def items(self):
        return {k: self.read(k) for k in self._all()}


def write_store(root, items, commit_time_ns=None):
    """Write ``items`` ({str key: bytes}) as a new OCDBT store at ``root``:
    one generation, one leaf node, values over
    ``MAX_INLINE_VALUE_BYTES`` out of line, all in one data file, nothing
    compressed."""
    os.makedirs(os.path.join(root, 'd'), exist_ok=True)
    rel = 'd/{}'.format(uuid.uuid4().hex)
    keys = sorted(items, key=lambda k: k.encode())
    blob, offsets, inline = bytearray(), {}, []
    for key in keys:
        value = bytes(items[key])
        if len(value) > MAX_INLINE_VALUE_BYTES:
            offsets[key] = len(blob)
            blob += value
    indirect_bytes = len(blob)
    encoded = [k.encode() for k in keys]
    prefix, prev = [], b''
    for i, key in enumerate(encoded):
        prefix.append(_common_prefix(prev, key) if i else 0)
        prev = key
    body = bytearray([0])                                  # height: a leaf
    body += _write_data_file_table([rel] if offsets else [])
    body += _varint(len(keys)) + _varints(prefix[1:])
    body += _varints(len(k) - p for k, p in zip(encoded, prefix))
    body += b''.join(k[p:] for k, p in zip(encoded, prefix))
    body += _varints(len(items[k]) for k in keys)
    body += _varints(1 if k in offsets else 0 for k in keys)
    body += _varints(0 for k in keys if k in offsets)
    body += _varints(offsets[k] for k in keys if k in offsets)
    body += b''.join(bytes(items[k]) for k in keys if k not in offsets)
    node = encode_framed(body, BTREE_MAGIC)
    node_offset = len(blob)
    blob += node
    with open(os.path.join(root, rel), 'wb') as f:
        f.write(blob)

    stamp = time.time_ns() if commit_time_ns is None else commit_time_ns
    manifest = bytearray(uuid.uuid4().bytes)
    manifest += _varint(0)                                 # single file
    manifest += _varint(MAX_INLINE_VALUE_BYTES)
    manifest += _varint(MAX_DECODED_NODE_BYTES)
    manifest += bytes([VERSION_TREE_ARITY_LOG2])
    manifest += _varint(COMPRESSION_NONE)
    manifest += _write_data_file_table([rel])
    manifest += _varint(1)                                 # one version
    manifest += _varint(1)                                 # generation 1
    manifest += bytes([0])                                 # root height
    manifest += _varint(0) + _varint(node_offset) + _varint(len(node))
    manifest += _varint(len(keys)) + _varint(len(node)) + \
        _varint(indirect_bytes)
    manifest += struct.pack('<Q', stamp)
    manifest += _varint(0)                           # no version-tree node
    tmp = os.path.join(root, MANIFEST_FILE + '.tmp{}'.format(os.getpid()))
    with open(tmp, 'wb') as f:
        f.write(encode_framed(manifest, MANIFEST_MAGIC))
    os.replace(tmp, os.path.join(root, MANIFEST_FILE))
