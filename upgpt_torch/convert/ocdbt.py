"""A read-only OCDBT key-value store: the directory tensorstore's `ocdbt`
driver writes, and orbax under every checkpoint it saves.

The layout (tensorstore's "OCDBT on-disk format"):

- Every manifest and B-tree node starts with a magic number (big-endian
  `0x0cdb3a2a` for a manifest, `0x0cdb20de` for a node), the file's length
  (u64 little-endian), a format version and a compression varint (0 none,
  1 zstd over the rest of the body), and ends with the CRC-32C of all the
  bytes before it (u32 little-endian). A node may sit at an offset inside
  a data file, after value bytes; its length then bounds it.
- The manifest (`manifest.ocdbt`) holds the config (uuid, manifest kind,
  inline value limit, decoded node limit, version tree arity, compression),
  a data-file table and the newest versions inline: each version's root
  node (data file, offset, length, height) and statistics.
- A data-file table lists paths, each prefix-coded on the one before it
  and split into a base path and a relative path. A node's paths are
  relative to the base path of the file the node was read from, the
  manifest's to the store's directory.
- A node is a height byte, a data-file table and its entries in columns:
  keys prefix-coded on the one before; an interior node's subtree common
  prefix lengths (stripped from every key below) and child references; a
  leaf's value lengths, kinds (0 inline, 1 a range of a data file) and
  the data file and offset of each indirect value, then the inline bytes.

`OcdbtStore(dir)` reads the manifest and walks the newest version's tree
once, checking each file's CRC-32C (ValueError naming the file on a
mismatch); `keys()` lists the keys and `read(key)` reads a value,
taking only its byte range from its data file.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, NamedTuple, Tuple, Union

from upgpt_torch.native import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_MISSING = (1 << 64) - 1  # an empty tree's root offset and length


class _Reader:
    """Little-endian fields and varints of one decoded body."""

    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.where}: truncated OCDBT body")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out = shift = 0
        while True:
            byte = self.u8()
            out |= (byte & 0x7F) << shift
            if byte < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.where}: varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


class _Ref(NamedTuple):
    path: Path  # the data file
    offset: int
    length: int


def _check_file(data: bytes, magic: int, where: str, cap: int) -> _Reader:
    """A reader over the decoded body of one manifest or node, after its
    magic number, length and CRC-32C are checked; zstd bodies decode up to
    `cap` bytes."""
    if len(data) < 12 + 2 + 4:
        raise ValueError(f"{where}: too short for an OCDBT file")
    if int.from_bytes(data[:4], "big") != magic:
        raise ValueError(f"{where}: magic {data[:4].hex()}, expected "
                         f"{magic:08x}")
    if int.from_bytes(data[4:12], "little") != len(data):
        raise ValueError(f"{where}: length field "
                         f"{int.from_bytes(data[4:12], 'little')} against "
                         f"{len(data)} bytes")
    stored = int.from_bytes(data[-4:], "little")
    if zstd.crc32c(memoryview(data)[:-4]) != stored:
        raise ValueError(f"{where}: CRC-32C mismatch (stored {stored:08x})")
    head = _Reader(data[:-4], where)
    head.pos = 12
    head.varint()  # format version
    compression = head.varint()
    body = data[head.pos:-4]
    if compression == 1:
        body = bytes(zstd.decompress(body, cap=cap))
    elif compression != 0:
        raise ValueError(f"{where}: unknown compression {compression}")
    return _Reader(body, where)


class OcdbtStore:
    """The newest version of the OCDBT database in `root`."""

    def __init__(self, root: Union[str, os.PathLike]):
        self.root = Path(root)
        where = str(self.root / "manifest.ocdbt")
        r = _check_file((self.root / "manifest.ocdbt").read_bytes(),
                        MANIFEST_MAGIC, where, 1 << 30)
        r.take(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"{where}: manifest kind {kind} (numbered "
                             f"manifests) is not read; orbax writes 'single'")
        r.varint()  # inline value limit
        self.max_decoded_node_bytes = r.varint()
        r.u8()  # version tree arity (log2)
        if r.varint() == 1:
            r.take(4)  # zstd level, int32
        files = self._data_files(r, self.root)
        n = r.varint()
        if n == 0:
            raise ValueError(f"{where}: no version")
        r.varints(n)  # generation numbers
        height = [r.u8() for _ in range(n)]
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        self.height = height[-1]  # the newest version's
        self._values: Dict[bytes, Union[bytes, _Ref]] = {}
        self.nodes = 0
        if offsets[-1] != _MISSING:
            self._walk(files[ids[-1]], offsets[-1], lengths[-1],
                       self.height, b"")

    @staticmethod
    def _data_files(r: _Reader, base: Path) -> List[Tuple[Path, Path]]:
        """A data-file table: for each file (its path, the directory its
        base path names), resolved under `base`."""
        n = r.varint()
        prefix = [0] + r.varints(n - 1) if n else []
        suffix = r.varints(n)
        base_len = r.varints(n)
        out, last = [], b""
        for i in range(n):
            if prefix[i] > len(last):
                raise ValueError(f"{r.where}: data-file path prefix past "
                                 f"the previous path")
            last = last[:prefix[i]] + r.take(suffix[i])
            if base_len[i] > len(last):
                raise ValueError(f"{r.where}: base path past its path")
            text = last.decode("utf-8")
            if ".." in text.split("/") or text.startswith("/"):
                raise ValueError(f"{r.where}: data file {text!r} leaves the "
                                 f"store")
            out.append((base / text,
                        base / last[:base_len[i]].decode("utf-8")))
        return out

    def _read_range(self, ref: _Ref) -> bytes:
        with open(ref.path, "rb") as f:
            f.seek(ref.offset)
            data = f.read(ref.length)
        if len(data) != ref.length:
            raise ValueError(f"{ref.path}: {len(data)} bytes at "
                             f"{ref.offset}, {ref.length} expected")
        return data

    def _walk(self, file: Tuple[Path, Path], offset: int, length: int,
              height: int, prefix: bytes) -> None:
        """Read the node at `offset` of `file` (its path, its base
        directory) and record its values, or walk its children."""
        path, base = file
        where = str(path) if offset == 0 else f"{path} (node at {offset})"
        r = _check_file(self._read_range(_Ref(path, offset, length)),
                        NODE_MAGIC, where, self.max_decoded_node_bytes)
        self.nodes += 1
        if r.u8() != height:
            raise ValueError(f"{where}: height disagrees with its parent")
        files = self._data_files(r, base)
        n = r.varint()
        key_prefix = [0] + r.varints(n - 1) if n else []
        key_suffix = r.varints(n)
        common = r.varints(n) if height > 0 else None
        keys, last = [], b""
        for i in range(n):
            if key_prefix[i] > len(last):
                raise ValueError(f"{where}: key prefix past the previous key")
            last = last[:key_prefix[i]] + r.take(key_suffix[i])
            keys.append(last)

        def data_file(i: int) -> Tuple[Path, Path]:
            if i >= len(files):
                raise ValueError(f"{where}: data file {i} of {len(files)}")
            return files[i]

        if height > 0:
            ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
            for i in range(n):
                if common[i] > len(keys[i]):
                    raise ValueError(f"{where}: subtree prefix past its key")
                self._walk(data_file(ids[i]), offsets[i], lengths[i],
                           height - 1, prefix + keys[i][:common[i]])
            return
        lengths = r.varints(n)
        kinds = [r.u8() for _ in range(n)]
        indirect = sum(1 for k in kinds if k == 1)
        if any(k > 1 for k in kinds):
            raise ValueError(f"{where}: unknown value kind")
        ids, offsets = r.varints(indirect), r.varints(indirect)
        j = 0
        for key, length, kind in zip(keys, lengths, kinds):
            if kind == 0:
                self._values[prefix + key] = r.take(length)
            else:
                self._values[prefix + key] = _Ref(data_file(ids[j])[0],
                                                   offsets[j], length)
                j += 1

    def keys(self) -> List[str]:
        return sorted(k.decode("utf-8") for k in self._values)

    def __contains__(self, key: str) -> bool:
        return key.encode("utf-8") in self._values

    def read(self, key: str) -> bytes:
        """The value of `key`; KeyError where the store has none."""
        value = self._values[key.encode("utf-8")]
        return value if isinstance(value, bytes) else self._read_range(value)
