"""Encrypted Env: transparent at-rest encryption of every file (copied
from toplingdb_tpu/env/encrypted.py).

The role of RocksDB's EncryptedEnv (env/env_encryption.cc): a
BlockAccessCipherStream seam. Any byte-addressable stream cipher works,
because reads and writes XOR a position-derived keystream, so random
access never needs block alignment. CTRCipher is a counter-mode keystream
built on the project's xxh64 (block i = xxh64(key, seed=i), the
reference's bytes), computed for a whole span of blocks at once with
numpy; it stands in for a real provider, which plugs into the same seam.

A file handle of this Env exposes no raw file descriptor, so the native
point-read chain never reads ciphertext past the Env: its tables take the
Python chain (table/reader.py `_nget`)."""

from __future__ import annotations

import numpy as np

from toplingdb_tpu_torch.env.env import Env

_M = np.uint64
_P1 = _M(11400714785074694791)
_P2 = _M(14029467366897019727)
_P3 = _M(1609587929392839161)
_P4 = _M(9650029242287828579)
_P5 = _M(2870177450012600261)


def _rotl(x, r: int):
    return (x << _M(r)) | (x >> _M(64 - r))


def _rnd(acc, lane):
    return _rotl(acc + lane * _P2, 31) * _P1


def xxh64_seeds(data: bytes, seeds: np.ndarray) -> np.ndarray:
    """xxHash64 of one `data` under every seed of `seeds` (uint64), as
    utils.crc32c.xxh64(data, seed) computes it for each seed."""
    n = len(data)
    with np.errstate(over="ignore"):
        s = seeds.astype(np.uint64)
        p = 0
        if n >= 32:
            v1, v2, v3, v4 = s + _P1 + _P2, s + _P2, s.copy(), s - _P1
            while p + 32 <= n:
                lanes = [_M(int.from_bytes(data[p + 8 * j:p + 8 * j + 8],
                                           "little")) for j in range(4)]
                v1, v2, v3, v4 = (_rnd(v1, lanes[0]), _rnd(v2, lanes[1]),
                                  _rnd(v3, lanes[2]), _rnd(v4, lanes[3]))
                p += 32
            h = _rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)
            for v in (v1, v2, v3, v4):
                h = (h ^ _rnd(_M(0), v)) * _P1 + _P4
        else:
            h = s + _P5
        h = h + _M(n)
        while p + 8 <= n:
            lane = _M(int.from_bytes(data[p:p + 8], "little"))
            h = _rotl(h ^ _rnd(_M(0), lane), 27) * _P1 + _P4
            p += 8
        if p + 4 <= n:
            w = _M(int.from_bytes(data[p:p + 4], "little")) * _P1
            h = _rotl(h ^ w, 23) * _P2 + _P3
            p += 4
        while p < n:
            h = _rotl(h ^ (_M(data[p]) * _P5), 11) * _P1
            p += 1
        h = h ^ (h >> _M(33))
        h = h * _P2
        h = h ^ (h >> _M(29))
        h = h * _P3
        h = h ^ (h >> _M(32))
    return h


class CipherStream:
    """Position-addressable keystream: encrypt = decrypt = XOR(keystream)."""

    def keystream(self, offset: int, n: int) -> bytes:
        raise NotImplementedError

    def crypt(self, data, offset: int) -> bytes:
        if not len(data):
            return b""
        ks = np.frombuffer(self.keystream(offset, len(data)), np.uint8)
        return (np.frombuffer(data, np.uint8) ^ ks).tobytes()


class CTRCipher(CipherStream):
    """Counter-mode keystream: block i = xxh64(key, seed=i), little-endian.
    Deterministic, position-addressable, no state (the provider seam; NOT
    a vetted production cipher)."""

    BLOCK = 8

    def __init__(self, key: bytes):
        self._key = bytes(key)

    def keystream(self, offset: int, n: int) -> bytes:
        first = offset // self.BLOCK
        last = (offset + n + self.BLOCK - 1) // self.BLOCK
        blocks = xxh64_seeds(self._key,
                             np.arange(first, last, dtype=np.uint64))
        skip = offset - first * self.BLOCK
        return blocks.astype("<u8").tobytes()[skip:skip + n]


class _EncWritable:
    def __init__(self, f, cipher: CipherStream):
        self._f = f
        self._c = cipher

    def append(self, data) -> None:
        self._f.append(self._c.crypt(data, self._f.file_size()))

    def flush(self) -> None:
        self._f.flush()

    def sync(self) -> None:
        self._f.sync()

    def close(self) -> None:
        self._f.close()

    def file_size(self) -> int:
        return self._f.file_size()


class _EncRandomAccess:
    def __init__(self, f, cipher: CipherStream):
        self._f = f
        self._c = cipher

    def read(self, offset: int, n: int) -> bytes:
        return self._c.crypt(self._f.read(offset, n), offset)

    def size(self) -> int:
        return self._f.size()

    def close(self) -> None:
        self._f.close()


class _EncSequential:
    def __init__(self, f, cipher: CipherStream):
        self._f = f
        self._c = cipher
        self._pos = 0

    def read(self, n: int) -> bytes:
        data = self._c.crypt(self._f.read(n), self._pos)
        self._pos += len(data)
        return data

    def close(self) -> None:
        self._f.close()


class EncryptedEnv(Env):
    """Wraps any Env; the file BYTES on the base Env are ciphertext."""

    def __init__(self, base: Env, cipher: CipherStream):
        self.base = base
        self.cipher = cipher

    def new_writable_file(self, path: str):
        return _EncWritable(self.base.new_writable_file(path), self.cipher)

    def new_random_access_file(self, path: str):
        return _EncRandomAccess(
            self.base.new_random_access_file(path), self.cipher
        )

    def new_sequential_file(self, path: str):
        return _EncSequential(
            self.base.new_sequential_file(path), self.cipher
        )

    def get_free_space(self, path: str) -> int:
        return self.base.get_free_space(path)

    def read_file(self, path: str) -> bytes:
        return self.cipher.crypt(self.base.read_file(path), 0)

    def write_file(self, path: str, data: bytes, sync: bool = False) -> None:
        self.base.write_file(path, self.cipher.crypt(data, 0), sync=sync)

    def file_exists(self, path: str) -> bool:
        return self.base.file_exists(path)

    def get_file_size(self, path: str) -> int:
        return self.base.get_file_size(path)

    def delete_file(self, path: str) -> None:
        self.base.delete_file(path)

    def rename_file(self, src: str, dst: str) -> None:
        self.base.rename_file(src, dst)

    def create_dir(self, path: str) -> None:
        self.base.create_dir(path)

    def get_children(self, path: str) -> list[str]:
        return self.base.get_children(path)
