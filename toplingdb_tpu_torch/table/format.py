"""On-disk SST framing: block handles, trailers, footer, compression
(copied from toplingdb_tpu/table/format.py).

Every block is written as
    payload' | compression_type(1B) | masked_crc32c(4B over payload'+type)
and the file ends with a fixed-size footer
    checksum_type(1B) | metaindex_handle | index_handle | padding
    | version(4B) | magic(8B)
Handles are (offset, size) varint64 pairs.
"""

from __future__ import annotations

import bz2
import lzma
import zlib
from dataclasses import dataclass

from toplingdb_tpu_torch.utils import coding, crc32c
from toplingdb_tpu_torch.utils.status import Corruption, NotSupported

MAGIC = 0x7470756C736D5354  # "tpulsmST" big-endian spelling, stored fixed64 LE
SINGLE_FAST_MAGIC = 0x7470756C736D4654  # "tpulsmFT": the flat L0/L1 format
CUCKOO_MAGIC = 0x7470756C736D4354  # "tpulsmCT": cuckoo-hash point lookups
PLAIN_MAGIC = 0x7470756C736D5054  # "tpulsmPT": plain table, prefix hash index
ZIP_MAGIC = 0x7470756C736D5A54  # "tpulsmZT": searchable-compression format
FOOTER_VERSION = 1
BLOCK_TRAILER_SIZE = 5  # type byte + crc32
MAX_HANDLE_LEN = 20     # two varint64s
FOOTER_LEN = 1 + 2 * MAX_HANDLE_LEN + 4 + 8

# Compression type byte (the reference's enum where the codec exists in
# both: kNoCompression=0, kSnappyCompression=1, kZlibCompression=2,
# kBZip2=3, kLZ4=4, kLZ4HC=5, kZSTD=7; kLZMA takes a private value).
NO_COMPRESSION = 0
SNAPPY_COMPRESSION = 1
ZLIB_COMPRESSION = 2
BZIP2_COMPRESSION = 3
LZ4_COMPRESSION = 4
LZ4HC_COMPRESSION = 5
ZSTD_COMPRESSION = 7
LZMA_COMPRESSION = 0x21

CHECKSUM_CRC32C = 1


@dataclass(frozen=True)
class BlockHandle:
    offset: int
    size: int  # payload size, excluding the 5-byte trailer

    def encode(self) -> bytes:
        return (coding.encode_varint64(self.offset)
                + coding.encode_varint64(self.size))

    @staticmethod
    def decode(buf: bytes, off: int = 0) -> tuple["BlockHandle", int]:
        o, off = coding.decode_varint64(buf, off)
        s, off = coding.decode_varint64(buf, off)
        return BlockHandle(o, s), off

    @staticmethod
    def decode_exact(buf: bytes) -> "BlockHandle":
        h, _ = BlockHandle.decode(buf, 0)
        return h


@dataclass(frozen=True)
class Footer:
    metaindex_handle: BlockHandle
    index_handle: BlockHandle
    checksum_type: int = CHECKSUM_CRC32C
    version: int = FOOTER_VERSION
    magic: int = MAGIC

    def encode(self) -> bytes:
        out = bytearray()
        out.append(self.checksum_type)
        out += self.metaindex_handle.encode()
        out += self.index_handle.encode()
        out += b"\x00" * (1 + 2 * MAX_HANDLE_LEN - len(out))
        out += coding.encode_fixed32(self.version)
        out += coding.encode_fixed64(self.magic)
        assert len(out) == FOOTER_LEN
        return bytes(out)

    @staticmethod
    def read_magic(buf: bytes) -> int:
        """The footer's magic number (format dispatch)."""
        if len(buf) < FOOTER_LEN:
            raise Corruption("footer too short")
        return coding.decode_fixed64(buf, len(buf) - 8)

    @staticmethod
    def decode(buf: bytes, expected_magic: int = MAGIC) -> "Footer":
        if len(buf) < FOOTER_LEN:
            raise Corruption("footer too short")
        tail = buf[-FOOTER_LEN:]
        magic = coding.decode_fixed64(tail, FOOTER_LEN - 8)
        if magic != expected_magic:
            raise Corruption(f"bad SST magic: {magic:#x}")
        version = coding.decode_fixed32(tail, FOOTER_LEN - 12)
        checksum_type = tail[0]
        mih, off = BlockHandle.decode(tail, 1)
        ih, _ = BlockHandle.decode(tail, off)
        return Footer(mih, ih, checksum_type, version, magic)


def compress(data: bytes, ctype: int, level: int | None = None,
             dict_: bytes = b"") -> bytes:
    if ctype == NO_COMPRESSION:
        return data
    if ctype == SNAPPY_COMPRESSION:
        from toplingdb_tpu_torch.utils import codecs

        return codecs.snappy_compress(data)
    if ctype == ZLIB_COMPRESSION:
        return zlib.compress(data, 6 if level is None else level)
    if ctype == BZIP2_COMPRESSION:
        return bz2.compress(data)
    if ctype == LZ4_COMPRESSION:
        from toplingdb_tpu_torch.utils import codecs

        return codecs.lz4_compress(data)
    if ctype == LZ4HC_COMPRESSION:
        from toplingdb_tpu_torch.utils import codecs

        return codecs.lz4_compress(data, hc=True, level=level or 9)
    if ctype == ZSTD_COMPRESSION:
        from toplingdb_tpu_torch.utils import codecs

        return codecs.zstd_compress(data, 3 if level is None else level,
                                    dict_)
    if ctype == LZMA_COMPRESSION:
        return lzma.compress(data)
    raise NotSupported(f"compression type {ctype}")


def decompress(data: bytes, ctype: int, dict_: bytes = b"") -> bytes:
    """Inflate one block payload. A payload its codec rejects raises
    Corruption, as does an unknown type byte."""
    if ctype == NO_COMPRESSION:
        return data
    try:
        if ctype == SNAPPY_COMPRESSION:
            from toplingdb_tpu_torch.utils import codecs

            return codecs.snappy_decompress(data)
        if ctype == ZLIB_COMPRESSION:
            return zlib.decompress(data)
        if ctype == BZIP2_COMPRESSION:
            return bz2.decompress(data)
        if ctype in (LZ4_COMPRESSION, LZ4HC_COMPRESSION):
            from toplingdb_tpu_torch.utils import codecs

            return codecs.lz4_decompress(data)
        if ctype == ZSTD_COMPRESSION:
            from toplingdb_tpu_torch.utils import codecs

            return codecs.zstd_decompress(data, dict_)
        if ctype == LZMA_COMPRESSION:
            return lzma.decompress(data)
    except (zlib.error, OSError, EOFError, lzma.LZMAError, ValueError) as e:
        raise Corruption(f"corrupt block (compression type {ctype}): {e}")
    raise Corruption(f"unknown compression type {ctype}")


def compress_for_block(raw: bytes, ctype: int, level: int | None = None,
                       dict_: bytes = b"") -> tuple[bytes, int]:
    """The CPU half of write_block: (payload, effective_type), falling back
    to uncompressed when compression gains less than 12.5%. Safe on worker
    threads (every codec releases the GIL)."""
    if ctype != NO_COMPRESSION:
        c = compress(raw, ctype, level, dict_)
        if len(c) < len(raw) - len(raw) // 8:
            return c, ctype
    return raw, NO_COMPRESSION


def write_compressed_block(wfile, payload: bytes,
                           out_type: int) -> BlockHandle:
    """The IO half of write_block: frame with the trailer, append, return
    the handle."""
    offset = wfile.file_size()
    crc = crc32c.value(payload + bytes([out_type]))
    wfile.append(payload)
    wfile.append(bytes([out_type]))
    wfile.append(coding.encode_fixed32(crc32c.mask(crc)))
    return BlockHandle(offset, len(payload))


def write_block(wfile, raw: bytes, ctype: int = NO_COMPRESSION,
                level: int | None = None, dict_: bytes = b"") -> BlockHandle:
    """Compress (if profitable), frame with the trailer, append. Returns
    the handle."""
    payload, out_type = compress_for_block(raw, ctype, level, dict_)
    return write_compressed_block(wfile, payload, out_type)


def read_block(rfile, handle: BlockHandle, verify_checksums: bool = True,
               dict_: bytes = b"") -> bytes:
    """Read, verify the trailer CRC, decompress."""
    buf = rfile.read(handle.offset, handle.size + BLOCK_TRAILER_SIZE)
    if len(buf) != handle.size + BLOCK_TRAILER_SIZE:
        raise Corruption(
            f"truncated block read at {handle.offset}: "
            f"got {len(buf)}, want {handle.size + BLOCK_TRAILER_SIZE}"
        )
    payload = buf[: handle.size]
    ctype = buf[handle.size]
    if verify_checksums:
        stored = crc32c.unmask(coding.decode_fixed32(buf, handle.size + 1))
        actual = crc32c.value(payload + bytes([ctype]))
        if stored != actual:
            raise Corruption(
                f"block checksum mismatch at {handle.offset}: "
                f"stored {stored:#x} != computed {actual:#x}"
            )
    return decompress(payload, ctype, dict_)
