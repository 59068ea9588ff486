"""Status/error model (copied from toplingdb_tpu/utils/status.py, trimmed
to the error classes the port raises, and the background-error severities
of RocksDB's ErrorHandler, db/error_handler.h)."""

from __future__ import annotations

import enum


class Code(enum.IntEnum):
    OK = 0
    NOT_FOUND = 1
    CORRUPTION = 2
    NOT_SUPPORTED = 3
    INVALID_ARGUMENT = 4
    IO_ERROR = 5
    MERGE_IN_PROGRESS = 6
    SHUTDOWN_IN_PROGRESS = 8
    BUSY = 11
    TRY_AGAIN = 13


class Severity(enum.IntEnum):
    """Background-error severity, mirroring RocksDB's db/error_handler.h."""

    NO_ERROR = 0
    SOFT_ERROR = 1      # writes may stall, reads fine, auto-recoverable
    HARD_ERROR = 2      # writes stopped until Resume()
    FATAL_ERROR = 3     # DB must be reopened
    UNRECOVERABLE = 4


class Status(Exception):
    """Base error for the framework. `code` classifies it."""

    code: Code = Code.IO_ERROR

    def __init__(self, msg: str = "", *, retryable: bool = False):
        super().__init__(msg)
        self.retryable = retryable

    @property
    def message(self) -> str:
        return str(self)


class NotFound(Status):
    code = Code.NOT_FOUND


class Corruption(Status):
    code = Code.CORRUPTION


class NotSupported(Status):
    code = Code.NOT_SUPPORTED


class InvalidArgument(Status):
    code = Code.INVALID_ARGUMENT


class IOError_(Status):
    code = Code.IO_ERROR


class MergeInProgress(Status):
    code = Code.MERGE_IN_PROGRESS


class ShutdownInProgress(Status):
    code = Code.SHUTDOWN_IN_PROGRESS


class Busy(Status):
    code = Code.BUSY


class TryAgain(Status):
    code = Code.TRY_AGAIN


class NoSpace(IOError_):
    """Out-of-disk-space IO error (RocksDB's Status::NoSpace() subcode
    kNoSpace). Retryable by default: the error handler latches it SOFT
    and the auto-recover loop clears it."""

    def __init__(self, msg: str = "", *, retryable: bool = True):
        super().__init__(msg, retryable=retryable)


def is_no_space(e: BaseException) -> bool:
    """Does this exception chain mean the disk (or byte budget) is full?
    Recognizes NoSpace, a raw OSError ENOSPC anywhere in the cause chain,
    and wrapped messages (the posix Env re-raises OSErrors as IOError_
    with the strerror text embedded)."""
    import errno

    seen = 0
    while e is not None and seen < 8:
        if isinstance(e, NoSpace):
            return True
        if isinstance(e, OSError) and e.errno == errno.ENOSPC:
            return True
        msg = str(e).lower()
        if "enospc" in msg or "no space left" in msg:
            return True
        e = e.__cause__ or e.__context__
        seen += 1
    return False
