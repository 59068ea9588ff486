"""Status/error model (copied from toplingdb_tpu/utils/status.py, trimmed
to the error classes the port raises)."""

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
