"""Message callback / logging layer (the port's copy of `omm_tpu/log.py`).

Mirrors the reference Logger (src/log.h:33-140) and its exact validation
message strings (string-compatible with test_omm_log.cpp expectations):
helpers raise the matching error code after routing the message to the
user callback, so validation reads as one-liners.
"""
from __future__ import annotations

import enum
from typing import Callable, Optional

from .types import (BakeError, Format, OpacityState, Result, SpecialIndex)


class MessageSeverity(enum.IntEnum):
    Info = 0
    PerfWarning = 1
    Error = 2
    Fatal = 3


MessageCallback = Callable[[MessageSeverity, str], None]


def opacity_state_name(s: OpacityState) -> str:
    return {OpacityState.Transparent: "Transparent",
            OpacityState.Opaque: "Opaque",
            OpacityState.UnknownTransparent: "UnknownTransparent",
            OpacityState.UnknownOpaque: "UnknownOpaque"}[OpacityState(s)]


def format_name(f: Format) -> str:
    return {Format.OC1_2_State: "OC1_2_State",
            Format.OC1_4_State: "OC1_4_State",
            Format.INVALID: "INVALID"}[Format(f)]


def special_index_name(s: SpecialIndex) -> str:
    """ToString(ommSpecialIndex) with the reference's spaced names."""
    return {SpecialIndex.FullyTransparent: "Fully Transparent",
            SpecialIndex.FullyOpaque: "Fully Opaque",
            SpecialIndex.FullyUnknownTransparent: "Fully Unknown Transparent",
            SpecialIndex.FullyUnknownOpaque: "Fully Unknown Opaque"}[
                SpecialIndex(s)]


class Logger:
    def __init__(self, callback: Optional[MessageCallback] = None):
        self._cb = callback

    def has_logger(self) -> bool:
        return self._cb is not None

    def _emit(self, severity: MessageSeverity, message: str):
        if self._cb is not None:
            self._cb(severity, message)

    def info(self, message: str):
        self._emit(MessageSeverity.Info, message)

    def perf_warn(self, message: str):
        self._emit(MessageSeverity.PerfWarning, message)

    def error(self, message: str):
        self._emit(MessageSeverity.Error, message)

    def fatal(self, message: str):
        self._emit(MessageSeverity.Fatal, message)

    # Error-raising helpers (log.h:90-140).
    def invalid_arg(self, message: str):
        self._emit(MessageSeverity.Error, message)
        raise BakeError(Result.INVALID_ARGUMENT, message)

    def not_implemented(self, message: str):
        self._emit(MessageSeverity.Error, message)
        raise BakeError(Result.NOT_IMPLEMENTED, message)
