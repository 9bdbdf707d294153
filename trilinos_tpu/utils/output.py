"""Verbosity-gated, rank-aware output.

Analogue of ``Belos::OutputManager`` (reference:
packages/belos/src/BelosOutputManager.hpp — verbosity bitmask ``MsgType``,
rank-0-only gating) and ``Teuchos::FancyOStream`` rank-aware printing.
Here "rank" is ``jax.process_index()``.
"""
from __future__ import annotations

import enum
import sys


class MsgType(enum.IntFlag):
    """Verbosity bitmask, mirroring Belos' MsgType semantics."""

    ERRORS = 1
    WARNINGS = 2
    ITERATION_DETAILS = 4
    ORTHO_DETAILS = 8
    FINAL_SUMMARY = 16
    TIMING_DETAILS = 32
    STATUS_TEST_DETAILS = 64
    DEBUG = 128


class OutputManager:
    def __init__(self, verbosity: int = MsgType.ERRORS, stream=None, rank0_only=True):
        self.verbosity = int(verbosity)
        self.stream = stream if stream is not None else sys.stdout
        self.rank0_only = rank0_only

    def _is_rank0(self) -> bool:
        try:
            import jax

            return jax.process_index() == 0
        except Exception:  # pragma: no cover
            return True

    def is_verbosity(self, msg_type: int) -> bool:
        return bool(self.verbosity & int(msg_type))

    def print(self, msg_type: int, message: str) -> None:
        if self.is_verbosity(msg_type) and (not self.rank0_only or self._is_rank0()):
            print(message, file=self.stream)
