"""Undo/redo: full-image snapshots swapped to disk.

Port of ``siriltpu.core.undo``, copied without change.

Reference: src/core/undo.c — ``undo_save_state`` (:164) writes the
current image to a swapfile in com.swap_dir (:39), history is a bounded
list flushed at exit (:224).
"""

from __future__ import annotations

import os
import tempfile
import uuid
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from siriltpu_torch.core.frame import Frame

MAX_HISTORY = 20


@dataclass
class _UndoRecord:
    path: str
    message: str
    shape: tuple
    meta: dict


class UndoHistory:
    def __init__(self, swap_dir: Optional[str] = None):
        self.swap_dir = swap_dir or tempfile.gettempdir()
        self._undo: List[_UndoRecord] = []
        self._redo: List[_UndoRecord] = []

    def save_state(self, frame: Frame, message: str = "") -> None:
        """undo_save_state: snapshot BEFORE a modification."""
        path = os.path.join(self.swap_dir, f"siriltpu_undo_{uuid.uuid4().hex}.npy")
        np.save(path, frame.data)
        self._undo.append(_UndoRecord(path, message, frame.data.shape,
                                      dict(frame.meta)))
        for rec in self._redo:
            self._remove(rec)
        self._redo.clear()
        while len(self._undo) > MAX_HISTORY:
            self._remove(self._undo.pop(0))

    def undo(self, current: Frame) -> Optional[Frame]:
        if not self._undo:
            return None
        rec = self._undo.pop()
        redo_path = os.path.join(self.swap_dir,
                                 f"siriltpu_undo_{uuid.uuid4().hex}.npy")
        np.save(redo_path, current.data)
        self._redo.append(_UndoRecord(redo_path, rec.message,
                                      current.data.shape, dict(current.meta)))
        data = np.load(rec.path)
        self._remove(rec)
        return Frame(data, rec.meta)

    def redo(self, current: Frame) -> Optional[Frame]:
        if not self._redo:
            return None
        rec = self._redo.pop()
        self.save_state(current, "redo")
        data = np.load(rec.path)
        self._remove(rec)
        return Frame(data, rec.meta)

    def flush(self) -> None:
        """undo_flush: delete all swapfiles (main.c:423)."""
        for rec in self._undo + self._redo:
            self._remove(rec)
        self._undo.clear()
        self._redo.clear()

    @staticmethod
    def _remove(rec: _UndoRecord) -> None:
        try:
            os.unlink(rec.path)
        except OSError:
            pass


__all__ = ["UndoHistory"]
