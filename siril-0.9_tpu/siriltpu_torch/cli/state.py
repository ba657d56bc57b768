"""Interactive session state — the functional replacement for the
reference's globals (``com``, ``gfit``, src/core/siril.h:506-641).

Port of ``siriltpu.cli.state``, with one field more: ``device``, where the
verbs that reach the card run (``make_state(..., device=)``; no default).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

from siriltpu_torch.core.config import Settings, load_default
from siriltpu_torch.core.frame import Frame, Rect
from siriltpu_torch.core.undo import UndoHistory


@dataclass
class SirilState:
    device: object                         # torch device of the session
    settings: Settings = field(default_factory=load_default)
    cwd: str = "."
    image: Optional[Frame] = None          # gfit
    image_name: str = ""
    seq: Optional[object] = None           # com.seq
    selection: Optional[Rect] = None       # com.selection
    stars: List[object] = field(default_factory=list)  # com.stars
    mag_offset: float = 0.0                # com.magOffset
    undo: UndoHistory = field(default_factory=UndoHistory)
    log_lines: List[str] = field(default_factory=list)

    def log(self, msg: str) -> None:
        self.log_lines.append(msg)
        print(msg)

    def require_image(self) -> Frame:
        if self.image is None:
            raise CommandError("Load an image first.")
        return self.image

    def require_seq(self):
        if self.seq is None:
            raise CommandError("Load a sequence first.")
        return self.seq

    def set_image(self, frame: Frame, save_undo: bool = True,
                  message: str = "") -> None:
        if save_undo and self.image is not None:
            self.undo.save_state(self.image, message)
        self.image = frame

    def path(self, filename: str) -> str:
        if os.path.isabs(filename):
            return filename
        return os.path.join(self.cwd, filename)


class CommandError(Exception):
    pass


__all__ = ["SirilState", "CommandError"]
