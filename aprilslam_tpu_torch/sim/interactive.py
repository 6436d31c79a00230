"""Interactive manual camera control from the terminal (a copy of
``aprilslam_tpu/sim/interactive.py``: numpy and the standard library only).

Capability parity with the reference's 12-key pygame camera
(camera_controller.py:52-103): six translation keys and six rotation keys
drive [x, y, z] position and [pitch, yaw, roll] rotation at a configurable
speed scaled by the scene's ``size_scale``. The reference reads pygame
KEYDOWN/KEYUP state; here (no SDL window on an accelerator host) keys arrive as
discrete terminal characters read non-blockingly in cbreak mode, and each
press applies one movement step.

Key map (reference bindings kept where they are letters; the reference's
arrow keys become i/j/k/l since terminals deliver arrows as escape
sequences):

    translation:  j/l  -> x-/x+       i/k -> y+/y-      w/s -> z-/z+
    rotation:     a/d  -> yaw -/+     q/e -> roll -/+   r/f -> pitch +/-
    other:        x    -> quit
"""

from __future__ import annotations

import os
import select
import sys

import numpy as np

# key -> (array, index, sign); mirrors camera_controller.py:79-103.
_TRANSLATION_KEYS = {
    "j": (0, -1.0), "l": (0, +1.0),   # x (reference LEFT/RIGHT)
    "i": (1, +1.0), "k": (1, -1.0),   # y (reference UP/DOWN)
    "w": (2, -1.0), "s": (2, +1.0),   # z (reference W/S)
}
_ROTATION_KEYS = {
    "a": (1, -1.0), "d": (1, +1.0),   # yaw
    "q": (2, -1.0), "e": (2, +1.0),   # roll
    "r": (0, +1.0), "f": (0, -1.0),   # pitch
}
QUIT_KEY = "x"

HELP = (
    "keys: j/l x  i/k y  w/s z   a/d yaw  q/e roll  r/f pitch   x quit"
)


class InteractiveCamera:
    """Terminal-driven camera state (reference CameraController parity)."""

    def __init__(
        self,
        movement_speed: float = 0.5,
        rotation_speed: float = 2.0,
        size_scale: float = 1.0,
        position=(0.0, 0.0, 0.0),
        rotation=(0.0, 0.0, 0.0),
    ):
        self.position = np.asarray(position, np.float32).copy()
        self.rotation = np.asarray(rotation, np.float32).copy()  # [pitch, yaw, roll] deg
        self.movement_speed = float(movement_speed) * float(size_scale)
        self.rotation_speed = float(rotation_speed)
        self.quit = False

    def apply_key(self, ch: str) -> None:
        ch = ch.lower()
        if ch == QUIT_KEY:
            self.quit = True
        elif ch in _TRANSLATION_KEYS:
            idx, sign = _TRANSLATION_KEYS[ch]
            self.position[idx] += sign * self.movement_speed
        elif ch in _ROTATION_KEYS:
            idx, sign = _ROTATION_KEYS[ch]
            self.rotation[idx] += sign * self.rotation_speed

    def apply_keys(self, keys: str) -> None:
        for ch in keys:
            self.apply_key(ch)


class TerminalKeys:
    """Non-blocking terminal key reader (cbreak mode), headless-safe.

    On a non-tty stdin (tests, pipes, CI) it degrades to reading whatever
    characters are available on stdin without changing terminal modes.
    """

    def __init__(self, stream=None):
        self._stream = stream if stream is not None else sys.stdin
        self._fd = None
        self._saved = None

    def __enter__(self):
        try:
            import termios
            import tty

            if self._stream.isatty():
                self._fd = self._stream.fileno()
                self._saved = termios.tcgetattr(self._fd)
                tty.setcbreak(self._fd)
        except Exception:
            self._fd = None
            self._saved = None
        return self

    def __exit__(self, *exc):
        if self._fd is not None and self._saved is not None:
            import termios

            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)

    def read_available(self, timeout: float = 0.0) -> str:
        """All characters currently pending on stdin (possibly empty)."""
        out = []
        try:
            fd = self._stream.fileno()
        except (OSError, ValueError, AttributeError):
            # In-memory streams (tests): read one chunk directly.
            data = self._stream.read()
            return data or ""
        while True:
            r, _, _ = select.select([fd], [], [], timeout)
            if not r:
                break
            ch = os.read(fd, 1).decode(errors="ignore")
            if not ch:
                break
            out.append(ch)
            timeout = 0.0
        return "".join(out)
