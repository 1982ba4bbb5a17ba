"""Preemption-aware shutdown: route SIGTERM into a catchable exception
(the port's copy of ``seg2eye_tpu/utils/signals.py``).

A scheduler's eviction delivers SIGTERM, whose default action terminates
the process WITHOUT running ``finally`` blocks — a training loop's
crash-safe save (reference train.py:111-116 only covered in-process
exceptions) never fires.  ``sigterm_raises()`` installs a main-thread
handler that raises ``SystemExit(128 + SIGTERM)`` at the next bytecode
boundary, so the loop's KeyboardInterrupt/SystemExit path saves a
checkpoint before exit.
"""
from __future__ import annotations

import contextlib
import signal
import threading


def is_preemption(e: BaseException) -> bool:
    """True when ``e`` is the SystemExit raised by ``sigterm_raises``."""
    return isinstance(e, SystemExit) and e.code == 128 + signal.SIGTERM


@contextlib.contextmanager
def sigterm_raises():
    """Within the block, SIGTERM raises SystemExit(143) in the main thread.

    No-op (yields False) off the main thread — ``signal.signal`` is
    main-thread-only.  The previous handler is restored on exit.
    """
    if threading.current_thread() is not threading.main_thread():
        yield False
        return

    def _handler(signum, frame):
        raise SystemExit(128 + signum)

    prev = signal.signal(signal.SIGTERM, _handler)
    try:
        yield True
    finally:
        signal.signal(signal.SIGTERM, prev)
