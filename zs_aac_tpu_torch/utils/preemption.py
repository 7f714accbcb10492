"""Preemption-safe training: checkpoint on SIGTERM and resume.

The port's copy of the JAX package's ``utils/preemption.py``: a SIGTERM
handler flags the training loop; the loop checkpoints and exits cleanly, and
``--resume_ckpt`` (``train.pretrain``) picks the run back up.

Usage::

    guard = PreemptionGuard()
    for epoch in ...:
        for batch in ...:
            state, loss = step(state, batch, rng)
            if guard.should_stop:
                save_train_state(ckpt_path, state)
                guard.exit_gracefully()
"""

from __future__ import annotations

import signal
import sys
__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM,), verbose: bool = True):
        self.should_stop = False
        self._verbose = verbose
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):  # non-main thread / unsupported
                pass

    def _handler(self, signum, frame):
        self.should_stop = True
        if self._verbose:
            print(f"[preemption] caught signal {signum}; will checkpoint and "
                  "stop at the next step boundary", file=sys.stderr, flush=True)

    def exit_gracefully(self, code: int = 0):
        self.restore()
        sys.exit(code)

    def restore(self):
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
