"""Crash supervision of ``python -m cdrs_tpu_torch daemon --supervise``:
``cdrs_tpu/daemon/supervise.py``.

A killed daemon resumes bit-identically from its last checkpoint, so a
restart is safe; the supervisor makes it automatic.  It runs the daemon
command as a child, forwards SIGTERM/SIGINT for a graceful drain, and
restarts the child after an abnormal exit:

* the delay is ``backoff_base * 2**(failures - 1)``, capped at
  ``backoff_cap``;
* a child exiting 0 ends supervision;
* a child that ran ``healthy_after`` seconds before dying resets the
  failure count;
* after ``max_restarts`` consecutive failures the supervisor gives up
  and returns the child's last exit code.
"""

from __future__ import annotations

import signal
import subprocess
import sys
import time

__all__ = ["supervise"]


def supervise(child_argv: list[str], *, max_restarts: int = 5, backoff_base: float = 0.5,
              backoff_cap: float = 30.0, healthy_after: float = 30.0, log=None) -> int:
    """Run ``child_argv`` under restart supervision; returns the exit code
    to propagate.  ``log`` is a ``print``-like callable (stderr when None)."""
    if max_restarts < 1:
        raise ValueError(f"max_restarts must be >= 1, got {max_restarts}")
    if backoff_base <= 0 or backoff_cap < backoff_base:
        raise ValueError(f"need 0 < backoff_base <= backoff_cap, got "
                         f"{backoff_base}/{backoff_cap}")
    emit = log if log is not None else (lambda msg: print(msg, file=sys.stderr, flush=True))
    failures = 0
    attempt = 0
    stop = {"sig": None}

    def _forward(signum, frame):  # noqa: ARG001
        stop["sig"] = signum   # forwarded to the live child by the wait loop

    old_term = signal.signal(signal.SIGTERM, _forward)
    old_int = signal.signal(signal.SIGINT, _forward)
    try:
        while True:
            attempt += 1
            started = time.monotonic()
            emit(f"supervise: starting child (attempt {attempt}): " + " ".join(child_argv))
            child = subprocess.Popen(child_argv)
            while True:
                if stop["sig"] is not None and child.poll() is None:
                    child.send_signal(signal.SIGTERM)
                    stop["sig"] = "sent"
                try:
                    rc = child.wait(timeout=0.2)
                    break
                except subprocess.TimeoutExpired:
                    continue
            ran = time.monotonic() - started
            if rc == 0:
                emit(f"supervise: child exited cleanly after {ran:.1f}s")
                return 0
            if stop["sig"] == "sent":
                emit(f"supervise: child stopped on forwarded signal (exit {rc})")
                return 0
            if ran >= healthy_after:
                failures = 0
            failures += 1
            emit(f"supervise: child died (exit {rc}) after {ran:.1f}s "
                 f"— consecutive failure {failures}/{max_restarts}")
            if failures >= max_restarts:
                emit("supervise: giving up (crash loop); checkpoint is durable, "
                     "rerun to resume")
                return int(rc) if rc else 1
            delay = min(backoff_base * (2.0 ** (failures - 1)), backoff_cap)
            emit(f"supervise: restarting in {delay:.1f}s")
            deadline = time.monotonic() + delay
            while time.monotonic() < deadline:
                if stop["sig"] is not None:
                    emit("supervise: stop requested during backoff")
                    return 0
                time.sleep(0.05)
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
