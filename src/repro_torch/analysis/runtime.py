"""Runtime lock sanitizer for the serving engine (``repro.analysis.runtime``
without the JAX guards; the debug-NaN and transfer-guard analogues are
still open).

A no-op unless enabled (``EngineConfig(sanitize=True)``), so production
paths pay one global-bool check per assertion site.
"""
from __future__ import annotations

_LOCK_SANITIZER = False


def enable_lock_sanitizer(enabled: bool = True) -> None:
    global _LOCK_SANITIZER
    _LOCK_SANITIZER = enabled


def lock_sanitizer_enabled() -> bool:
    return _LOCK_SANITIZER


class LockNotHeldError(AssertionError):
    pass


def assert_lock_held(lock) -> None:
    """Raise LockNotHeldError if ``lock`` is not currently held.

    For Condition / RLock (anything exposing ``_is_owned``) the check is
    exact and per-thread.  For a plain Lock a non-blocking acquire that
    succeeds means the caller reached a guarded section with the lock
    free.  No-op when the sanitizer is disabled."""
    if not _LOCK_SANITIZER:
        return
    is_owned = getattr(lock, "_is_owned", None)
    if is_owned is not None:
        if not is_owned():
            raise LockNotHeldError(
                "guarded section entered without holding its lock")
        return
    if lock.acquire(blocking=False):
        lock.release()
        raise LockNotHeldError(
            "guarded section entered without holding its lock")
