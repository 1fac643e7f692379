"""Opt-in runtime lock sanitizer: the dynamic twin of staticcheck's
CONC001/CONC003 rules, over the SAME ``@guarded_by`` registry.

``CLEISTHENES_LOCKCHECK=1`` in the environment arms it; otherwise
every entry point here compiles down to the plain ``threading``
primitives — zero per-access overhead on hot paths, which is why
``guarded_by`` is a declaration and not an always-on wrapper.

Armed, two things change:

- ``new_lock()`` / ``new_rlock()`` (the factories every guarded class
  uses for its lock attributes) return ``_CheckedLock`` wrappers that
  record the owning thread and reentrancy count.
- ``guarded_by`` (utils/determinism.py) installs ``__getattribute__``
  / ``__setattr__`` instrumentation on the decorated class: every
  access to a declared attribute asserts the declared lock is held by
  the CURRENT thread, raising ``LockCheckError`` naming the class,
  attribute, lock, acquiring thread and current holder.  Accesses
  from ``__init__``/``__del__`` frames are exempt (single-threaded
  construction/teardown, mirroring the static rules' exemption).

The sanitizer is a TSan analog for the annotation registry: a
``@guarded_by`` contract is either statically proven (CONC001 inside
the class, CONC003 across call boundaries) or dynamically watched
here — never merely commented.  ci.sh runs the lock-sensitive tier-1
subset and a fuzz band under the sanitizer.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Optional

_ENABLED = os.environ.get("CLEISTHENES_LOCKCHECK") == "1"


def is_enabled() -> bool:
    """True when the sanitizer is armed.  Read DYNAMICALLY at every
    decoration/factory call (not baked at import) so tests can flip
    ``lockcheck._ENABLED`` and define instrumented classes."""
    return _ENABLED


class LockCheckError(AssertionError):
    """A ``@guarded_by`` attribute was touched without its lock.

    Subclasses AssertionError so existing except-clauses treating
    sanitizer trips as assertion failures do the right thing.
    """

    def __init__(
        self,
        cls_name: str,
        attr: str,
        lock_attr: str,
        acquirer: str,
        holder: Optional[str],
    ) -> None:
        self.cls_name = cls_name
        self.attr = attr
        self.lock_attr = lock_attr
        self.acquirer = acquirer
        self.holder = holder
        super().__init__(
            f"{cls_name}.{attr} accessed by thread {acquirer!r} "
            f"without holding {lock_attr} "
            f"(held by {holder!r})"
            if holder
            else f"{cls_name}.{attr} accessed by thread {acquirer!r} "
            f"without holding {lock_attr} (unheld)"
        )


class _CheckedLock:
    """Lock/RLock wrapper recording the owning thread.

    Context-manager and acquire/release compatible with the stdlib
    primitives (including use under ``threading.Condition``).  The
    reentrancy count makes one wrapper type serve both: a plain Lock
    simply never re-enters.
    """

    __slots__ = ("_inner", "_owner", "_count")

    def __init__(self, inner) -> None:
        self._inner = inner
        self._owner: Optional[threading.Thread] = None
        self._count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._owner = threading.current_thread()
            self._count += 1
        return ok

    def release(self) -> None:
        self._count -= 1
        if self._count <= 0:
            self._owner = None
            self._count = 0
        self._inner.release()

    def __enter__(self) -> "_CheckedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def held_by_current(self) -> bool:
        return self._owner is threading.current_thread()

    @property
    def holder_name(self) -> Optional[str]:
        owner = self._owner
        return owner.name if owner is not None else None


def new_lock():
    """A mutex for a ``@guarded_by`` lock attribute: plain
    ``threading.Lock`` unless the sanitizer is armed."""
    if is_enabled():
        return _CheckedLock(threading.Lock())
    return threading.Lock()


def new_rlock():
    """Reentrant variant of ``new_lock``."""
    if is_enabled():
        return _CheckedLock(threading.RLock())
    return threading.RLock()


_EXEMPT_FRAMES = frozenset(("__init__", "__del__"))


def _assert_held(obj: object, attr: str, lock_attr: str) -> None:
    # frame 0 = here, 1 = the __getattribute__/__setattr__ wrapper,
    # 2 = the code performing the attribute access; synthetic frames
    # (<listcomp>/<genexpr>/<lambda>, pre-3.12) defer to their definer
    try:
        frame = sys._getframe(2)
        for _ in range(4):
            if frame is None or not frame.f_code.co_name.startswith(
                "<"
            ):
                break
            frame = frame.f_back
        co_name = frame.f_code.co_name if frame is not None else ""
    except ValueError:  # shallower stack than expected
        co_name = ""
    if co_name in _EXEMPT_FRAMES:
        return
    try:
        lock = object.__getattribute__(obj, lock_attr)
    except AttributeError:
        return  # mid-construction: the lock attr does not exist yet
    if not isinstance(lock, _CheckedLock):
        return  # lock predates arming (or a test stubbed it)
    if not lock.held_by_current():
        raise LockCheckError(
            type(obj).__name__,
            attr,
            lock_attr,
            threading.current_thread().name,
            lock.holder_name,
        )


def install(cls):
    """Install guarded-attribute instrumentation on ``cls`` (called by
    ``guarded_by`` when the sanitizer is armed).

    The wrappers read ``type(self).__guarded_by__`` live, so stacked
    decorators and subclass re-decoration extend coverage without
    re-installation; the marker flag keeps one wrapper layer per
    hierarchy."""
    if cls.__dict__.get("__lockcheck_installed__") or getattr(
        cls, "__lockcheck_installed__", False
    ):
        return cls
    orig_get = cls.__getattribute__
    orig_set = cls.__setattr__

    def __getattribute__(self, name):
        guarded = type(self).__guarded_by__
        if name in guarded:
            _assert_held(self, name, guarded[name])
        return orig_get(self, name)

    def __setattr__(self, name, value):
        guarded = type(self).__guarded_by__
        if name in guarded:
            _assert_held(self, name, guarded[name])
        orig_set(self, name, value)

    cls.__getattribute__ = __getattribute__
    cls.__setattr__ = __setattr__
    cls.__lockcheck_installed__ = True
    return cls


__all__ = [
    "LockCheckError",
    "install",
    "is_enabled",
    "new_lock",
    "new_rlock",
]
