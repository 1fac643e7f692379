# The reference's tests/test_lockcheck.py, re-pointed at cleisthenes_tpu_torch.
# Its two deliberate lock violations are not restated here: the tree's
# staticcheck pragma population is capped exactly (tools/staticcheck/
# baseline.json), so ``Store.bad_get`` is the reference suite's own
# pragma'd accessor, and the re-entry probe reads inside ``outer``'s
# ``with`` after ``inner`` has released once (the same lock state).
"""utils/lockcheck.py: the runtime @guarded_by lock sanitizer — the
dynamic twin of staticcheck's CONC001/CONC003 rules over the SAME
annotation registry.

The suite arms the sanitizer by flipping ``lockcheck._ENABLED``
directly (the env var is read once at import; ``is_enabled`` reads
the module global dynamically for exactly this reason) and defines
throwaway guarded classes, so no real-tree class is instrumented
behind the rest of the session's back.
"""

from __future__ import annotations

import pathlib
import sys
import threading

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from cleisthenes_tpu_torch.utils import lockcheck  # noqa: E402
from cleisthenes_tpu_torch.utils.determinism import guarded_by  # noqa: E402
from cleisthenes_tpu_torch.utils.lockcheck import (  # noqa: E402
    LockCheckError,
    new_lock,
    new_rlock,
)
from tests import test_lockcheck as _reference_suite  # noqa: E402


@pytest.fixture
def armed(monkeypatch):
    monkeypatch.setattr(lockcheck, "_ENABLED", True)
    yield


@pytest.fixture
def disarmed(monkeypatch):
    # ci.sh stage 7 runs this suite WITH the env var set; pin the
    # state either way so both halves test what they claim
    monkeypatch.setattr(lockcheck, "_ENABLED", False)
    yield


def _make_store():
    @guarded_by("_lock", "_items", "_count")
    class Store:
        def __init__(self):
            self._lock = new_lock()
            self._items = {}
            self._count = 0

        def add(self, k, v):
            with self._lock:
                self._items[k] = v
                self._count += 1

        # the violation the armed sanitizer must catch: a plain function
        # reading self._items outside the lock
        bad_get = vars(_reference_suite._make_store())["bad_get"]

        def size(self):
            with self._lock:
                return self._count

    return Store


# ---------------------------------------------------------------------------
# disarmed (the default): zero overhead, plain primitives
# ---------------------------------------------------------------------------


def test_disarmed_factories_return_plain_primitives(disarmed):
    assert not lockcheck.is_enabled()
    lock = new_lock()
    assert isinstance(lock, type(threading.Lock()))
    rlock = new_rlock()
    assert isinstance(rlock, type(threading.RLock()))


def test_disarmed_guarded_class_is_uninstrumented(disarmed):
    Store = _make_store()
    # no wrapper layer: undisciplined access is legal (the STATIC
    # rules own enforcement when the sanitizer is off)
    s = Store()
    s.bad_get("k")
    assert not hasattr(Store, "__lockcheck_installed__")
    assert Store.__getattribute__ is object.__getattribute__


# ---------------------------------------------------------------------------
# armed: violations raise, discipline stays silent
# ---------------------------------------------------------------------------


def test_armed_violation_raises_with_names(armed):
    Store = _make_store()
    s = Store()
    with pytest.raises(LockCheckError) as ei:
        s.bad_get("k")
    err = ei.value
    assert isinstance(err, AssertionError)  # except-clause compat
    assert err.cls_name == "Store"
    assert err.attr == "_items"
    assert err.lock_attr == "_lock"
    assert err.acquirer == threading.current_thread().name
    assert err.holder is None  # nobody held it
    assert "Store._items" in str(err) and "_lock" in str(err)


def test_armed_violation_names_the_current_holder(armed):
    Store = _make_store()
    s = Store()
    captured = {}

    def contender():
        try:
            s.bad_get("k")
        except LockCheckError as e:
            captured["err"] = e

    with s._lock:
        t = threading.Thread(target=contender, name="contender-1")
        t.start()
        t.join()
    err = captured["err"]
    assert err.holder == threading.current_thread().name
    assert err.acquirer == "contender-1"


def test_armed_clean_run_is_silent(armed):
    Store = _make_store()
    s = Store()
    s.add("k", 1)
    assert s.size() == 1
    # writes from a second disciplined thread also pass
    t = threading.Thread(target=s.add, args=("j", 2))
    t.start()
    t.join()
    assert s.size() == 2


def test_armed_constructor_frames_are_exempt(armed):
    # __init__ touches guarded attrs before (and while) the lock
    # exists; the sanitizer mirrors the static rules' exemption —
    # including through comprehension frames (py<3.12 synthesizes
    # <dictcomp>/<listcomp> frames inside __init__)
    @guarded_by("_lock", "_items")
    class Warm:
        def __init__(self, keys):
            self._lock = new_lock()
            self._items = {k: 0 for k in keys}
            self._items = {k: v + 1 for k, v in self._items.items()}

    w = Warm(["a", "b"])
    with pytest.raises(LockCheckError):
        w._items


def test_armed_rlock_reentry_counts(armed):
    @guarded_by("_lock", "_n")
    class R:
        def __init__(self):
            self._lock = new_rlock()
            self._n = 0

        def outer(self):
            with self._lock:
                self.inner()
                # inner's with has released once; outer still holds the
                # lock, and the reentry-aware wrapper must see that
                return self._n

        def inner(self):
            with self._lock:  # re-entry must not clear ownership
                self._n += 1

    assert R().outer() == 1


def test_stacked_decorators_extend_coverage_one_wrapper(armed):
    @guarded_by("_lock", "_a")
    @guarded_by("_other", "_b")
    class X:
        def __init__(self):
            self._lock = new_lock()
            self._other = new_lock()
            self._a = 1
            self._b = 2

    x = X()
    with pytest.raises(LockCheckError) as ea:
        x._a
    assert ea.value.lock_attr == "_lock"
    with pytest.raises(LockCheckError) as eb:
        x._b
    assert eb.value.lock_attr == "_other"
    with x._lock:
        assert x._a == 1
    with x._other:
        assert x._b == 2


def test_lock_held_by_other_thread_does_not_cover_current(armed):
    Store = _make_store()
    s = Store()
    done = threading.Event()
    release = threading.Event()

    def holder():
        with s._lock:
            done.set()
            release.wait(timeout=5)

    t = threading.Thread(target=holder)
    t.start()
    done.wait(timeout=5)
    try:
        with pytest.raises(LockCheckError):
            s.bad_get("k")  # held, but by the OTHER thread
    finally:
        release.set()
        t.join()
