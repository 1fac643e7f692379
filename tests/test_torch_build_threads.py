"""Thread safety of the port's kernel loader and launch counters.

A deployment runs one validator a thread (``transport/host.py``), and
every validator's hub launches kernels, so the first launches of many
threads reach ``csrc.build.load`` together and every launch adds to one
``COUNTS``.  These tests hold the loader to one build and the counters
to exact totals under contention, with stubs in place of ``nvcc`` and
``ctypes`` (no card or compiler is needed)."""

from __future__ import annotations

import sys
import threading
import time

from cleisthenes_tpu_torch.csrc import build
from cleisthenes_tpu_torch.native import build as native_build

THREADS = 8


class _FakeFn:
    argtypes = None
    restype = None


class _FakeLib:
    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        fn = _FakeFn()
        setattr(self, name, fn)
        return fn


def _run_threads(target, n=THREADS, timeout=60.0):
    """Start ``n`` threads on ``target`` behind one barrier, with a short
    switch interval so that they interleave; join and check each ended."""
    barrier = threading.Barrier(n)
    errors = []

    def run(i):
        try:
            barrier.wait(timeout)
            target(i)
        except Exception as exc:  # reported below, with the thread's index
            errors.append((i, exc))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


def test_load_from_many_threads_builds_once(monkeypatch, tmp_path):
    builds = []

    def counting_build_all():
        builds.append(threading.get_ident())
        time.sleep(0.05)  # widen the window a second builder would use
        return {stem: tmp_path / f"lib{stem}.so" for stem in build.SIGNATURES}

    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "build_all", counting_build_all)
    monkeypatch.setattr(build.ctypes, "CDLL", _FakeLib)
    got = {}
    stems = sorted(build.SIGNATURES)

    def first_launch(i):
        got[i] = build.load(stems[i % len(stems)])

    _run_threads(first_launch)
    assert len(builds) == 1
    assert set(build._LIBS) == set(stems)
    for i, lib in got.items():
        assert lib is build._LIBS[stems[i % len(stems)]]
    # every entry point got its signature
    for stem, fns in build.SIGNATURES.items():
        for fn, argtypes in fns.items():
            assert getattr(build._LIBS[stem], fn).argtypes == argtypes


def test_build_tmp_names_differ_between_threads(tmp_path):
    out = tmp_path / "libgf256-0123456789abcdef.so"
    names = {}

    def name(i):
        names[i] = build.tmp_path(out)

    _run_threads(name, n=2)
    assert names[0] != names[1]
    assert all(p.parent == out.parent for p in names.values())
    assert all(p.name.startswith(out.stem + ".tmp") for p in names.values())


def test_launch_counts_exact_under_contention():
    counts = build.LaunchCounts()
    per_thread = 10_000

    def add(i):
        for _ in range(per_thread):
            counts.add("dual_pow_fused", ("dual_pow",))
            counts.add("comb_apply", ("pow_grouped", f"path{i % 2}"))

    _run_threads(add)
    total = THREADS * per_thread
    assert counts.kernels["dual_pow_fused"] == total
    assert counts.kernels["comb_apply"] == total
    assert counts.sites["dual_pow"] == total
    assert counts.sites["pow_grouped"] == total
    assert counts.sites["path0"] == counts.sites["path1"] == total // 2
    counts.reset()
    assert not counts.kernels and not counts.sites


def test_native_load_from_many_threads_compiles_once(monkeypatch, tmp_path):
    compiles = []

    def counting_compile(src, out):
        compiles.append(src.name)
        time.sleep(0.05)
        out.write_bytes(b"")

    monkeypatch.setattr(native_build, "_LIBS", {})
    monkeypatch.setattr(
        native_build, "_cache_path", lambda src: tmp_path / f"{src.stem}.so"
    )
    monkeypatch.setattr(native_build, "_compile", counting_compile)
    monkeypatch.setattr(native_build.ctypes, "CDLL", _FakeLib)
    configured = []

    def configure(lib):
        configured.append(lib)

    _run_threads(lambda i: native_build._load("modpow256", configure))
    assert compiles == ["modpow256.cpp"]
    assert len(configured) == 1
    assert native_build._LIBS["modpow256"] is configured[0]
