"""On-demand compilation + ctypes loading of the native host kernels.

The port's copy of ``cleisthenes_tpu/native/build.py``, for its three
host kernels: batched SHA-256 rows (ops/hashrows), the 256-bit
Montgomery modexp engine (ops/modmath) and the GF(2^8) Reed-Solomon
matmul of the ``'cpp'`` erasure backend (ops/rs_cpp).
Each source compiles with g++ to a shared library under
``cleisthenes_tpu_torch/_build/native/`` cached by source hash
(rebuilds on change, races benignly via atomic rename); loading is
attempted once per process and failure degrades to the pure-python
paths (hashlib, ``pow``), never to an exception — these are host
kernels with exact host equivalents, unlike the CUDA kernels of
``csrc/``, which raise.  The GF(2^8) library has no such fallback:
``CppErasureCoder`` raises when ``load_gf256`` returns None, as the
reference's does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, Optional

_DIR = Path(__file__).parent
_BUILD_DIR = _DIR.parent / "_build" / "native"
_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}
_ERRORS: Dict[str, str] = {}


def _cache_path(src: Path) -> Path:
    """Library path keyed by source hash (rebuilds on source change)."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    name = f"_{src.stem}-{digest}.so"
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    except OSError:
        pass
    if os.access(_BUILD_DIR, os.W_OK):
        return _BUILD_DIR / name
    cache_dir = Path(tempfile.gettempdir()) / "cleisthenes_tpu_torch_native"
    cache_dir.mkdir(parents=True, exist_ok=True)
    return cache_dir / name


def _compile(src: Path, out: Path) -> None:
    # per-process tmp name: concurrent first-time builders must not
    # interleave writes before the atomic rename
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
        "-funroll-loops", "-pthread", str(src), "-o", str(tmp),
    ]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{res.stderr[-2000:]}")
    tmp.replace(out)  # atomic: concurrent builders race benignly


def _load(name: str, configure: Callable[[ctypes.CDLL], None]):
    """Compile-if-needed + load + configure + selftest, once per
    process; returns None forever after the first failure."""
    if name in _LIBS:
        return _LIBS[name]
    try:
        src = _DIR / f"{name}.cpp"
        path = _cache_path(src)
        if not path.exists():
            _compile(src, path)
        lib = ctypes.CDLL(str(path))
        configure(lib)
        _LIBS[name] = lib
    except Exception as exc:
        _LIBS[name] = None
        _ERRORS[name] = f"{type(exc).__name__}: {exc}"
    return _LIBS[name]


def load_error(name: str) -> Optional[str]:
    """Why library ``name`` (a source stem) failed to load, or None."""
    return _ERRORS.get(name)


def _configure_gf256(lib: ctypes.CDLL) -> None:
    lib.gf256_matmul.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.gf256_matmul_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.gf256_selftest.restype = ctypes.c_int
    rc = lib.gf256_selftest()
    if rc != 0:
        raise RuntimeError(f"gf256 selftest failed: {rc}")


def _configure_modpow(lib: ctypes.CDLL) -> None:
    lib.modpow256_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int,
    ]
    lib.dualpow256_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int,
    ]
    lib.modpow256_selftest.restype = ctypes.c_int
    rc = lib.modpow256_selftest()
    if rc != 0:
        raise RuntimeError(f"modpow256 selftest failed: {rc}")


def _configure_sha256(lib: ctypes.CDLL) -> None:
    lib.sha256_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.sha256_rows_fixed.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.sha256_selftest.restype = ctypes.c_int
    rc = lib.sha256_selftest()
    if rc != 0:
        raise RuntimeError(f"sha256rows selftest failed: {rc}")


def load_sha256() -> Optional[ctypes.CDLL]:
    """The batched SHA-256 library, or None (no toolchain)."""
    return _load("sha256rows", _configure_sha256)


def load_gf256() -> Optional[ctypes.CDLL]:
    """The GF(2^8) RS kernel library, or None (no toolchain)."""
    return _load("gf256", _configure_gf256)


def load_modpow() -> Optional[ctypes.CDLL]:
    """The 256-bit Montgomery modexp library, or None."""
    return _load("modpow256", _configure_modpow)


def native_available() -> bool:
    return load_gf256() is not None


__all__ = [
    "load_error",
    "load_gf256",
    "load_modpow",
    "load_sha256",
    "native_available",
]
