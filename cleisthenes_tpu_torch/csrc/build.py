"""Build, load and count the port's CUDA kernels.

Every ``csrc/*.cu`` compiles with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`` into
``cleisthenes_tpu_torch/_build/`` (git-ignored), one shared library per
source keyed by the hash of the source and of the headers the sources
share (``csrc/mont_team.cuh``), and loads with ``ctypes``: a plain C
interface, no PyTorch headers, so a build takes seconds.  The first
``load()`` in a process builds every missing library at once, one
``nvcc`` per source started together, so ``python3 chip_smoke.py``
alone builds everything.  A failed build, a missing ``nvcc`` or a
failed launch raises.

Each C entry point launches on the caller's stream and returns
``cudaGetLastError()``; ``launch()`` makes one call on a tensor's card
and current stream, turns a nonzero code into an exception and counts
it.  ``COUNTS`` tallies every launch by kernel (``gf256_apply``,
``gf65536_apply``, ``sha256_rows``, ``merkle_forest``, ``merkle_verify``,
``mont_mul``,
``pow_fused``, ``dual_pow_fused``, ``comb_table``, ``comb_apply``,
``wide_pow_fused``, ``wide_dual_pow_fused``) and under each entry
point it was made through — one per TPU kernel it replaces:
``rs_encode`` (K1), ``rs_decode`` (K2), ``decode_recheck`` (K3),
``sha256_rows`` (K4), ``merkle_forest`` (K5), ``merkle_verify`` (K6),
``pow`` (K7), ``dual_pow`` (K8), ``pow_grouped`` (K9, two launches a
call: table build and accumulation), ``mont_mul`` (K10),
``rs16_encode`` and ``rs16_decode`` (K11), ``wide_pow`` and
``wide_dual_pow`` (K12).  A launch
inside the fused K3 counts under K3 and under the entry point it shares
(the re-encode under ``rs_encode`` too, the forest under
``merkle_forest``).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

_CSRC = Path(__file__).parent
BUILD_DIR = _CSRC.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
# argtypes of every C entry point, by source: pointers and the stream
# as c_void_p (a bare int would be cut to 32 bits)
SIGNATURES: Dict[str, Dict[str, list]] = {
    "gf256": {
        "gf256_apply": [_P, _LL, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "gf65536": {
        "gf65536_apply": [_P, _LL, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "sha256": {
        "sha256_rows": [_P, _LL, _LL, _I, _P, _P],
        "merkle_forest": [_P, _LL, _LL, _LL, _P, _P, _P],
        "merkle_verify": [_P, _P, _LL, _P, _I, _P, _P, _LL, _P],
    },
    "modexp": {
        "mont_mul": [_P, _P, _P, _LL, _P, _P],
        "pow_fused": [_P, _P, _P, _P, _LL, _P, _P],
        "dual_pow_fused": [_P, _P, _P, _P, _P, _LL, _P, _P],
        "comb_table": [_P, _P, _LL, _P, _P],
        "comb_apply": [_P, _P, _P, _P, _LL, _P, _P],
    },
    "modexp_wide": {
        "wide_pow_fused": [_P, _P, _P, _LL, _I, _P, _P],
        "wide_dual_pow_fused": [_P, _P, _P, _P, _P, _LL, _I, _P, _P],
    },
}


class LaunchCounts:
    """Plain launch counters: one add per kernel launch, by kernel and
    by every entry point (site) the launch was made through."""

    def __init__(self) -> None:
        self.kernels: collections.Counter = collections.Counter()
        self.sites: collections.Counter = collections.Counter()

    def add(self, kernel: str, sites: Tuple[str, ...]) -> None:
        self.kernels[kernel] += 1
        for site in sites:
            self.sites[site] += 1

    def reset(self) -> None:
        self.kernels.clear()
        self.sites.clear()


COUNTS = LaunchCounts()

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from csrc/*.cu at first use"
    )


def library_path(src: Path) -> Path:
    """The library of ``src``, keyed by its bytes, the shared headers'
    (``csrc/*.cuh``, which every source may include) and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every csrc/*.cu whose library is missing, all in
    parallel; return {source stem: library path}.  Raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(_CSRC.glob("*.cu"))
    paths = {src.stem: library_path(src) for src in sources}
    jobs = []
    for src in sources:
        out = paths[src.stem]
        if out.exists():
            continue
        # per-process tmp name, atomic rename: concurrent builders race
        # benignly
        tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
        )
        jobs.append((src, tmp, out, proc))
    failures = []
    for src, tmp, out, proc in jobs:
        try:
            log, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        if proc.returncode == 0:
            tmp.replace(out)
        else:
            failures.append(f"{src.name}:\n{log.decode(errors='replace')}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    paths = build_all()
    for stem, path in paths.items():
        if stem in _LIBS:
            continue
        cdll = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[stem].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        _LIBS[stem] = cdll
    return _LIBS[name]


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def launch(lib: str, fn: str, sites: Tuple[str, ...], ref, *args) -> None:
    """One launch: C entry point ``fn`` of ``csrc/<lib>.cu`` with ``args``
    and the raw handle of PyTorch's current stream on ``ref``'s card,
    that card made current for the call if it is not; raises on a
    nonzero code and counts the launch under ``fn`` and ``sites``.  The
    raw stream handle and the device index come from torch's C bindings
    (``torch.cuda.current_stream`` builds a Python stream object a call,
    and a device guard swaps devices twice), which keeps a small call's
    host time down."""
    import torch

    dev = ref.get_device()
    call = getattr(load(lib), fn)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if dev == torch.cuda.current_device():
        rc = call(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = call(*args, stream)
    check(rc, fn)
    COUNTS.add(fn, sites)


__all__ = [
    "BUILD_DIR",
    "COUNTS",
    "LaunchCounts",
    "build_all",
    "check",
    "launch",
    "load",
    "nvcc_path",
]
