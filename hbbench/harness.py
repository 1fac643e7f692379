"""One run of one cell: set-up, warm-up, the timed window, the check.

Everything is found by name: the cell in ``BENCHMARK.json``'s
``workloads``, its configuration in ``configs/<config>.json``, its traffic
mix in ``traffic/<mix>.json`` and each of its metrics in
``metrics/<metric>.py``.  The window drives ``LockstepCluster.submit`` and
``LockstepCluster.run_epoch``; no message delay is injected, so a latency
here is processor time only.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from hbbench import check, traffic
from hbbench.capture import Recorder
from hbbench.reference import threshold
from hbbench.trace import WINDOW_SPAN

HERE = Path(__file__).resolve().parent
MANIFEST = HERE.parent / "BENCHMARK.json"


def load_json(kind: str, name: str) -> dict:
    """``configs/<name>.json`` or ``traffic/<name>.json``."""
    with open(HERE / kind / f"{name}.json") as fh:
        return json.load(fh)


def load_metric(name: str):
    """The reader module ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("hbbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str, e2e_names: Sequence[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def resolve(name: str, manifest: Optional[dict] = None) -> Cell:
    manifest = manifest or load_manifest()
    work = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in manifest["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in manifest["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(work["chips"]), load_json("configs", work["config"]),
                load_json("traffic", work["traffic"]), e2e, per_layer)


@dataclasses.dataclass
class RunData:
    """What the metric readers read."""

    setup_s: float
    window_s: float
    epochs: List[dict]  # the window's epochs: stats, engine_s, device_s
    committed_in_window: int
    latencies_ms: Optional[List[float]] = None
    profile: Optional[dict] = None
    dual_pow_bound_ms: Optional[float] = None
    merkle_verify_bound_ms: Optional[float] = None
    wide_pow_bound_ms: Optional[float] = None
    wide_dual_pow_bound_ms: Optional[float] = None


@dataclasses.dataclass
class Outcome:
    run: RunData
    checks: Dict[str, int]
    attempted: int
    failed: int
    info: Dict[str, object]
    memory_peak_bytes: int


class _Client:
    """Submits the pool's transactions in order, transaction i to
    validator i mod N, and counts what it submitted before each epoch."""

    def __init__(self, cluster, pool: traffic.TxPool, ids: List[str]) -> None:
        self.cluster, self.pool, self.ids = cluster, pool, ids
        self.next = 0
        self.sub_before: List[int] = []

    def submit(self, count: int) -> None:
        n = len(self.ids)
        for i in range(self.next, self.next + count):
            self.cluster.submit(self.pool.tx(i), self.ids[i % n])
        self.next += count


def run(config: dict, mix: dict, seed: int, seconds: float, trace: bool, *,
        backend: str = "cuda", device: str = "cuda",
        faults: Sequence[Callable] = (), t_start: Optional[float] = None) -> Outcome:
    """Set up the configuration, warm up, measure ``seconds`` under the mix
    and hold what the timed path produced to the reference."""
    import torch

    from cleisthenes_tpu_torch.ops.modmath import GroupParams, get_engine
    from cleisthenes_tpu_torch.protocol.spmd import LockstepCluster

    t_start = time.perf_counter() if t_start is None else t_start
    on_card = device.startswith("cuda")
    if on_card:
        from cleisthenes_tpu_torch.csrc.build import load_all

        load_all()
        torch.cuda.reset_peak_memory_stats()
    n, f, b = int(config["n"]), int(config["f"]), int(config["batch_size"])
    ids = [f"node{i:03d}" for i in range(n)]
    # the dealer's seed is the deployment's (configs/<config>.json): every
    # run deals the same key set, so every run tosses the same coins and
    # decides in the same rounds; --seed makes the transactions and arrivals
    key_seed = int(config["key_seed"])
    grp = threshold.Group(p=int(config["group"]["p"], 16), g=int(config["group"]["g"]))
    group = GroupParams(p=grp.p, q=grp.q, g=grp.g)
    cluster = LockstepCluster(n=n, batch_size=b, crypto_backend=backend, device=device,
                              key_seed=key_seed, member_ids=ids, group=group)
    if cluster.config.f != f:
        raise ValueError(f"config f={f} but the port's Config gives f={cluster.config.f}")
    engine = get_engine(backend, group, device)
    wide_vb = wide_family(backend, group)
    pool = traffic.TxPool(seed, int(config["tx_bytes"]))
    rec = Recorder(seed, int(mix.get("rbc_check_epochs", 2)), trace, wide=wide_vb is not None)
    for fault in faults:
        fault(cluster)
    rec.install(cluster, engine)
    client = _Client(cluster, pool, ids)
    epochs: List[dict] = []  # the window's
    every: List[dict] = []  # warm-up, window and drain

    def one_epoch() -> dict:
        e = len(client.sub_before)
        client.sub_before.append(client.next)
        rec.begin_epoch(e)
        eng0 = (engine.stats["engine_s"], engine.stats["device_s"])
        with rec.span("epoch"):
            t0 = time.perf_counter()
            stats = cluster.run_epoch()
            t1 = time.perf_counter()
        rec_ = {"stats": dict(stats), "start": t0, "end": t1, "epoch": e,
                "engine_s": engine.stats["engine_s"] - eng0[0],
                "device_s": engine.stats["device_s"] - eng0[1]}
        every.append(rec_)
        return rec_

    if mix["loop"] not in ("closed", "open") or mix.get("arrivals", "poisson") != "poisson":
        raise ValueError(f"mix {mix.get('name')!r}: the generator runs closed loops and "
                         "open loops of Poisson arrivals")
    closed = mix["loop"] == "closed"
    queued = int(mix.get("queued_batches", 2)) * cluster.b
    warm = int(mix.get("warmup_epochs", 2))
    # warm-up: whole epochs of the cell's own shapes
    for _ in range(warm):
        if closed:
            client.submit(max(0, queued - cluster.pending_tx_count()))
        else:
            client.submit(int(mix["warmup_txs_per_epoch"]))
        one_epoch()
    if not closed:
        while cluster.pending_tx_count():
            one_epoch()
        due = traffic.poisson_due(seed, float(mix["rate_tx_per_s"]), seconds)
    if closed:
        client.submit(max(0, queued - cluster.pending_tx_count()))
    if on_card:
        torch.cuda.synchronize()
    # every window starts from the same collector state
    gc.collect()

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
        span = record_function(WINDOW_SPAN)
        span.__enter__()
    launches0 = _launches()
    host0 = _host_clocks()
    gc_clock = _GcClock()
    rec.sampling = rec.window = True
    lags: List[float] = []
    due_index: Dict[int, float] = {}
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    if closed:
        while True:
            epochs.append(one_epoch())
            if epochs[-1]["end"] - t_window >= seconds:
                break
            with rec.span("client.submit"):
                client.submit(max(0, queued - cluster.pending_tx_count()))
        t_end = epochs[-1]["end"]
    else:
        j = 0
        while True:
            now = time.perf_counter() - t_window
            if now >= seconds:
                break
            with rec.span("client.submit"):
                while j < len(due) and due[j] <= now:
                    due_index[client.next] = float(due[j])
                    lags.append(now - float(due[j]))
                    client.submit(1)
                    j += 1
            if cluster.pending_tx_count() == 0:
                with rec.span("client.wait"):
                    nxt = float(due[j]) if j < len(due) else seconds
                    time.sleep(max(0.0, min(nxt, seconds) - (time.perf_counter() - t_window)))
                continue
            epochs.append(one_epoch())
        t_end = time.perf_counter()
    rec.window = False
    gc_clock.stop()
    host1 = _host_clocks()
    launches = {k: v - launches0.get(k, 0) for k, v in _launches().items() if v - launches0.get(k, 0)}
    if trace:
        span.__exit__(None, None, None)
        if on_card:
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
    window_s = t_end - t_window

    # the drain: what an open loop made due in the window, to its commit
    latencies = None
    if not closed:
        now = time.perf_counter() - t_window
        for t in due[j:]:
            due_index[client.next] = float(t)
            lags.append(now - float(t))
            client.submit(1)
        for _ in range(int(mix.get("drain_max_epochs", 30))):
            if not cluster.pending_tx_count():
                break
            one_epoch()
        drain_end = time.perf_counter()
    rec.sampling = False
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0

    committed = [batch.tx_list() for batch in cluster.committed_batches]
    in_window = sum(len(committed[ep["epoch"]]) for ep in epochs if ep["epoch"] < len(committed))
    if not closed:
        latencies = []
        seen = set()
        for e in range(warm, len(committed)):
            end = every[e]["end"] - t_window
            for tx in committed[e]:
                i = traffic.index_of(tx)
                if i in due_index and i not in seen:
                    seen.add(i)
                    latencies.append((end - due_index[i]) * 1e3)
        latencies += [(drain_end - t_window - d) * 1e3 for i, d in due_index.items() if i not in seen]
    port_keys = {}
    for kind in ("tpke", "coin"):
        k0 = cluster.keys[ids[0]]
        pub = getattr(k0, kind + "_pub")
        port_keys[kind] = (pub.master, tuple(pub.verification_keys),
                           {nid: getattr(cluster.keys[nid], kind + "_share").value for nid in ids})
    ev = check.Evidence(
        group=grp, key_seed=key_seed, ids=ids, n=n, f=f, batch_size=b, pool=pool,
        sub_before=client.sub_before,
        due=None if closed else list(due_index), committed=committed,
        port_keys=port_keys,
        bba_rounds=[int(ep["stats"]["bba_rounds"]) for ep in every],
        rbc=rec.rbc, tosses=rec.tosses, plain=rec.plain, cts=rec.cts,
    )
    info: Dict[str, object] = {
        "epochs_in_window": len(epochs),
        "bba_rounds": [int(ep["stats"]["bba_rounds"]) for ep in epochs],
        "rbc_checked_epochs": sorted(rec.rbc),
        "launches_in_window": launches,
        "gc_in_window": gc_clock.summary(),
        "host_in_window": {k: host1[k] - host0[k] for k in host0},
        "epoch_ms": [(ep["end"] - ep["start"]) * 1e3 for ep in epochs],
        "host_libraries": _host_libraries(),
        "phase_ms": {k: sum(float(ep["stats"][k]) for ep in epochs) / max(1, len(epochs)) * 1e3
                     for k in ("propose_s", "rbc_encode_s", "rbc_verify_s", "rbc_decode_s",
                               "bba_s", "decrypt_s", "commit_s")},
        "engine_ms": {k: sum(ep[k] for ep in epochs) / max(1, len(epochs)) * 1e3
                      for k in ("engine_s", "device_s")},
    }
    if lags:
        info["generator_late_ms"] = {"p50": float(np.percentile(lags, 50)) * 1e3,
                                     "max": float(max(lags)) * 1e3}
    calls = {"dual": rec.dual_rows, "verify": rec.verify_shapes, "pows": rec.wide_pow_calls()}
    split = None
    if prof is not None:
        from hbbench.trace import read_profile

        split = read_profile(prof)
        del prof
    # the program's state goes before the reference runs
    Recorder.uninstall(engine)
    del cluster, rec
    t_check = time.perf_counter()
    checks, due_count = check.compare(ev)
    info["check_s"] = time.perf_counter() - t_check
    failed = checks["ledger_wrong"] + checks["ledger_missing"]
    data = RunData(setup_s=setup_s, window_s=window_s, epochs=epochs,
                   committed_in_window=in_window, latencies_ms=latencies, profile=split)
    if split is not None:
        t_bound = time.perf_counter()
        for key, ms in window_bounds(wide_vb, **calls).items():
            setattr(data, key, ms)
        info["bound_s"] = time.perf_counter() - t_bound
    return Outcome(run=data, checks=checks, attempted=due_count, failed=failed, info=info,
                   memory_peak_bytes=memory_peak)


def wide_family(backend: str, group) -> Optional[int]:
    """The row bytes of the wide family (K12) whose kernels a ``backend``
    engine runs for ``group``, or None where the 256-bit kernels (K7-K9)
    or the host serve it."""
    from cleisthenes_tpu_torch.ops.modexp_cuda import WIDE_WORDS
    from cleisthenes_tpu_torch.ops.modmath import layout_for_group

    vb = layout_for_group(group) if backend == "cuda" else None
    return vb if vb in WIDE_WORDS else None


def window_bounds(wide_vb: Optional[int], dual: Sequence[tuple], verify: Sequence[tuple],
                  pows: Sequence[tuple] = ()) -> Dict[str, float]:
    """The frozen bounds of the window's recorded calls, in ms, by
    ``RunData`` field: K6's of each verify shape; of each dual pow call K8's
    on a 256-bit engine (``wide_vb`` None), else K12's of the ``wide_vb``-
    byte family, with K12's of each pow call.  A kind of call the window
    did not make has no bound."""
    from hbbench import yardstick

    out = {}
    if verify:
        out["merkle_verify_bound_ms"] = sum(yardstick.merkle_verify_bound(*s)[0] for s in verify)
    if wide_vb is None:
        if dual:
            out["dual_pow_bound_ms"] = sum(yardstick.dual_pow_bound(*rows)[0] for rows in dual)
        return out
    if dual:
        out["wide_dual_pow_bound_ms"] = sum(yardstick.wide_dual_pow_bound(*rows, wide_vb)[0] for rows in dual)
    if pows:
        out["wide_pow_bound_ms"] = sum(yardstick.wide_pow_bound(*rows, wide_vb)[0] for rows in pows)
    return out


def _launches() -> Dict[str, int]:
    """Kernel launches so far, by kernel (``csrc/build.py`` ``COUNTS``)."""
    from cleisthenes_tpu_torch.csrc.build import COUNTS

    return dict(COUNTS.kernels)


class _GcClock:
    """Collections by generation, and their seconds, while it runs."""

    def __init__(self) -> None:
        self.count = [0, 0, 0]
        self.seconds = [0.0, 0.0, 0.0]
        self._t0 = None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            g = info["generation"]
            self.count[g] += 1
            self.seconds[g] += time.perf_counter() - self._t0

    def stop(self) -> None:
        if self._cb in gc.callbacks:
            gc.callbacks.remove(self._cb)

    def summary(self) -> dict:
        return {"collections": self.count, "seconds": self.seconds}


def _host_libraries() -> Dict[str, object]:
    """Which of the program's native host libraries loaded (a failed one
    falls back to pure Python), the CPUs this process may use, and
    PyTorch's host threads."""
    import os

    import torch
    from cleisthenes_tpu_torch.native import build

    libs = {name: (lib is not None) or build.load_error(name) for name, lib in build._LIBS.items()}
    return {"native": libs, "cpus": len(os.sched_getaffinity(0)),
            "torch_threads": torch.get_num_threads()}


def _host_clocks() -> Dict[str, float]:
    """This process's user and system CPU seconds, and the wall clock."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"user_s": ru.ru_utime, "sys_s": ru.ru_stime, "wall_s": time.perf_counter()}
