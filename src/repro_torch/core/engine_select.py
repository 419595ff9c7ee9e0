"""Per-forest engine autotuner — the paper's conclusion as an API; the
port's counterpart of ``repro.core.engine_select``.

The paper's central finding is that the fastest tree-traversal
implementation depends on both the forest shape and the target hardware.
``choose(forest, batch)`` operationalises that: it microbenchmarks every
candidate engine on the actual forest at the caller's (bucketed) batch
size, returns the winner, and caches the decision — in memory for the
process, and as JSON on disk so later processes (and the serving path,
``inference.server.ForestServer.from_forest``) skip the sweep entirely.

Candidates come from ``core.registry`` (one registration per engine — no
second table here); the autotuner's short names are the registry specs'
``tune_name``: the plain-torch engines ``qs``, ``qs-bitmm``,
``rapidscorer``, ``native``, ``unrolled``, ``gemm`` and the hand-written
CUDA kernels ``cuda-qs``, ``cuda-bitmm``, ``cuda-gemm``.  Beyond the
engine axis, the sweep can cover the other pipeline passes:
``quant_specs=`` adds fixed-point variants (paper §5) as
``<engine>@q<bits>`` candidates, ``opt_levels=`` adds optimizer
middle-end variants (``<engine>@O2`` — ``repro_torch.optim``),
``layout_specs=`` adds engine-kw layout variants, ``cascade_specs=``
adds confidence-gated staged or fused variants, and ``flint=True`` adds
FLInt variants of the torch engines.

Cache key: ``(torch backend, n_trees, n_leaves, n_classes, n_features,
max_depth, threshold dtype, batch bucket, n_devices, device
fingerprint)``.  Runtime is independent of the learned values, so device
+ shape/structure + dtype fully determine the ranking.  The leading
component and the fingerprint are ``torch-cuda`` / ``torch-cpu`` plus the
card's name and compute capability: a winner measured on the CPU is never
replayed on the card, nor one the reference measured (its keys start
with its JAX backend and hash another fingerprint), though both packages
may share one cache file.

Beyond measuring, ``choose(mode="predict")`` is the zero-shot ``-Os``
path: a learned cost model trained on the accumulated cache history
(``repro_torch.tune``) ranks the candidates without compiling any of
them; at high confidence only the predicted winner is built (and
quick-benched, feeding the measurement back into the cache as ground
truth), at low confidence the sweep narrows to the top-k predicted
candidates instead of the full product.

Every entry point takes ``device=``: ``None`` means the card and raises
without one.  The kernel engines join the default candidate set on the
card only; on ``device="cpu"`` an explicit ``engines=("cuda-qs", ...)``
runs the kernels' plain versions.  ``n_devices=`` tunes the
tree-sharded wrapper (``core.shard``) over the torch engines; the
device count is part of the cache key.
"""
from __future__ import annotations

import hashlib
import json
import os
import platform
import time
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from . import registry
from ..obs import metrics as _obs_metrics
from ..obs.log import get_logger
from .forest import Forest
from .quantize import QuantSpec, quantize_forest

_LOG = get_logger("autotune")


def _autotune_metrics():
    """The autotuner's metric families on the process default registry
    (the reference's names, docs/OBSERVABILITY.md §Autotune), or ``None``
    when observability is disabled.  Resolved per call — get-or-create
    is two dict lookups after the first time, and tests that swap the
    default registry (``set_default_registry``) observe their own."""
    reg = _obs_metrics.get_registry()
    if not reg.enabled:
        return None
    return {
        "sweeps": reg.counter(
            "repro_autotune_sweeps_total",
            "Autotune benchmark sweeps executed (decisions that had to "
            "time at least one candidate)"),
        "hits": reg.counter(
            "repro_autotune_cache_hits_total",
            "Autotune decisions answered entirely from cache",
            labels=("layer",)),
        "misses": reg.counter(
            "repro_autotune_cache_misses_total",
            "Autotune decisions that had to benchmark",
            labels=("reason",)),
        "sweep_s": reg.histogram(
            "repro_autotune_sweep_seconds",
            "Wall time of one autotune benchmark sweep, seconds"),
        "benched": reg.counter(
            "repro_autotune_candidates_benched_total",
            "Candidate predictors built and timed by autotune sweeps"),
        "winner": reg.gauge(
            "repro_autotune_winner_info",
            "Autotune winner per shape key (info gauge: value is "
            "always 1; the labels carry the decision)",
            labels=("key", "engine")),
        "predict_hits": reg.counter(
            "repro_autotune_predict_hits_total",
            "Zero-shot (-Os) decisions answered by the cost model at "
            "high confidence — one candidate compiled, no sweep"),
        "fallbacks": reg.counter(
            "repro_autotune_fallback_sweeps_total",
            "Predict-mode decisions that fell back to a (narrow) sweep",
            labels=("reason",)),
        "feedback": reg.counter(
            "repro_autotune_feedback_writes_total",
            "Ground-truth measurements written back into the cache by "
            "zero-shot predict decisions"),
        "predict_err": reg.histogram(
            "repro_autotune_predict_rel_error",
            "Relative |predicted − measured| / measured us-per-instance "
            "of zero-shot winners (the model's live quality)"),
        "predict_err_last": reg.gauge(
            "repro_autotune_predict_last_rel_error",
            "Most recent zero-shot prediction's relative error, per "
            "shape key", labels=("key",)),
    }


class _TuneTable(Mapping):
    """Live view of ``registry.tune_table()`` — autotuner name →
    (engine, backend).  A mapping object (not a snapshot dict) so engines
    registered after import (plugins, tests) appear automatically."""

    def __getitem__(self, name: str) -> tuple:
        return registry.tune_table()[name]

    def __iter__(self):
        return iter(registry.tune_table())

    def __len__(self):
        return len(registry.tune_table())


ENGINE_SPECS = _TuneTable()


def _make_factory(name: str) -> Callable:
    spec = registry.by_tune_name(name)

    def factory(forest: Forest, device=None):
        return registry.build(forest, spec.name, spec.backend,
                              device=registry.resolve_device(device))

    return factory


class _FactoryTable(Mapping):
    """tune name → predictor factory ``(forest, device=None)``, resolved
    through the registry."""

    def __getitem__(self, name: str) -> Callable:
        if name not in registry.tune_table():
            raise KeyError(name)
        return _make_factory(name)

    def __iter__(self):
        return iter(registry.tune_table())

    def __len__(self):
        return len(registry.tune_table())


ENGINE_FACTORIES = _FactoryTable()


def torch_engines() -> tuple:
    return tuple(s.tune_name for s in registry.specs("torch"))


def kernel_engines() -> tuple:
    return tuple(s.tune_name for s in registry.specs("cuda"))


def default_engines(include_kernels: Optional[bool] = None,
                    device=None) -> tuple:
    """The torch engines, plus the CUDA kernel engines when
    ``include_kernels`` is true or, with ``None``, when the device is the
    card (``device=None`` means the card)."""
    if include_kernels is None:
        include_kernels = registry.resolve_device(device).type == "cuda"
    return torch_engines() + kernel_engines() if include_kernels \
        else torch_engines()


def bucket_batch(batch: int) -> int:
    """Next power of two — one autotune decision (and one padded shape)
    per batch octave."""
    return 1 << max(int(batch) - 1, 0).bit_length()


def bucket_ladder(max_batch: int) -> tuple:
    """Every power-of-two batch bucket up to ``bucket_batch(max_batch)``
    — the complete set of batch shapes the bucketed execution paths (the
    kernel predictors and the fused cascade) can ever emit for batches
    ≤ ``max_batch``."""
    top = bucket_batch(max_batch)
    out, b = [], 1
    while b <= top:
        out.append(b)
        b *= 2
    return tuple(out)


def device_fingerprint(device=None) -> dict:
    """What the timings were measured *on*: ``torch-cuda`` with the card's
    name and compute capability, or ``torch-cpu``, and the host ISA.
    Part of every cache key (as a short hash) and of every schema-v2
    entry's ``meta`` (as a cost-model feature) — a cache file copied
    between machines, a CPU↔card switch, or an entry the reference wrote
    must key-miss rather than silently serve a winner measured on other
    hardware."""
    device = registry.resolve_device(device)
    if device.type == "cuda":
        major, minor = torch.cuda.get_device_capability(device)
        kind = f"{torch.cuda.get_device_name(device)} sm_{major}{minor}"
    else:
        kind = device.type
    return {"backend": f"torch-{device.type}", "device_kind": kind,
            "machine": platform.machine()}


def fingerprint_hash(fp: dict) -> str:
    """Short stable hash of a ``device_fingerprint()`` for key embedding."""
    blob = json.dumps(fp, sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:8]


def shape_key(forest: Forest, batch_bucket: int, n_devices: int = 1,
              device=None) -> str:
    # max_depth is part of the structure key: native/unrolled run
    # O(depth) iterations and bitmm's field packing widens with depth, so
    # a balanced and a chain-shaped forest with identical T/L/C/d rank
    # engines very differently.  The trailing fingerprint hash makes
    # pre-fingerprint (schema-v1) entries and foreign-machine cache files
    # key-miss and re-sweep.
    fp = device_fingerprint(device)
    return (f"{fp['backend']}"
            f"_T{forest.n_trees}_L{forest.n_leaves}_C{forest.n_classes}"
            f"_d{forest.n_features}_D{forest.max_depth}"
            f"_{np.dtype(forest.threshold.dtype).name}_B{batch_bucket}"
            f"_dev{n_devices}_fp{fingerprint_hash(fp)}")


def shape_meta(forest: Forest, batch_bucket: int, n_devices: int = 1,
               device=None) -> dict:
    """The cost-model feature view of one autotune decision (the entry's
    ``meta`` field): forest shape + batch bucket + device identity.
    Everything ``repro_torch.tune.extract`` needs to build a training row
    without re-parsing the shape key."""
    fp = device_fingerprint(device)
    return {
        "n_trees": int(forest.n_trees), "n_leaves": int(forest.n_leaves),
        "n_classes": int(forest.n_classes),
        "n_features": int(forest.n_features),
        "max_depth": int(forest.max_depth),
        "dtype": np.dtype(forest.threshold.dtype).name,
        "batch": int(batch_bucket), "n_devices": int(n_devices),
        "backend": fp["backend"], "device_kind": fp["device_kind"],
        "machine": fp["machine"], "fingerprint": fingerprint_hash(fp),
    }


_CACHE_DEFAULT = object()          # "cache_path not given" sentinel


def default_cache_path() -> str:
    # resolved per call, not at import, so REPRO_ENGINE_CACHE set after
    # import (e.g. pytest monkeypatch) still takes effect.  The file is
    # the reference's: the fingerprinted keys keep the two apart
    return os.environ.get(
        "REPRO_ENGINE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro",
                     "engine_cache.json"))


_MEM_CACHE: dict[str, dict] = {}
# (path, key) pairs whose in-memory entry is known to be on disk already —
# lets cache hits skip the read-merge-rewrite of the JSON file
_PERSISTED: set[tuple[str, str]] = set()

# Cache entry schema (docs/AUTOTUNE.md).  v1: {"engine", "timings"}.
# v2 adds per-candidate "compile_s" (predictor build + first predict,
# seconds) and "bench_us" (steady-state us per instance) kept separate —
# the selection metric stays the steady-state batch timing — plus "meta"
# (shape_meta: the cost model's feature row).  v1 entries still parse,
# but they predate the fingerprinted key and so never match a key this
# module generates.
SCHEMA_VERSION = 2


def _valid_entry(entry) -> bool:
    """Structural check for one cache entry: ``{"engine": str,
    "timings": {str: number}}`` with a non-empty timings dict (v1);
    the v2 fields are optional and checked only for shape."""
    if not isinstance(entry, dict):
        return False
    timings = entry.get("timings")
    if not isinstance(timings, dict) or not timings:
        return False
    if not all(isinstance(k, str) and isinstance(v, (int, float))
               and not isinstance(v, bool) for k, v in timings.items()):
        return False
    return all(isinstance(entry.get(fld, {}), dict)
               for fld in ("compile_s", "bench_us", "meta"))


def _load_disk(path: str) -> dict:
    """Parse the JSON cache file, dropping anything malformed.

    A truncated or hand-mangled cache (garbage JSON, a non-dict top
    level, entries missing ``timings`` or holding non-numeric values)
    must degrade to a clean re-sweep — and the next ``_store_disk``
    rewrites the file — never to an unhandled exception at serving time."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(data, dict):
        return {}
    return {k: v for k, v in data.items() if _valid_entry(v)}


def _merge_entry(old: Optional[dict], new: dict) -> dict:
    """Union of two sweeps' measurements — cached coverage only ever
    grows.  The schema-v2 side dicts (``compile_s``, ``bench_us``) union
    the same way; ``meta`` is shape-determined per key, so the newest
    writer wins."""
    if not old:
        return new
    timings = {**old.get("timings", {}), **new.get("timings", {})}
    out = {"engine": min(timings, key=timings.get), "timings": timings}
    for fld in ("compile_s", "bench_us"):
        d = {**(old.get(fld) or {}), **(new.get(fld) or {})}
        if d:
            out[fld] = d
    meta = new.get("meta") or old.get("meta")
    if meta:
        out["meta"] = meta
    if "v" in new or "v" in old:
        out["v"] = max(int(new.get("v", 1)), int(old.get("v", 1)))
    return out


def _store_disk(path: str, key: str, entry: dict) -> None:
    # read-merge-replace without a file lock: concurrent writers can drop
    # each other's timings (last replace wins). Acceptable — the cache is
    # an optimisation, and the cost is one redundant re-sweep later.
    # Entries of other keys (the reference's among them) are kept as read
    data = _load_disk(path)
    data[key] = _merge_entry(data.get(key), entry)
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1)
        os.replace(tmp, path)
        _PERSISTED.add((path, key))
    except OSError:
        pass                       # cache is an optimisation, never fatal


@dataclass
class EngineChoice:
    engine: str                    # winning candidate name
    key: str                       # shape/batch cache key
    predictor: object              # ready-to-serve predictor for `engine`
    timings: dict = field(default_factory=dict)   # candidate → median secs
    from_cache: bool = False
    compile_s: dict = field(default_factory=dict)  # candidate → build secs
    confidence: Optional[float] = None  # cost-model confidence (predict mode)
    predicted: bool = False        # True: zero-shot, no sweep ran
    pruned: tuple = ()             # candidates aliased to an identical IR

    def predict(self, X):
        return self.predictor.predict(X)


def _sync(device: torch.device) -> None:
    """Wait for the card before a clock starts: the asynchronous copies
    of a candidate's build must not be charged to its first timed call."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bench_once(pred, X: np.ndarray, repeats: int,
                device: torch.device) -> float:
    """Median host seconds of ``pred.predict(X)`` after one warm-up call:
    what a caller of ``predict`` pays (its numpy result ends each call)."""
    pred.predict(X)                # warmup
    ts = []
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        pred.predict(X)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _bench_candidate(factory: Callable, X: np.ndarray, repeats: int,
                     device: torch.device) -> tuple:
    """Build + time one candidate, keeping the two costs separate:
    ``compile_s`` is the predictor build plus the first predict (the
    kernel library's load on a card's first kernel call included); the
    returned bench seconds are the steady-state median that ``timings``
    persists.  A one-shot caller and a serving fleet weight the two very
    differently (docs/AUTOTUNE.md)."""
    _sync(device)
    t0 = time.perf_counter()
    pred = factory()
    pred.predict(X)                # first call, counted as compile_s
    compile_s = time.perf_counter() - t0
    return pred, compile_s, _bench_once(pred, X, repeats, device)


def _layout_tag(kw: dict) -> str:
    return ",".join(f"{k}={kw[k]}" for k in sorted(kw))


def _quant_tag(q: QuantSpec) -> str:
    """Candidate-name tag for a QuantSpec — encodes every field that
    changes the compiled variant, so distinct specs never alias in the
    timing cache (``q16`` for the default, suffixes otherwise)."""
    tag = f"q{q.bits}"
    if q.int_accum:
        tag += "i"                  # integer leaf accumulation (QUANT.md)
    if q.scale is not None:
        tag += f"s{q.scale:g}"
    if not q.quantize_splits:
        tag += "-nosplits"
    if not q.quantize_leaves:
        tag += "-noleaves"
    return tag


def _ir_hash(forest: Forest) -> str:
    """Content hash of a Forest IR — two candidates whose post-optimize
    IRs hash equal (same engine / layout / cascade / flint) compile to
    the same predictor, so the sweep benches one and aliases the other
    (optimizer-aware candidate pruning, docs/AUTOTUNE.md)."""
    h = hashlib.sha1()
    for a in (forest.feature, forest.threshold, forest.left, forest.right,
              forest.leaf_value, forest.n_nodes, forest.n_leaves_per_tree):
        h.update(np.ascontiguousarray(a).tobytes())
    for a in (forest.feat_lo, forest.feat_hi, forest.feat_map):
        h.update(b"\0" if a is None else np.ascontiguousarray(a).tobytes())
    h.update(repr((forest.quant_scale, forest.quant_bits,
                   forest.leaf_scale, forest.int_accum, forest.flint,
                   forest.leaf_err_bound, forest.n_features,
                   forest.n_features_src, forest.max_depth)).encode())
    return h.hexdigest()[:16]


def _candidate_factories(forest: Forest, engines: tuple,
                         quant_specs: Optional[tuple],
                         layout_specs: Optional[dict],
                         n_devices: int,
                         cascade_specs: Optional[tuple] = None,
                         opt_levels: Optional[tuple] = None,
                         flint: bool = False,
                         opt_cache: Optional[dict] = None,
                         device=None) -> dict[str, Callable]:
    """Candidate name → zero-arg predictor factory.

    The candidate axis is the (engine × quantization × optimization ×
    layout × cascade) product of the pipeline's passes: plain tune names
    for the forest as-is, ``<engine>@q<bits>`` per ``QuantSpec``,
    ``<engine>@O<level>`` per entry of ``opt_levels`` (the optimizer
    middle-end, ``repro_torch.optim``), ``<engine>@<kw=v,...>`` per entry
    of ``layout_specs[engine]`` (engine-kw overrides), and
    ``<engine>@cascade=16/48:<policy>`` per ``CascadeSpec`` (staged
    evaluation, ``repro_torch.cascade``) — or
    ``<engine>@cascade-fused=...`` when the spec sets ``fused=True``
    (on ``cuda-qs`` one ``cascade_qs_forward`` launch per batch).  With
    ``flint=True`` the torch engines' float variants also come as
    ``<engine>@flint``.  Names are the reference's, ``pallas-*`` read as
    ``cuda-*``, so entries of the same shape describe the same variants.

    Every factory compiles through ``compile_plan`` on ``device``, so
    the winning predictor always carries a ``CompilePlan`` —
    ``choice.predictor.plan.describe()`` explains the variant.

    With ``opt_cache`` (a dict, one per sweep) the optimize pass runs
    once per (quantized-forest, opt-tag) point and every engine/layout/
    cascade candidate at that point reuses the cached IR.  Each returned
    factory also carries ``.axes`` (the candidate's per-axis tags) and
    ``.group_key()`` (the identical-predictor equivalence class used for
    candidate pruning)."""
    from ..optim import resolve_opt
    if quant_specs and forest.quant_scale is not None:
        raise ValueError("quant_specs sweep needs a float forest "
                         "(this one is already quantized)")
    if cascade_specs and n_devices > 1:
        raise ValueError("cascade_specs cannot combine with n_devices > 1 "
                         "(staged evaluation is single-device)")
    unknown = set(layout_specs or ()) - set(engines)
    if unknown:
        # a silently ignored key would make the caller believe the cached
        # winner was layout-tuned when the sweep never ran
        raise ValueError(f"layout_specs keys {sorted(unknown)} are not in "
                         f"the requested engine set {tuple(engines)} "
                         "(use autotuner tune names, e.g. 'qs-bitmm')")
    for o in opt_levels or ():
        resolve_opt(o)                 # reject garbage levels up front
    if flint and forest.quant_scale is not None:
        raise ValueError("flint=True needs a float forest (FLInt rekeys "
                         "f32 thresholds; this one is already quantized)")
    quants: tuple = (None,) + (tuple(quant_specs) if quant_specs else ())
    opts: tuple = (None,) + (tuple(opt_levels) if opt_levels else ())
    cascades: tuple = (None,) + (tuple(cascade_specs) if cascade_specs
                                 else ())

    # FLInt axis: f32 thresholds rekeyed as monotone int32 (QUANT.md §4).
    # Only the float variant gets it (flint ⊕ quantize), and only torch
    # engines — the kernel wrappers stage inputs through f32, losing
    # int32 keys (the pipeline's flint pass rejects cuda)
    def flints(e: str, q) -> tuple:
        if flint and q is None and \
                registry.by_tune_name(e).backend == "torch":
            return (False, True)
        return (False,)
    variants: list[tuple] = [
        (e, q, o, kw, casc, fl)
        for e in engines for q in quants for o in opts
        for kw in (None,) + tuple((layout_specs or {}).get(e, ()))
        for casc in cascades for fl in flints(e, q)]

    qforests: dict[int, Forest] = {}   # one quantized forest per spec

    def qf(q: Optional[QuantSpec]) -> Forest:
        if q is None:
            return forest
        if id(q) not in qforests:
            qforests[id(q)] = quantize_forest(forest, None, q)
        return qforests[id(q)]

    def make(name: str, q: Optional[QuantSpec], o,
             kw: Optional[dict], casc, fl: bool = False) -> Callable:
        spec = registry.by_tune_name(name)
        ekw = dict(kw or {})
        if n_devices > 1 and not spec.shardable:
            raise ValueError(
                f"engine {name!r} cannot run tree-sharded "
                f"(n_devices={n_devices}); restrict engines= to "
                f"{[s.tune_name for s in registry.specs() if s.shardable]}")

        def factory():
            from .pipeline import CompilePlan, compile_plan
            plan = CompilePlan(engine=spec.name, backend=spec.backend,
                               device=device, opt=o, n_devices=n_devices,
                               cascade=casc, flint=fl, engine_kw=dict(ekw))
            return compile_plan(qf(q), plan, opt_cache=opt_cache)

        factory.axes = {
            "engine": name,
            "quant": _quant_tag(q) if q is not None else "",
            "opt": resolve_opt(o)[1] if o is not None else "",
            "layout": _layout_tag(kw) if kw is not None else "",
            "cascade": casc.tag() if casc is not None else "",
            "flint": fl,
        }

        def group_key() -> tuple:
            # the post-optimize IR fully determines the compiled artifact
            # alongside engine + layout kw + cascade + flint (the flint
            # pass runs after optimize and is deterministic); with the
            # shared opt_cache this costs one optimize per (quant, opt)
            # point — work the sweep was about to do anyway
            from .pipeline import optimized_forest
            ir = optimized_forest(qf(q), o, opt_cache=opt_cache)
            return (name, factory.axes["layout"], factory.axes["cascade"],
                    fl, _ir_hash(ir))

        factory.group_key = group_key
        return factory

    def cname(e: str, q: Optional[QuantSpec], o, kw: Optional[dict],
              casc, fl: bool = False) -> str:
        name = e if q is None else f"{e}@{_quant_tag(q)}"
        if fl:
            name = f"{name}@flint"
        if o is not None:
            name = f"{name}@{resolve_opt(o)[1]}"
        if kw is not None:
            name = f"{name}@{_layout_tag(kw)}"
        return name if casc is None else f"{name}@{casc.tag()}"

    return {cname(e, q, o, kw, casc, fl): make(e, q, o, kw, casc, fl)
            for e, q, o, kw, casc, fl in variants}


def default_model_path() -> str:
    """Where ``mode="predict"`` looks for the trained cost model when the
    caller passes none: ``$REPRO_COST_MODEL`` or the cache-sibling
    default (``repro_torch.tune.train_from_cache`` writes here too)."""
    return os.environ.get(
        "REPRO_COST_MODEL",
        os.path.join(os.path.expanduser("~"), ".cache", "repro",
                     "cost_model.json"))


# path → (mtime, model): a fleet cold-start resolves the same artifact
# once per change, not once per tenant
_MODEL_CACHE: dict[str, tuple] = {}


def _resolve_cost_model(cm):
    """``cost_model=`` argument → a loaded ``repro_torch.tune.CostModel``
    or ``None`` (predict mode then falls back to a full sweep).  Accepts a
    model object, a path, or ``None`` for ``default_model_path()``.  A
    missing/corrupt *default* artifact degrades to ``None`` (with a log
    warning for corruption); an explicitly passed path raises — the
    caller asked for that file by name."""
    explicit = cm is not None
    if cm is None:
        cm = default_model_path()
    if not isinstance(cm, (str, os.PathLike)):
        return cm
    path = os.fspath(cm)
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        if explicit:
            raise FileNotFoundError(
                f"cost_model path {path!r} does not exist") from None
        return None
    hit = _MODEL_CACHE.get(path)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    from ..tune import CostModel
    try:
        model = CostModel.load(path)
    except (OSError, ValueError):
        if explicit:
            raise
        _LOG.warning("cost_model_unreadable", path=path)
        return None
    _MODEL_CACHE[path] = (mtime, model)
    return model


def _bench_rows(forest: Forest, bucket: int, seed: int) -> np.ndarray:
    # n_features_in, not n_features: an already-optimized forest (with a
    # feat_map from drop_unused_features) still takes full-width rows
    return np.random.default_rng(seed).normal(
        0, 1.0, size=(bucket, forest.n_features_in))


def choose(forest: Forest, batch: int, *, engines=None,
           include_kernels: Optional[bool] = None,
           quant_specs: Optional[tuple] = None,
           layout_specs: Optional[dict] = None,
           cascade_specs: Optional[tuple] = None,
           opt_levels: Optional[tuple] = None,
           flint: bool = False,
           n_devices: int = 1,
           cache_path=_CACHE_DEFAULT,
           force: bool = False, repeats: int = 3,
           seed: int = 0,
           mode: str = "measure",
           cost_model=None,
           confidence_threshold: float = 0.8,
           top_k: int = 3,
           share_ir: bool = True,
           feedback: bool = True,
           device=None) -> EngineChoice:
    """Pick the fastest candidate for ``forest`` at this batch-size bucket
    on ``device`` (``None`` → the card; without CUDA that raises).

    Candidates are (engine × quantization × optimization × layout ×
    cascade) variants — see ``_candidate_factories``; ``engines=None``
    is ``default_engines(include_kernels, device)``: the six torch
    engines, and on the card the three CUDA kernels too.  ``opt_levels=
    (1, 2)`` adds optimizer middle-end variants (``qs@O2``);
    ``flint=True`` adds ``<engine>@flint`` variants of the torch
    engines.  Cascade candidates (``cascade_specs=``) time the gated path
    on the synthetic benchmark batch — exit fractions on real traffic
    depend on the data, so treat a cascade winner as a hint and benchmark
    on representative rows when it matters; include ``CascadeSpec(...,
    fused=True)`` entries to race the fused execution against the staged
    host loop.  Cache hits (in-memory, then the JSON file at
    ``cache_path``) skip the sweep and only build the winning predictor.
    A cached entry counts as a hit only if its accumulated sweeps covered
    every candidate the caller asked for — the winner is then re-derived
    over the requested subset — so a narrow ``engines=`` sweep can never
    answer for the full matrix; a partial-coverage miss benchmarks only
    the candidates not yet measured.  New sweeps merge into the cached
    entry (timings union, both layers), so within a process coverage only
    grows and a narrow re-sweep never erases wider measurements;
    cross-process disk merges are best-effort (unlocked
    read-merge-replace — see ``_store_disk``).  Merged timings may come
    from different runs (machine load, ``repeats``) — the cache assumes
    per-shape rankings are stable enough that this is fine.
    When ``cache_path`` is omitted it defaults to ``$REPRO_ENGINE_CACHE``
    (or ``~/.cache/repro/engine_cache.json``); ``cache_path=None``
    disables the disk layer entirely.  ``force=True`` re-benchmarks
    regardless of any cached entry.

    Each candidate is timed by the host clock around ``predict`` (what a
    caller pays: its numpy result ends the call), the card synchronized
    before each clock starts; only the best predictor so far stays alive
    during a sweep.

    ``mode="predict"`` (alias ``"-Os"``) is the zero-shot path: after the
    cache layers miss, a learned cost model (``cost_model=`` — a
    ``repro_torch.tune.CostModel``, a path, or ``None`` for
    ``default_model_path()``) ranks the candidates without compiling
    any.  At confidence ≥ ``confidence_threshold`` only the predicted
    winner is built; with ``feedback=True`` (default) it is also
    quick-benched and the measurement written into the cache as ground
    truth for future training rounds.  Below the threshold (or with no
    model) the sweep still runs, narrowed to the ``top_k`` predicted
    candidates (full set when no model could rank them).  The returned
    ``EngineChoice`` carries ``predicted`` / ``confidence``.

    ``share_ir=True`` (default) shares one optimized IR across the
    engine / layout / cascade axes of the sweep — the optimize pass and
    its oracle check run once per (quant, opt) point — and prunes
    candidates whose post-optimize IR is provably identical (their
    timings are aliased to the one benched representative, listed in
    ``EngineChoice.pruned``).  ``n_devices > 1`` wraps every candidate
    tree-sharded (``core.shard``): the default engine set narrows to the
    shardable torch engines, an explicit non-shardable one raises
    ``ValueError``, and on the card the shards need as many visible
    cards."""
    mode = str(mode).lower().lstrip("-")
    if mode == "os":
        mode = "predict"
    if mode not in ("measure", "predict"):
        raise ValueError(
            f"mode must be 'measure' or 'predict' (alias '-Os'), "
            f"got {mode!r}")
    device = registry.resolve_device(device)
    if engines is None:
        engines = default_engines(include_kernels, device)
        if n_devices > 1:
            # the *default* set narrows to shardable engines (on the card
            # it holds the cuda kernels, which cannot tree-shard); an
            # explicit engines= list still errors on non-shardable entries
            engines = tuple(e for e in engines
                            if registry.by_tune_name(e).shardable)
    else:
        engines = tuple(engines)
    opt_cache: Optional[dict] = {} if share_ir else None
    factories = _candidate_factories(forest, engines,
                                     tuple(quant_specs) if quant_specs
                                     else None, layout_specs, n_devices,
                                     tuple(cascade_specs) if cascade_specs
                                     else None,
                                     tuple(opt_levels) if opt_levels
                                     else None, flint=flint,
                                     opt_cache=opt_cache, device=device)
    candidates = tuple(factories)
    if cache_path is _CACHE_DEFAULT:
        cache_path = default_cache_path()
    bucket = bucket_batch(batch)
    key = shape_key(forest, bucket, n_devices, device)

    obs = _autotune_metrics()
    prior = _MEM_CACHE.get(key)
    # for the cache-hit layer label: did memory alone cover the request,
    # before the disk layer widened it?
    mem_covered = (prior is not None
                   and set(candidates) <= set(prior.get("timings", {})))
    if cache_path and not mem_covered:
        disk = _load_disk(cache_path).get(key)
        if disk is not None:           # warm/widen the memory layer
            if prior is None:
                prior = disk
                _PERSISTED.add((cache_path, key))
            else:
                # memory may hold timings the file lacks — not persisted
                prior = _merge_entry(disk, prior)
                _PERSISTED.discard((cache_path, key))
            _MEM_CACHE[key] = prior
    if not force and prior is not None:
        cached = prior.get("timings", {})
        if set(candidates) <= set(cached):
            winner = min(candidates, key=cached.get)
            if cache_path and (cache_path, key) not in _PERSISTED:
                # write-through: the entry may exist only in memory (e.g.
                # swept earlier with cache_path=None); a merge against the
                # file is idempotent and trivial next to the compile below
                _store_disk(cache_path, key, prior)
            if obs is not None:
                layer = "memory" if mem_covered else "disk"
                obs["hits"].labels(layer=layer).inc()
                obs["winner"].labels(key=key, engine=winner).set(1.0)
            return EngineChoice(engine=winner, key=key,
                                predictor=factories[winner](),
                                timings={e: cached[e] for e in candidates},
                                from_cache=True)

    cached = (prior or {}).get("timings", {})

    # ---------------- zero-shot (-Os) path ------------------------------
    confidence: Optional[float] = None
    if mode == "predict" and not force:
        model = _resolve_cost_model(cost_model)
        reason = "no_model"
        if model is not None:
            meta = shape_meta(forest, bucket, n_devices, device)
            assess = model.assess(meta, candidates)
            confidence = float(assess["confidence"])
            if confidence >= confidence_threshold:
                widx = int(assess["order"][0])
                winner = candidates[widx]
                X = _bench_rows(forest, bucket, seed)
                if feedback:
                    pred, c_s, b_s = _bench_candidate(
                        factories[winner], X, repeats, device)
                    getattr(pred, "reset_exit_stats", lambda: None)()
                    us = b_s / bucket * 1e6
                    entry = {"engine": winner, "timings": {winner: b_s},
                             "compile_s": {winner: c_s},
                             "bench_us": {winner: us}, "meta": meta,
                             "v": SCHEMA_VERSION}
                    _MEM_CACHE[key] = _merge_entry(prior, entry)
                    _PERSISTED.difference_update(
                        {pk for pk in _PERSISTED if pk[1] == key})
                    if cache_path:
                        _store_disk(cache_path, key, _MEM_CACHE[key])
                    rel_err = abs(float(assess["us"][widx]) - us) \
                        / max(us, 1e-12)
                    timings = {winner: b_s}
                else:
                    _sync(device)
                    t0 = time.perf_counter()
                    pred = factories[winner]()
                    pred.predict(X)
                    c_s = time.perf_counter() - t0
                    getattr(pred, "reset_exit_stats", lambda: None)()
                    rel_err, timings = None, {}
                if obs is not None:
                    obs["predict_hits"].inc()
                    obs["winner"].labels(key=key, engine=winner).set(1.0)
                    if rel_err is not None:
                        obs["feedback"].inc()
                        obs["predict_err"].observe(rel_err)
                        obs["predict_err_last"].labels(key=key).set(rel_err)
                _LOG.info("predict", key=key, winner=winner,
                          confidence=confidence, rel_err=rel_err)
                return EngineChoice(
                    engine=winner, key=key, predictor=pred,
                    timings=timings, from_cache=False,
                    compile_s={winner: c_s}, confidence=confidence,
                    predicted=True)
            reason = "low_confidence"
            k = max(1, int(top_k))
            if len(candidates) > k:
                keep = {candidates[int(i)] for i in assess["order"][:k]}
                candidates = tuple(c for c in candidates if c in keep)
        if obs is not None:
            obs["fallbacks"].labels(reason=reason).inc()
        _LOG.info("predict_fallback", key=key, reason=reason,
                  confidence=confidence, candidates=len(candidates))
        if set(candidates) <= set(cached):
            # the narrowed top-k may be fully covered by earlier sweeps
            winner = min(candidates, key=cached.get)
            if obs is not None:
                obs["hits"].labels(
                    layer="memory" if mem_covered else "disk").inc()
                obs["winner"].labels(key=key, engine=winner).set(1.0)
            return EngineChoice(
                engine=winner, key=key, predictor=factories[winner](),
                timings={e: cached[e] for e in candidates},
                from_cache=True, confidence=confidence)

    # ---------------- measured sweep ------------------------------------
    to_bench = candidates if force \
        else tuple(e for e in candidates if e not in cached)
    if obs is not None:
        reason = "forced" if force else ("partial" if cached else "cold")
        obs["misses"].labels(reason=reason).inc()
    X = _bench_rows(forest, bucket, seed)
    # optimizer-aware candidate pruning: candidates in the same
    # identical-predictor equivalence class (same engine / layout /
    # cascade / flint on a bit-identical post-optimize IR) are benched
    # once and aliased — their timings are genuinely equal
    if opt_cache is not None and len(to_bench) > 1:
        groups: dict[tuple, list] = {}
        for name in to_bench:
            groups.setdefault(factories[name].group_key(), []).append(name)
        reps = {members[0]: members for members in groups.values()}
    else:
        reps = {name: [name] for name in to_bench}
    pruned = tuple(m for members in reps.values() for m in members[1:])
    fresh: dict[str, float] = {}
    fresh_compile: dict[str, float] = {}
    best_pred, best_t = None, float("inf")
    sweep_t0 = time.perf_counter()
    for name, members in reps.items():
        pred, c_s, b_s = _bench_candidate(factories[name], X, repeats,
                                          device)
        for m in members:
            fresh[m] = b_s
            fresh_compile[m] = c_s
        # keep only the best-so-far predictor: peak memory stays
        # max(current, best) instead of the sum over the engine matrix
        if b_s < best_t:
            best_pred, best_t = pred, b_s
        del pred
    sweep_s = time.perf_counter() - sweep_t0
    # partial-coverage miss: cached timings fill in the engines we skipped
    timings = {e: fresh.get(e, cached.get(e)) for e in candidates}
    winner = min(timings, key=timings.get)
    if obs is not None:
        obs["sweeps"].inc()
        obs["sweep_s"].observe(sweep_s)
        obs["benched"].inc(float(len(reps)))
        obs["winner"].labels(key=key, engine=winner).set(1.0)
    _LOG.info("sweep", key=key, candidates=len(to_bench),
              benched=len(reps), pruned=len(pruned),
              seconds=sweep_s, winner=winner)
    if best_pred is not None:
        # cascade predictors count per-stage exits cumulatively; the
        # benchmark rows must not pollute the served exit accounting
        getattr(best_pred, "reset_exit_stats", lambda: None)()
    if fresh:
        # the stored engine must be the winner over the entry's own
        # timings (merges re-derive it over the union; lookups re-derive
        # per request)
        entry = {"engine": min(fresh, key=fresh.get), "timings": fresh,
                 "compile_s": fresh_compile,
                 "bench_us": {c: t / bucket * 1e6
                              for c, t in fresh.items()},
                 "meta": shape_meta(forest, bucket, n_devices, device),
                 "v": SCHEMA_VERSION}
        _MEM_CACHE[key] = _merge_entry(prior, entry)
        # the memory entry just changed: any disk copy of the key is stale
        _PERSISTED.difference_update(
            {pk for pk in _PERSISTED if pk[1] == key})
        if cache_path:
            # persist the merged union, not just this sweep: coverage that
            # so far existed only in memory reaches disk too (re-merged)
            _store_disk(cache_path, key, _MEM_CACHE[key])
    return EngineChoice(
        engine=winner, key=key,
        predictor=best_pred if winner in fresh
        else factories[winner](),
        timings=timings, from_cache=False, compile_s=dict(fresh_compile),
        confidence=confidence, pruned=pruned)


def clear_cache(cache_path: Optional[str] = None) -> None:
    """Drop the in-memory cache (and the disk file, if a path is given)."""
    _MEM_CACHE.clear()
    _PERSISTED.clear()
    _MODEL_CACHE.clear()
    if cache_path:
        try:
            os.remove(cache_path)
        except OSError:
            pass
