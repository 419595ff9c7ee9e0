"""Packed ``.repro.npz`` serialization — forests and compiled predictors;
the port's counterpart of ``repro.io.packed`` (docs/FORMATS.md).

One container serves both packages: the same ``FORMAT`` and ``VERSION``,
the same header and the same array entries.

  * ``kind="forest"`` — the canonical IR: node records concatenated per
    tree in preorder, leaf records in-order, padding stripped (ragged
    trees carried by offset arrays).  Quantization metadata rides in the
    header, so a quantized forest round-trips bit-exactly, and a forest
    either package writes loads in the other with array-equal IR.
  * ``kind="predictor"`` — a compiled engine artifact: the buffers its
    ``EngineSpec.serial_arrays`` declares, the module's scalar config, the
    recorded ``CompilePlan`` and the embedded forest.  ``load_predictor``
    rebuilds the predictor on a device **without recompiling**
    (``CompiledModule.restore``).
  * ``kind="cascade"`` — a staged or fused ``CascadePredictor``: every
    stage's compiled arrays, the forest once and the gate's config.

Where the reference rebuilds a compiled dataclass from the class path in
the header, the port never imports that path: it resolves the header's
``engine`` and ``backend`` (the reference's ``"jax"`` is the port's
``"torch"``) through its own registry, whose spec restores the port's
module.  Arrays are stored in the reference's dtypes (int32 indices,
uint32 bit patterns), so an artifact the reference wrote gives exactly
the buffers a fresh compile in the port gives.  The ``cuda`` engines, like
the reference's Pallas ones, declare no ``serial_arrays``: their
predictors are rebuilt from the forest, never saved.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Union

import numpy as np
import torch

from ..core.forest import Forest

FORMAT = "repro.pack"
VERSION = 1

PathLike = Union[str, os.PathLike]

# header backend → the port's backend with the same engines
_BACKENDS = {"jax": "torch", "torch": "torch"}


# --------------------------------------------------------------------------- #
# Header plumbing
# --------------------------------------------------------------------------- #
def _norm(path: PathLike) -> str:
    # np.savez silently appends ".npz"; normalize so save/load agree
    p = os.fspath(path)
    return p if p.endswith(".npz") else p + ".npz"


def _write_npz(path: PathLike, header: dict, arrays: dict) -> None:
    header = dict(header, format=FORMAT, version=VERSION)
    np.savez(_norm(path), header=np.asarray(json.dumps(header)),
             **arrays)


def _read_npz(path: PathLike):
    try:
        npz = np.load(_norm(path), allow_pickle=False)
    except Exception as e:
        raise ValueError(f"{path!r} is not a readable .npz file: {e}") from e
    if "header" not in npz.files:
        raise ValueError(f"{path!r} has no header entry — not a "
                         f"{FORMAT} file")
    try:
        header = json.loads(str(npz["header"]))
    except ValueError as e:
        raise ValueError(f"{path!r} has a corrupt header: {e}") from e
    if header.get("format") != FORMAT:
        raise ValueError(f"{path!r}: unknown format "
                         f"{header.get('format')!r} (expected {FORMAT})")
    if int(header.get("version", -1)) > VERSION:
        raise ValueError(
            f"{path!r} is version {header['version']}, newer than this "
            f"reader (max {VERSION}) — upgrade before loading")
    return header, npz


# --------------------------------------------------------------------------- #
# Forest IR <-> packed arrays
# --------------------------------------------------------------------------- #
_NODE_FIELDS = ("feature", "threshold", "left", "right",
                "leaf_lo", "leaf_mid", "leaf_hi")


def _pack_forest(forest: Forest, prefix: str = "") -> tuple[dict, dict]:
    """Forest → (header-meta, arrays): padding stripped, nodes in
    preorder, leaves in-order, ragged boundaries in offset arrays."""
    T = forest.n_trees
    nn = forest.n_nodes.astype(np.int64)
    nl = forest.n_leaves_per_tree.astype(np.int64)
    node_off = np.zeros(T + 1, np.int64)
    leaf_off = np.zeros(T + 1, np.int64)
    np.cumsum(nn, out=node_off[1:])
    np.cumsum(nl, out=leaf_off[1:])

    arrays = {}
    for name in _NODE_FIELDS:
        full = getattr(forest, name)
        arrays[prefix + "node_" + name] = np.concatenate(
            [full[t, :nn[t]] for t in range(T)]) if T else full[:0, 0]
    arrays[prefix + "leaf_value"] = np.concatenate(
        [forest.leaf_value[t, :nl[t]] for t in range(T)])
    arrays[prefix + "node_offset"] = node_off
    arrays[prefix + "leaf_offset"] = leaf_off
    meta = {
        "n_trees": T, "n_leaves": forest.n_leaves,
        "n_classes": forest.n_classes, "n_features": forest.n_features,
        "max_depth": forest.max_depth,
        "quant_scale": forest.quant_scale, "quant_bits": forest.quant_bits,
        "leaf_scale": forest.leaf_scale,
    }
    # integer end-to-end extensions (docs/QUANT.md): written only when
    # set, as the reference writes them
    if forest.int_accum:
        meta["int_accum"] = True
    if forest.flint:
        meta["flint"] = True
    if forest.leaf_err_bound is not None:
        meta["leaf_err_bound"] = float(forest.leaf_err_bound)
    if forest.feat_lo is not None:
        arrays[prefix + "feat_lo"] = np.asarray(forest.feat_lo)
        arrays[prefix + "feat_hi"] = np.asarray(forest.feat_hi)
    if forest.feat_map is not None:
        # optimized IR (drop_unused_features): the column remap rides in
        # its own entry; n_features_in tells a reader the row width
        # callers still pass
        arrays[prefix + "feat_map"] = np.asarray(forest.feat_map,
                                                 dtype=np.int64)
        meta["n_features_in"] = forest.n_features_in
    return meta, arrays


def _unpack_forest(meta: dict, npz, prefix: str = "") -> Forest:
    T, L = int(meta["n_trees"]), int(meta["n_leaves"])
    C = int(meta["n_classes"])
    node_off = npz[prefix + "node_offset"]
    leaf_off = npz[prefix + "leaf_offset"]
    nn = np.diff(node_off).astype(np.int32)
    nl = np.diff(leaf_off).astype(np.int32)

    # ragged → rectangular scatter: row-major boolean masks visit tree 0's
    # slots first, matching _pack_forest's per-tree concatenation order
    node_mask = np.arange(L - 1)[None, :] < nn[:, None]      # (T, L-1)
    leaf_mask = np.arange(L)[None, :] < nl[:, None]          # (T, L)
    padded = {}
    for name in _NODE_FIELDS:
        flat = npz[prefix + "node_" + name]
        fill = -1 if name == "feature" else 0
        full = np.full((T, L - 1), fill, dtype=flat.dtype)
        full[node_mask] = flat
        padded[name] = full
    lv_flat = npz[prefix + "leaf_value"]
    leaf_value = np.zeros((T, L, C), dtype=lv_flat.dtype)
    leaf_value[leaf_mask] = lv_flat

    def entry(name):
        return npz[prefix + name] if prefix + name in npz.files else None
    feat_map = entry("feat_map")
    return Forest(
        n_trees=T, n_leaves=L, n_classes=C,
        n_features=int(meta["n_features"]),
        leaf_value=leaf_value, n_nodes=nn, n_leaves_per_tree=nl,
        max_depth=int(meta["max_depth"]),
        quant_scale=meta.get("quant_scale"),
        quant_bits=meta.get("quant_bits"),
        leaf_scale=float(meta.get("leaf_scale", 1.0)),
        feat_lo=entry("feat_lo"), feat_hi=entry("feat_hi"),
        feat_map=feat_map,
        n_features_src=None if feat_map is None
        else meta.get("n_features_in"),
        int_accum=bool(meta.get("int_accum", False)),
        flint=bool(meta.get("flint", False)),
        leaf_err_bound=meta.get("leaf_err_bound"), **padded)


def peek(path: PathLike) -> dict:
    """Read just the header of a packed file (kind, shape, engine, ...)
    without materialising any arrays."""
    header, _ = _read_npz(path)
    return header


def save_forest(forest: Forest, path: PathLike) -> None:
    """Write the canonical IR as a packed ``.repro.npz`` (kind=forest)."""
    meta, arrays = _pack_forest(forest)
    _write_npz(path, {"kind": "forest", "forest": meta}, arrays)


def load_forest(path: PathLike) -> Forest:
    """Load a packed forest (bit-exact round trip, quantization included)."""
    header, npz = _read_npz(path)
    if header.get("kind") != "forest":
        raise ValueError(f"{path!r} holds a {header.get('kind')!r} "
                         "artifact, not a forest (use load_predictor)")
    return _unpack_forest(header["forest"], npz)


# --------------------------------------------------------------------------- #
# Compiled predictor artifacts
# --------------------------------------------------------------------------- #
def _encode_scalar(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, torch.dtype):             # gemm's compute_dtype
        return {"__dtype__": str(v).removeprefix("torch.")}
    raise TypeError(f"cannot serialize compiled scalar field {v!r} of type "
                    f"{type(v).__name__}")


def _decode_scalar(v):
    if isinstance(v, dict) and "__dtype__" in v:
        dt = getattr(torch, v["__dtype__"], None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {v['__dtype__']!r} in header")
        return dt
    return v


def _getattr_path(obj, dotted: str):
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def _class_path(obj) -> str:
    t = type(obj)
    return f"{t.__module__}:{t.__qualname__}"


def _walk_compiled(compiled, serial_arrays: tuple):
    """Compiled module (possibly nested) → (classes, scalars, arrays),
    keyed as the reference keys its dataclass walk: ``serial_arrays``
    names the buffers, dotted for nesting; every module on the way
    contributes its class path and scalar config under its prefix."""
    arrays, prefixes = {}, {""}
    for name in serial_arrays:
        prefix, _, leaf = name.rpartition(".")
        owner = _getattr_path(compiled, prefix) if prefix else compiled
        arrays[name] = owner.saved_array(leaf)
        parts = prefix.split(".") if prefix else []
        for i in range(1, len(parts) + 1):
            prefixes.add(".".join(parts[:i]))
    classes, scalars = {}, {}
    for prefix in sorted(prefixes):
        obj = _getattr_path(compiled, prefix) if prefix else compiled
        classes[prefix] = _class_path(obj)
        scalars[prefix] = {k: _encode_scalar(v)
                           for k, v in obj.scalar_config().items()}
    return classes, scalars, arrays


def _spec_for_header(header: dict):
    """The port's spec for an artifact's engine and backend: the
    reference's ``jax`` engines are the port's ``torch`` ones."""
    from ..core import registry
    backend = _BACKENDS.get(header.get("backend"))
    if backend is None:
        raise ValueError(f"artifact backend {header.get('backend')!r} has "
                         f"no serializable engines here (known: "
                         f"{sorted(_BACKENDS)})")
    spec = registry.get(header["engine"], backend)
    if spec.restore is None or not spec.serial_arrays:
        raise ValueError(f"engine {spec.name}/{spec.backend} cannot be "
                         "restored from an artifact")
    return spec


def _rebuild_compiled(spec, scalars: dict, npz, forest: Optional[Forest],
                      device: torch.device, array_prefix: str = "c."):
    """Inverse of ``_walk_compiled``: the spec's module restored on
    ``device`` from the header's scalars and the npz arrays under
    ``array_prefix`` (``c.`` for plain predictors, ``s{k}.c.`` per stage
    of a cascade artifact)."""
    arrays = {n[len(array_prefix):]: npz[n] for n in npz.files
              if n.startswith(array_prefix)}
    missing = sorted(set(spec.serial_arrays) - set(arrays))
    if missing:
        raise ValueError(f"artifact lacks {missing} for engine "
                         f"{spec.name}")
    arrays = {n: arrays[n] for n in spec.serial_arrays}
    scalars = {p: {k: _decode_scalar(v) for k, v in sc.items()}
               for p, sc in scalars.items()}
    return spec.restore(arrays, scalars, forest, device)


def _spec_for_predictor(pred):
    """The registered EngineSpec a predictor came from: its eval fn is the
    spec's ``evaluate`` (disambiguates native vs unrolled, which share
    compiled arrays)."""
    from ..core import registry
    fn = getattr(pred, "_eval", None)
    for spec in registry.specs():
        if spec.evaluate is not None and spec.evaluate is fn:
            return spec
    raise ValueError(
        f"cannot serialize {type(pred).__name__}: no registered engine "
        "matches its evaluate fn (cuda kernel predictors are rebuilt from "
        "the forest, not serialized — save the forest with "
        "io.save_forest and recompile it)")


def _plan_records(pred) -> list:
    plan = getattr(pred, "plan", None)
    return [[r.name, r.detail] for r in plan.records] \
        if plan is not None else []


def _save_cascade(pred, path: PathLike, extra: Optional[dict]) -> None:
    """Serialize a ``CascadePredictor`` (kind=cascade): each stage's
    compiled arrays (namespaced ``s{k}.c.``), the full forest once, and the
    gate policy's scalar config."""
    from ..cascade.policy import policy_to_header
    from ..core import registry
    spec = registry.get(pred.engine, pred.backend)
    if not spec.serial_arrays:
        raise ValueError(
            f"engine {pred.engine}/{pred.backend} declares no "
            "serial_arrays — its cascade artifact is not serializable "
            "(save the forest with io.save_forest and recompile it)")
    arrays, stage_classes, stage_scalars = {}, [], []
    for k, sp in enumerate(pred.stage_predictors):
        classes, scalars, carrays = _walk_compiled(sp.compiled,
                                                   spec.serial_arrays)
        arrays.update({f"s{k}.c.{n}": v for n, v in carrays.items()})
        stage_classes.append(classes)
        stage_scalars.append(scalars)
    fmeta, farrays = _pack_forest(pred.forest, prefix="f.")
    arrays.update(farrays)
    header = {
        "kind": "cascade",
        "engine": pred.engine, "backend": pred.backend,
        "tune_name": spec.tune_name,
        "fused": bool(getattr(pred, "fused", False)),
        "stages": [int(s) for s in pred.stages],
        "policy": policy_to_header(pred.policy),
        "engine_kw": {k: _encode_scalar(v)
                      for k, v in pred.engine_kw.items()},
        "stage_classes": stage_classes, "stage_scalars": stage_scalars,
        "forest": fmeta,
        "plan": _plan_records(pred),
    }
    if extra:
        header.update(extra)
    _write_npz(path, header, arrays)


def _restored_plan(spec, device, header: dict, path: PathLike):
    from ..core.pipeline import CompilePlan
    plan = CompilePlan(engine=spec.name, backend=spec.backend, device=device)
    for name, detail in header.get("plan", []):
        plan.record(name, detail)
    plan.record("deserialize", f"loaded from {os.fspath(path)}")
    return plan


def _load_cascade(header: dict, npz, path: PathLike, device):
    """Rebuild a cascade artifact on ``device``: the forest once, each
    stage's compiled arrays against its tree slice of the IR, the gate from
    its header config — predictions bit-identical to the saved cascade's.
    The ``fused`` flag restores the fused variant (its generic tier, over
    the loaded stage arrays)."""
    from ..cascade import (CascadePredictor, CascadeSpec,
                           FusedCascadePredictor, tree_slice)
    from ..cascade.policy import policy_from_header
    spec = _spec_for_header(header)
    forest = _unpack_forest(header["forest"], npz, prefix="f.")
    stages = [int(s) for s in header["stages"]]
    bounds = [0] + stages
    stage_preds = []
    for k, scalars in enumerate(header["stage_scalars"]):
        sub = tree_slice(forest, bounds[k], bounds[k + 1])
        compiled = _rebuild_compiled(spec, scalars, npz, sub, device,
                                     array_prefix=f"s{k}.c.")
        stage_preds.append(spec.predictor_cls(compiled, spec.evaluate))
    engine_kw = {k: _decode_scalar(v)
                 for k, v in (header.get("engine_kw") or {}).items()}
    fused = bool(header.get("fused", False))
    cls = FusedCascadePredictor if fused else CascadePredictor
    pred = cls(
        forest,
        CascadeSpec(stages=tuple(stages),
                    policy=policy_from_header(header["policy"]),
                    fused=fused),
        engine=spec.name, backend=spec.backend, engine_kw=engine_kw,
        stage_predictors=stage_preds, device=device)
    pred.plan = _restored_plan(spec, device, header, path)
    return pred


def save_predictor(pred, path: PathLike, *, extra: Optional[dict] = None
                   ) -> None:
    """Serialize a compiled predictor (kind=predictor), or a
    ``CascadePredictor`` (kind=cascade — per-stage arrays + gate config).

    The engine must declare its buffers via ``EngineSpec.serial_arrays``;
    a ``cuda`` predictor raises ``ValueError`` (save the forest and
    recompile).  The embedded forest, scalar config and recorded
    ``CompilePlan`` ride in the header; ``extra`` merges caller metadata
    (e.g. the serving config) into it."""
    from ..cascade.predictor import CascadePredictor
    if isinstance(pred, CascadePredictor):
        return _save_cascade(pred, path, extra)
    spec = _spec_for_predictor(pred)
    if not spec.serial_arrays:
        raise ValueError(f"engine {spec.name}/{spec.backend} declares no "
                         "serial_arrays — its artifact is not serializable")
    compiled = pred.compiled
    classes, scalars, carrays = _walk_compiled(compiled, spec.serial_arrays)
    forest = getattr(compiled, "forest", None)
    if forest is None and hasattr(compiled, "qs"):
        forest = compiled.qs.forest
    arrays = {f"c.{k}": v for k, v in carrays.items()}
    fmeta = None
    if forest is not None:
        fmeta, farrays = _pack_forest(forest, prefix="f.")
        arrays.update(farrays)
    header = {
        "kind": "predictor",
        "engine": spec.name, "backend": spec.backend,
        "tune_name": spec.tune_name,
        "classes": classes, "scalars": scalars,
        "forest": fmeta,
        "plan": _plan_records(pred),
    }
    if extra:
        header.update(extra)
    _write_npz(path, header, arrays)


def load_predictor(path: PathLike, *, device=None,
                   return_header: bool = False):
    """Rebuild a compiled predictor from a packed artifact on ``device``
    (``None`` → the card) — no recompilation: the saved arrays become the
    engine's buffers as they are, so load-to-first-prediction skips mask
    construction and leaf packing.  Predictions are bit-identical to the
    saved predictor's.  Artifacts the reference wrote (``jax`` backend)
    load as the port's ``torch`` engines."""
    from ..core.registry import resolve_device
    device = resolve_device(device)
    header, npz = _read_npz(path)
    if header.get("kind") == "cascade":
        pred = _load_cascade(header, npz, path, device)
        return (pred, header) if return_header else pred
    if header.get("kind") != "predictor":
        raise ValueError(f"{path!r} holds a {header.get('kind')!r} "
                         "artifact, not a predictor (use load_forest)")
    spec = _spec_for_header(header)
    forest = _unpack_forest(header["forest"], npz, prefix="f.") \
        if header.get("forest") is not None else None
    compiled = _rebuild_compiled(spec, header["scalars"], npz, forest,
                                 device)
    pred = spec.predictor_cls(compiled, spec.evaluate)
    pred.plan = _restored_plan(spec, device, header, path)
    return (pred, header) if return_header else pred


# --------------------------------------------------------------------------- #
# Autotuner cost-model artifact (docs/AUTOTUNE.md)
# --------------------------------------------------------------------------- #
COSTMODEL_FORMAT = "repro.costmodel"
COSTMODEL_VERSION = 1


def save_cost_model(path: PathLike, payload: dict) -> str:
    """Write a trained autotuner cost model as versioned JSON, the same
    contract as the packed container: a format marker plus a version this
    reader refuses to exceed.  ``payload`` is the model's own
    serialization — this layer owns only the envelope."""
    path = os.fspath(path)
    doc = {"format": COSTMODEL_FORMAT, "version": COSTMODEL_VERSION,
           **payload}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)
    return path


def load_cost_model(path: PathLike) -> dict:
    """Read a ``save_cost_model`` artifact, rejecting unknown formats and
    newer versions loudly."""
    path = os.fspath(path)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise ValueError(
            f"{path!r} is not a readable cost model: {e}") from e
    if not isinstance(doc, dict) or doc.get("format") != COSTMODEL_FORMAT:
        raise ValueError(
            f"{path!r}: unknown cost-model format "
            f"{doc.get('format') if isinstance(doc, dict) else doc!r} "
            f"(expected {COSTMODEL_FORMAT})")
    if int(doc.get("version", -1)) > COSTMODEL_VERSION:
        raise ValueError(
            f"{path!r} is cost-model version {doc['version']}, newer than "
            f"this reader (max {COSTMODEL_VERSION}) — upgrade first")
    return doc


# --------------------------------------------------------------------------- #
# Multi-tenant serving manifest
# --------------------------------------------------------------------------- #
MANIFEST_FORMAT = "repro.tenants"
MANIFEST_VERSION = 1


def save_manifest(path: PathLike, tenants: dict) -> str:
    """Write a multi-tenant serving manifest (plain JSON, versioned like
    the packed container): model id → ``{"artifact": <relative path>,
    "max_batch", "max_wait_ms", "slo"}``.  The artifacts are ordinary
    packed predictor/cascade files stored next to the manifest."""
    path = os.fspath(path)
    for tid, e in tenants.items():
        if not isinstance(e, dict) or "artifact" not in e:
            raise ValueError(f"manifest entry for {tid!r} must be a dict "
                             f"with an 'artifact' path, got {e!r}")
    doc = {"format": MANIFEST_FORMAT, "version": MANIFEST_VERSION,
           "tenants": tenants}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return path


def load_manifest(path: PathLike) -> dict:
    """Read a ``save_manifest`` file (or the directory holding a
    ``manifest.json``); returns model id → entry with the ``artifact``
    path resolved relative to the manifest's directory.  Malformed or
    newer-versioned manifests are rejected loudly."""
    path = os.fspath(path)
    if os.path.isdir(path):
        path = os.path.join(path, "manifest.json")
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise ValueError(f"{path!r} is not a readable manifest: {e}") from e
    if not isinstance(doc, dict) or doc.get("format") != MANIFEST_FORMAT:
        raise ValueError(f"{path!r}: unknown manifest format "
                         f"{doc.get('format') if isinstance(doc, dict) else doc!r} "
                         f"(expected {MANIFEST_FORMAT})")
    if int(doc.get("version", -1)) > MANIFEST_VERSION:
        raise ValueError(
            f"{path!r} is manifest version {doc['version']}, newer than "
            f"this reader (max {MANIFEST_VERSION}) — upgrade first")
    tenants = doc.get("tenants")
    if not isinstance(tenants, dict) or not tenants:
        raise ValueError(f"{path!r} holds no tenants")
    base = os.path.dirname(os.path.abspath(path))
    out = {}
    for tid, e in tenants.items():
        if not isinstance(e, dict) or "artifact" not in e:
            raise ValueError(f"{path!r}: malformed entry for {tid!r}")
        e = dict(e)
        if not os.path.isabs(e["artifact"]):
            e["artifact"] = os.path.join(base, e["artifact"])
        out[tid] = e
    return out
