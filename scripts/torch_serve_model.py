"""Serve an externally trained model file end to end through the port.

    PYTHONPATH=src python scripts/torch_serve_model.py --model model.json
    PYTHONPATH=src python scripts/torch_serve_model.py \
        --model forest.repro.npz --save server.pred.npz --device cpu
    PYTHONPATH=src python scripts/torch_serve_model.py --model server.pred.npz

``--model`` accepts any format ``repro_torch.io`` understands: an XGBoost
JSON dump, a LightGBM ``dump_model`` JSON, a sklearn-shim JSON, a packed
``.repro.npz`` forest — or a packed *predictor/server* artifact (the
port's or the reference's), which cold-starts without autotuning or
recompiling.  ``--save`` writes the autotuned compiled artifact so the
next start takes the cold path (a ``torch``-engine winner only: a
``cuda`` predictor is never saved, so on the card pin ``--engine`` to a
torch engine, e.g. ``qs``, to save).  ``--explain`` prints the served
predictor's ``plan.describe()`` — every pipeline pass including the
optimizer's per-pass stats; ``--opt 2`` adds ``@O2`` optimizer
candidates to the autotune sweep.  Everything runs on the card unless
``--device cpu`` asks for the CPU.
"""
import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", required=True,
                    help="model file (XGB/LGBM/shim JSON or .repro.npz)")
    ap.add_argument("--engine", default=None,
                    help="pin one autotuner engine, e.g. qs or cuda-qs "
                         "(default: sweep)")
    ap.add_argument("--batch", type=int, default=64,
                    help="serving max_batch (autotune batch bucket)")
    ap.add_argument("--n-classes", type=int, default=1,
                    help="multiclass round-robin width for XGBoost dumps")
    ap.add_argument("--save", default=None,
                    help="write the compiled server artifact here")
    ap.add_argument("--n-requests", type=int, default=256,
                    help="synthetic requests to stream through the server")
    ap.add_argument("--opt", default=None,
                    help="optimizer level for the autotune sweep "
                         "(e.g. 2 → adds @O2 candidates)")
    ap.add_argument("--explain", action="store_true",
                    help="print the served predictor's compile plan "
                         "(pipeline passes incl. optimizer stats)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch import io
    from repro_torch.inference.server import ForestServer

    t0 = time.perf_counter()
    header_kind = None
    if args.model.endswith(".npz"):
        header_kind = io.peek(args.model).get("kind")
    if header_kind in ("predictor", "cascade"):
        srv = ForestServer.load(args.model, device=args.device)
        # host_forest, not compiled.forest: rapidscorer nests the IR
        forest = srv.predictor.host_forest()
        print(f"[serve] cold start from compiled artifact "
              f"(engine_choice={srv.engine_choice})")
    else:
        kw = {"n_classes": args.n_classes} if args.n_classes > 1 else {}
        forest = io.load_model(args.model, **kw)
        print(f"[serve] imported forest: T={forest.n_trees} "
              f"L={forest.n_leaves} C={forest.n_classes} "
              f"d={forest.n_features}")
        engines = (args.engine,) if args.engine else None
        opt_levels = (args.opt,) if args.opt is not None else None
        srv = ForestServer.from_forest(forest, max_batch=args.batch,
                                       device=args.device, engines=engines,
                                       opt_levels=opt_levels, repeats=1)
        print(f"[serve] autotuned engine: {srv.engine_choice.engine} "
              f"(cached: {srv.engine_choice.from_cache})")
    # n_features_in, not n_features: an optimizer feat_map keeps the
    # serving interface full-width even after dropped columns
    d = getattr(forest, "n_features_in", forest.n_features)
    if args.explain:
        plan = getattr(srv.predictor, "plan", None)
        print("[serve] compile plan: "
              + (plan.describe() if plan is not None
                 else "unavailable (predictor built outside the pipeline)"))
    X1 = np.zeros((1, d))
    srv.predictor.predict(X1)                      # first prediction
    print(f"[serve] load-to-first-prediction: "
          f"{time.perf_counter() - t0:.3f}s on {srv.predictor.device}")

    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.exponential(1e-4, size=args.n_requests))
    for at in arrivals:
        srv.submit(rng.normal(size=d), arrival_s=float(at))
        srv.poll(now_s=float(at))
    srv.flush(now_s=float(arrivals[-1]))
    s = srv.stats.summary()
    print(f"[serve] {s['n_requests']} requests in {s['n_batches']} batches "
          f"(mean batch {s['mean_batch']:.1f}) "
          f"p50={s['p50_ms']:.2f}ms p99={s['p99_ms']:.2f}ms")

    if args.save:
        srv.save(args.save)
        print(f"[serve] compiled server artifact → {args.save}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
