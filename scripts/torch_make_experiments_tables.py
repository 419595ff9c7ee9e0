"""Markdown tables of the port's dry run: the §Dry-run table of every mesh
and the §Roofline table, from the records ``python -m
repro_torch.launch.dryrun`` writes to ``experiments/dryrun_torch/*.json``
(``scripts/make_experiments_tables.py`` renders the reference's).  Output
goes to stdout.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --kv-quant
    python scripts/torch_make_experiments_tables.py [--dir DIR]

The port traces a ``Trainer(mesh=)`` step (or a serving step) as one rank
of a fake world on meta tensors, with H100 datasheet rates: FLOPs and
unfused bytes per rank, collective bytes over a link, arguments plus
temporaries against a card's 80 GiB.  Every record gets one row in its
mesh's table with its status (``ok``, ``skipped`` with the reason, or
``error`` with the message); a cell of an architecture and shape the
mesh runs with no record shows as MISSING.  ``--kv-quant`` records carry
the mesh ``single__kvq8`` / ``multi__kvq8``.
"""
import argparse
import glob
import json
import os

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                   "experiments", "dryrun_torch")

ARCHS = ["chameleon_34b", "smollm_360m", "phi3_mini_3_8b",
         "command_r_plus_104b", "starcoder2_3b", "phi3_5_moe_42b",
         "grok_1_314b", "seamless_m4t_large_v2", "jamba_1_5_large_398b",
         "mamba2_370m"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
# (mesh name in a record, title, the shapes it runs)
MESHES = [
    ("single", "Single-pod 16×16 (256 ranks)", SHAPES),
    ("single__kvq8", "Single-pod 16×16 (256 ranks), int8 KV cache",
     ["decode_32k", "long_500k"]),
    ("multi", "Multi-pod 2×16×16 (512 ranks)", SHAPES),
    ("multi__kvq8", "Multi-pod 2×16×16 (512 ranks), int8 KV cache",
     ["decode_32k", "long_500k"]),
]
COUNTS = ("all_gather", "reduce_scatter", "all_reduce", "all_reduce_max",
          "all_to_all")
GIB = 2 ** 30


def load(directory: str = DIR) -> dict:
    """{(arch, shape, mesh): record} of every ``*.json`` in ``directory``."""
    recs = {}
    for fn in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(fn) as f:
            r = json.load(f)
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    return f"{x * 1e3:.1f}ms"


def _cells(recs: dict, mesh: str, shapes) -> list:
    """(arch, shape) of every cell of ``mesh``'s table: the architectures
    and shapes the mesh runs, then any other a record holds."""
    cells = [(a, s) for a in ARCHS for s in shapes]
    extra = sorted((a, s) for a, s, m in recs
                   if m == mesh and (a, s) not in cells)
    return cells + extra


def dryrun_table(recs: dict, mesh: str, title: str, shapes) -> None:
    print(f"\n### {title}\n")
    print("| arch | shape | status | accum | traced GFLOP/rank "
          "| unfused GB/rank | coll GB (link) "
          "| AG/RS/AR/AR-max/A2A counts | args + temps GiB |")
    print("|---|---|---|---|---|---|---|---|---|")
    for a, s in _cells(recs, mesh, shapes):
        r = recs.get((a, s, mesh))
        if r is None:
            print(f"| {a} | {s} | MISSING | | | | | | |")
            continue
        if r["status"] == "skipped":
            print(f"| {a} | {s} | skipped ({r.get('reason', '')}) "
                  f"| | | | | | |")
            continue
        if r["status"] != "ok":
            msg = str(r.get("error", "")).splitlines()[:1]
            print(f"| {a} | {s} | {r['status']} ({''.join(msg)[:120]}) "
                  f"| | | | | | |")
            continue
        c = r["collectives"]["counts"]
        cts = "/".join(str(c.get(k, 0)) for k in COUNTS)
        m = r["memory"]
        peak = m["argument_size_in_bytes"] + m["temp_size_in_bytes"]
        print(f"| {a} | {s} | ok | {r.get('accum_steps', 1)} "
              f"| {r['hlo_flops'] / 1e9:,.0f} "
              f"| {r['hlo_bytes'] / 1e9:,.1f} "
              f"| {r['collectives']['link_bytes'] / 1e9:,.1f} "
              f"| {cts} | {peak / GIB:,.2f} |")


def roofline_table(recs: dict, mesh: str, shapes) -> None:
    print(f"\n#### {mesh}\n")
    print("| arch | shape | compute | memory | collective | dominant "
          "| MODEL_GFLOP/rank | useful ratio | fits 80 GiB (traced) "
          "| fits 16 GB (analytic) |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for a, s in _cells(recs, mesh, shapes):
        r = recs.get((a, s, mesh))
        if r is None or r["status"] != "ok":
            continue
        rl = r["roofline"]
        am = r.get("analytic_memory", {})
        print(f"| {a} | {s} | {fmt_s(rl['compute_s'])} "
              f"| {fmt_s(rl['memory_s'])} | {fmt_s(rl['collective_s'])} "
              f"| {rl['dominant'].replace('_s', '')} "
              f"| {r['model_flops_per_chip'] / 1e9:,.0f} "
              f"| {r.get('useful_flop_ratio', 0):.2f} "
              f"| {'yes' if r.get('fits_80gib') else 'NO'} "
              f"| {'yes' if am.get('fits_16gb') else 'NO'} "
              f"({am.get('total', 0) / 1e9:.1f}GB) |")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=DIR,
                    help="directory of dry-run records (default: "
                         "experiments/dryrun_torch)")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    status = {}
    for r in recs.values():
        status[r["status"]] = status.get(r["status"], 0) + 1
    print(f"<!-- generated by scripts/torch_make_experiments_tables.py: "
          f"{status.get('ok', 0)} ok / {status.get('skipped', 0)} skipped "
          f"/ {status.get('error', 0)} errors -->")
    print("\n## §Dry-run (the port: traced on meta tensors, H100 rates)")
    for mesh, title, shapes in MESHES:
        dryrun_table(recs, mesh, title, shapes)
    print("\n## §Roofline (single-pod, per rank per step)")
    for mesh, _, shapes in MESHES[:2]:
        roofline_table(recs, mesh, shapes)
    return status


if __name__ == "__main__":
    main()
