"""End-to-end LM training on the PyTorch/CUDA port: a smollm-family model
for a few hundred steps, with checkpointing and fault-tolerance hooks —
``examples/train_lm.py`` step for step over ``repro_torch``, with the
same ``Trainer`` class the production mesh uses.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --steps 300 --device cpu

The first runs on the card (and raises without one), the second on the
CPU.

By default this trains a width-reduced smollm (~14M params);
``--full-100m`` trains the ~100M variant (smollm's shape, 8 layers).  The
step runs ``Model(backend="torch")`` in bf16 (training launches no
hand-written kernel: ``flash_forward`` has no backward).  Checkpoints go
to ``--ckpt-dir`` (default ``repro_torch_train_lm`` in the temporary
directory, e.g. ``/tmp/repro_torch_train_lm``); a directory that already
holds a checkpoint is resumed from it, so pass a fresh one to train anew.
"""
import argparse
import dataclasses
import os
import tempfile
import time

from repro_torch.configs import get_config
from repro_torch.core import resolve_device
from repro_torch.launch.train import Trainer, run_loop


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config("smollm_360m")
    if args.full_100m:
        # ~100M params: keep smollm's shape, trim depth
        cfg = dataclasses.replace(cfg, n_layers=8, name="smollm-100m")
    else:
        cfg = dataclasses.replace(
            cfg.reduced(), n_layers=4, d_model=256, n_heads=4, n_kv=2,
            head_dim=64, d_ff=1024, vocab=8192, name="smollm-14m")

    n = cfg.param_count()
    print(f"[example] {cfg.name}: {n / 1e6:.1f}M params, "
          f"{args.steps} steps @ batch={args.batch} seq={args.seq_len} on "
          f"{device}")

    trainer = Trainer(cfg, batch=args.batch, seq_len=args.seq_len,
                      lr=args.lr, remat=False, device=device)
    t0 = time.time()
    records = run_loop(trainer, steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=100, log_every=20,
                       hb_dir=args.ckpt_dir + "/hb")
    dt = time.time() - t0
    first = sum(r["loss"] for r in records[:10]) / max(len(records[:10]), 1)
    last = sum(r["loss"] for r in records[-10:]) / max(len(records[-10:]), 1)
    print(f"[example] done in {dt:.0f}s — loss {first:.3f} → {last:.3f} "
          f"(must decrease); ckpt at {args.ckpt_dir}")
    assert last < first, "training did not reduce the loss"
    return {"device": str(device), "config": cfg.name, "params": n,
            "steps": len(records), "wall_s": dt, "loss_first10": first,
            "loss_last10": last, "final_step": trainer.step,
            "ckpt_dir": args.ckpt_dir}


if __name__ == "__main__":
    main()
