"""Fault-tolerance demo on the PyTorch/CUDA port: train → lose half the
hosts → elastic restart with gradient accumulation → the same loss
trajectory — ``examples/elastic_restart.py`` step for step over
``repro_torch``.

    PYTHONPATH=src python examples/torch_elastic_restart.py
    PYTHONPATH=src python examples/torch_elastic_restart.py --device cpu

The first runs on the card (and raises without one), the second on the
CPU.

Simulates the production flow in one process: the "big" job (DP=2 in
spirit) checkpoints; a failure survey finds one host dead;
``plan_elastic_restart`` shrinks DP and doubles accumulation; the "small"
job restores and continues.  Its losses stay within 1e-3 (relative) of
the uninterrupted run's, because the global batch and the (seed,
step)-keyed data stream do not change.
"""
import argparse
import tempfile

from repro_torch.configs import get_config
from repro_torch.core import resolve_device
from repro_torch.distributed.fault_tolerance import (Heartbeat,
                                                     plan_elastic_restart)
from repro_torch.launch.train import Trainer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4,
                    help="the global batch")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config("smollm_360m").reduced()
    with tempfile.TemporaryDirectory(prefix="repro_torch_elastic_") as ckpt:
        hb_dir = ckpt + "/hb"

        # --- phase 1: the "2-host" job runs 3 steps and checkpoints ---- #
        big = Trainer(cfg, batch=args.batch, seq_len=args.seq_len,
                      accum_steps=1, device=device)
        big.init_state()
        big_losses = []
        for _ in range(3):
            rec = big.train_step()
            for host in (0, 1):
                Heartbeat(hb_dir, host).beat(rec["step"])
            big_losses.append(rec["loss"])
            print(f"[big]   step {rec['step']} loss {rec['loss']:.4f}")
        big.save(ckpt)

        # reference: what the uninterrupted job would do next
        ref = [big.train_step()["loss"] for _ in range(3)]

        # --- phase 2: host 1 dies; survey + plan ----------------------- #
        Heartbeat(hb_dir, 0).beat(3)                  # host 0 still alive
        survey = Heartbeat.survey(hb_dir, timeout_s=1e9)
        survey[1]["alive"] = False                    # simulated failure
        alive = [h for h, rec in survey.items() if rec["alive"]]
        plan = plan_elastic_restart(alive, total_hosts=2, dp_size=2,
                                    global_batch=args.batch)
        print(f"[plan]  survivors={alive} → dp={plan.dp_size} "
              f"accum={plan.accum_steps} global_batch={plan.global_batch} "
              f"dropped={plan.dropped_hosts}")

        # --- phase 3: shrunken job restores and continues -------------- #
        small = Trainer(cfg, batch=plan.global_batch, seq_len=args.seq_len,
                        accum_steps=plan.accum_steps, device=device)
        step = small.restore(ckpt)
        print(f"[small] restored at step {step}")
        got = []
        for _ in range(3):
            rec = small.train_step()
            got.append(rec["loss"])
            print(f"[small] step {rec['step']} loss {rec['loss']:.4f}")

    err = max(abs(a - b) / abs(a) for a, b in zip(ref, got))
    print(f"[check] max relative deviation from uninterrupted run: "
          f"{err:.2e} (must be ≈ float tolerance) on {device}")
    assert err < 1e-3
    print("[check] elastic restart preserved the loss trajectory ✓")
    return {"device": str(device), "big_losses": big_losses,
            "uninterrupted": ref, "restarted": got, "restored_step": step,
            "plan": {"dp_size": plan.dp_size,
                     "accum_steps": plan.accum_steps,
                     "global_batch": plan.global_batch,
                     "dropped_hosts": list(plan.dropped_hosts)},
            "max_rel_dev": err}


if __name__ == "__main__":
    main()
