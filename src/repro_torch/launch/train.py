"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        --smoke --steps 100 --ckpt CKPT_DIR [--device cpu]

The port of ``repro.launch.train``: the same flags plus ``--device``
(default ``cuda``, which raises without a GPU).  ``--smoke`` runs the
reduced config; checkpoint/restart and straggler mitigation come from the
fault-tolerant loop in ``repro_torch.train.trainer``.  Prints the
reference's line ``arch=... resumed_from=... first_loss=... last_loss=...``.
"""

from __future__ import annotations

import argparse

from ..configs import get_config, reduce_for_smoke
from ..train.trainer import TrainLoopConfig, run_training

__all__ = ["parse_args", "main"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=TrainLoopConfig().ckpt_dir)
    ap.add_argument("--ckpt-interval", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    loop = TrainLoopConfig(steps=args.steps, batch=args.batch, seq=args.seq,
                           ckpt_dir=args.ckpt,
                           ckpt_interval=args.ckpt_interval, lr=args.lr)
    _, losses, resumed = run_training(cfg, loop, device=args.device)
    print(f"arch={cfg.name} resumed_from={resumed} "
          f"first_loss={losses[0]:.4f} last_loss={losses[-1]:.4f}")
    return {"arch": cfg.name, "resumed_from": resumed, "losses": losses}


if __name__ == "__main__":
    main()
