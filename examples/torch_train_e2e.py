"""End-to-end training example on the PyTorch port: train a ~100M-parameter
dense LM on synthetic Zipf-Markov data, with checkpointing and restart.

Trains on the card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it raises.  ``--restart-demo`` drops the trainer
at ``--restart-at`` (default 100) and resumes a new one from its
checkpoint:

    python examples/torch_train_e2e.py [--steps 300] [--restart-demo] [--device cpu]
"""

import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import tempfile

from repro_torch.models.api import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.counting import count_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import Trainer

# ~100M params: a llama-family stack scaled to laptop size
CFG_100M = ModelConfig(
    name="demo-100m", family="dense", num_layers=12, d_model=512,
    num_heads=8, num_kv_heads=4, d_ff=2048, vocab_size=50304,
    dtype="float32", param_dtype="float32", remat="none",
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "ham_torch_train_e2e"))
    ap.add_argument("--restart-demo", action="store_true")
    ap.add_argument("--restart-at", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = CFG_100M
    n = count_params(cfg)
    print(f"model: {cfg.name}  {cfg.num_layers} layers  N={n/1e6:.1f}M params "
          f"on {device.type}")

    def trainer():
        return Trainer(cfg, AdamWConfig(lr=3e-4, warmup_steps=50),
                       ckpt_dir=args.ckpt_dir, ckpt_every=50,
                       global_batch=args.global_batch, seq_len=args.seq_len,
                       device=device)

    tr = trainer()
    if not tr.maybe_restore():
        tr.init()
        print("fresh start")
    else:
        print(f"restored from step {tr.step}")

    while tr.step < args.steps:
        m = tr.run_steps(args.log_every)
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"gnorm {m['grad_norm']:.3f}  lr {m['lr']:.2e}  "
              f"({args.log_every / m['wall_s']:.2f} it/s)")
        if args.restart_demo and tr.step == args.restart_at:
            print(">> simulating failure: dropping trainer, restoring from ckpt")
            tr.checkpoint(blocking=True)
            tr = trainer()
            if not tr.maybe_restore():
                raise RuntimeError(f"no checkpoint to restore from in {args.ckpt_dir}")
            print(f">> resumed at step {tr.step}")

    tr.checkpoint(blocking=True)
    print(f"final loss: {tr.latest_metrics()['loss']} at step {tr.step}")


if __name__ == "__main__":
    main()
