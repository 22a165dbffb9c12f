"""Training driver CLI: the port of ``repro.launch.train``.

Runs the training loop of the paper's main path on one device: seeded
random params, ``SyntheticLM`` batches, ``make_train_step`` with global-norm
clipping and the optimizer's fused in-place write. It prints a loss line
every ``--log-every`` steps, the only place it reads a value back to the
host. It runs on the card (``--device cuda``, the default) unless told
``--device cpu``, and raises without a card.

The JAX launcher's anomaly guard is on by default; this one runs as
``--no-guard`` would there, and says so on its first line. Flags of
modules not ported yet are absent:

* ``--smoke`` (the reduced smoke configs), ``--tie-embeddings``
  (ROADMAP.md Queue 1 item 7);
* ``--pack-documents`` (item 6);
* ``--ckpt-dir``, ``--ckpt-every``, ``--resume`` (item 5);
* ``--no-guard``, ``--spike-factor``, ``--spike-warmup``,
  ``--max-bad-steps``, ``--rollback-lr-cut``, ``--max-rollbacks`` (the
  guard and rollback, item 9);
* ``--log-dir``, ``--metrics-every``, ``--stats-every``,
  ``--profile-steps``, ``--profile-dir`` (telemetry, item 10).

Example (llama-1b on the card, the paper's largest Table-1 model):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama-1b \\
      --optimizer scale_fused --steps 20 --batch 16 --seq 256
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.core import linear_warmup_cosine, make_optimizer
from repro_torch.data import make_dataset
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.training import init_state, make_train_step


def build(args):
    """(cfg, tx) for the run: the JAX launcher's ``build`` on its untied
    branch (the port's kernels choose their own tiles, so the attention
    block and loss-chunk settings it adjusts have no counterpart)."""
    cfg = get_arch(args.arch)
    if args.dtype:
        cfg.dtype = args.dtype
    sched = linear_warmup_cosine(args.lr, args.steps)
    return cfg, make_optimizer(args.optimizer, sched)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-130m")
    ap.add_argument("--optimizer", default="scale")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--clip-norm", type=float, default=1.0)
    ap.add_argument("--dtype", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back on its own")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg, tx = build(args)
    print(f"arch={cfg.name} optimizer={args.optimizer} device={device} "
          "guard=off (the anomaly guard is not ported: ROADMAP.md Queue 1 "
          "item 9)", flush=True)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=device)
    state = init_state(params, tx)
    ds = make_dataset(cfg, seq_len=args.seq, global_batch=args.batch,
                      seed=args.seed, device=device)
    step_fn = make_train_step(cfg, tx, grad_accum=args.grad_accum,
                              clip_norm=args.clip_norm)

    t0 = time.time()
    tokens_per_step = args.batch * args.seq
    metrics = {"loss": torch.tensor(float("nan"))}
    for step in range(args.steps):
        state, metrics = step_fn(state, ds.host_batch_at(step))
        done = step + 1
        if done % args.log_every == 0 or done == 1:
            tput = done * tokens_per_step / max(time.time() - t0, 1e-9)
            print(f"step {done:6d} loss {float(metrics['loss']):.4f} "
                  f"|g| {float(metrics['grad_norm']):.3f} tok/s {tput:,.0f}",
                  flush=True)
    print(f"done: final loss {float(metrics['loss']):.4f}", flush=True)
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
