"""Training driver CLI: the port of ``repro.launch.train``.

Runs the training loop of the paper's main path: seeded random params,
``SyntheticLM`` batches, ``make_train_step`` with global-norm clipping and
the optimizer's fused in-place write. It runs on the card (``--device
cuda``, the default) unless told ``--device cpu``, and raises without a
card.

Sharded training: under ``torchrun --nproc-per-node N -m
repro_torch.launch.train ...`` (the world from its environment:
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``)
the launcher starts the process group (NCCL on the card, gloo on the CPU;
each rank on ``cuda:LOCAL_RANK``), builds ``make_host_mesh(data=world)``
and places the parameters per the rules, as the JAX launcher places them
on its devices. Every rank builds the global batch from the seed and the
step takes its data shard. Rank 0 alone prints, writes the metrics
records (one ``metrics.0.jsonl``, as JAX's one process writes) and writes
the checkpoints, which hold the full tensors (bitwise those an unsharded
run would write at the same values); every rank restores them into its
layout. With one rank there is no mesh and the path is the single-device
one.

Resilience, as in the JAX launcher: the step runs under the anomaly guard
(:mod:`repro_torch.training.resilience`, on unless ``--no-guard``): a
non-finite loss or gradient norm, or a loss spike past ``--spike-factor``
times the accepted-loss EMA, skips the update bitwise; after
``--max-bad-steps`` consecutive bad steps the launcher rolls back to the
last verifiable checkpoint and cuts the peak LR by ``--rollback-lr-cut``
(rebuilding the step), and gives up after ``--max-rollbacks``. With
``--ckpt-dir`` it checkpoints every ``--ckpt-every`` steps
(:mod:`repro_torch.checkpoint`, one asynchronous save in flight) and at
the end; ``--resume auto`` continues from the newest verifiable
checkpoint. SIGTERM finishes the current step, writes a final synchronous
checkpoint and exits 0, so a preempted run under ``--resume auto`` loses
at most that step. ``REPRO_FAULTS`` (:mod:`repro_torch.training.faults`:
``nan_grad@K``, ``inf_grad@K``, ``io_error@save|commit:N``,
``kill@save|commit:N``, ``dispatch_fail@OP``) injects deterministic
faults into all of it; it is read once, at start.

The console shows ``step N loss L |g| G tok/s T skipped S rollbacks R``
every ``--log-every`` steps; with the guard on, the loop reads the step's
``rollback`` flag back every step (as the JAX launcher does), elsewhere
only the loss lines read the device.

``--tie-embeddings`` ties the LM head to the token embedding (no
``lm_head``; the loss reads the (V, D) embedding in place through the
transposed xent kernels), and an optimizer that takes label rules (SCALE)
gets ``LabelRules.tied()``, so that its momentum moves to the tied matrix.

``--pack-documents`` trains on first-fit packed multi-document rows
(``SyntheticLM(pack_documents=True)``): the batches carry
``segment_ids``, ``positions`` and ``loss_weights``, attention keeps to
each document (the kernels' segment clause) and so does the loss. The
console's tok/s then counts the loss's weight, the real tokens, and not
batch x seq.

Telemetry, as in the JAX launcher (:mod:`repro_torch.obs`): ``--log-dir``
attaches a JSONL metrics sink (schema ``repro_metrics/v1``,
``metrics.0.jsonl``, rank 0's) behind the non-blocking background
logger. It writes a ``run_header``, a ``train_step`` record on the first
step and every ``--metrics-every`` steps (the step's metrics, the
step-time breakdown since the last record: ``data`` wait, ``step``
dispatch, ``sync`` for the guard's flag, ``ckpt`` IO; the card's live and
peak bytes, tokens/s (real tokens when packed), ``lr_scale`` and
``rollbacks``), an ``event`` on each rollback (then a flush), and a
``run_end``; SIGTERM and the end of the run flush it. A record reads the
device only on that cadence. ``--stats-every K`` adds the per-layer-group
statistics of :mod:`repro_torch.obs.stats` (the paper's Fig. 4/10
quantities) to the steps whose completed index is a multiple of K, and
the records of those steps carry them. ``--profile-steps A:B`` wraps
those steps in a ``torch.profiler`` window whose Chrome trace lands in
``--profile-dir`` (default ``<log-dir>/profile``); a profiler failure
warns and disables the window. The port has no kernel fallback
(ROADMAP.md reference caveat 9): records carry no ``fallbacks`` deltas
and ``run_end`` has ``fallbacks: null``.

``--arch`` takes the paper's LLaMA sizes, its Appendix F extras and the
``ARCH_IDS`` configurations (qwen2-7b, granite-3-8b, deepseek-67b,
mistral-large-123b, the MoE dbrx-132b, the MLA + MoE deepseek-v3-671b,
the Mamba2 mamba2-370m, the hybrid jamba-1.5-large-398b, the VLM
llama-3.2-vision-11b, whose batches carry f32 image embeddings, and the
audio musicgen-medium, whose tokens are 4 codebooks); ``--smoke`` takes
an ``ARCH_IDS`` configuration's reduced twin (2 to 8 layers, narrow,
f32), which runs on the CPU too.

``--optimizer`` takes any name of ``repro_torch.core.OPTIMIZER_NAMES``,
the JAX registry's 20: SCALE (``scale``, ``scale_fused``, ``adapm``) and
the paper's baselines (``sgd``, ``sgd_momentum``, ``adam``, ``adamw``,
``adams``, ``stable_spam``, ``muon``, ``swan``, ``galore``, ``fira``,
``apollo``, ``apollo_mini``, ``sgd_{col,row,sign,ns,svd}norm``), each with
its registry defaults.

Examples (llama-1b on the card, the paper's largest Table-1 model):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama-1b \\
      --optimizer scale_fused --steps 20 --batch 16 --seq 256 \\
      --ckpt-dir /path/to/ckpt --ckpt-every 10 --resume auto
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama-1b \\
      --tie-embeddings --optimizer scale_fused --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama-1b \\
      --pack-documents --optimizer scale_fused --steps 20
  REPRO_FAULTS="nan_grad@5" PYTHONPATH=src python -m \\
      repro_torch.launch.train --arch llama-1b --optimizer muon --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama-1b \\
      --optimizer scale_fused --steps 200 --log-dir /path/to/run0 \\
      --metrics-every 10 --stats-every 50 --profile-steps 20:21
  PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx-132b \\
      --smoke --device cpu --steps 8 --batch 4 --seq 32 --log-every 1
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
      --smoke --device cpu --steps 8 --batch 4 --seq 32 --log-every 1
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch jamba-1.5-large-398b --smoke --device cpu --steps 8 \\
      --batch 4 --seq 32 --log-every 1
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch llama-3.2-vision-11b --smoke --device cpu --steps 8 \\
      --batch 4 --seq 32 --log-every 1
  PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-medium \\
      --smoke --device cpu --steps 8 --batch 4 --seq 32 --log-every 1
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch llama-3.2-vision-11b --optimizer scale_fused --batch 4 \\
      --seq 1024 --steps 3
"""
from __future__ import annotations

import argparse
import os
import signal
import time

import torch

from repro_torch.checkpoint import restore_latest, save, save_async
from repro_torch.configs import get_arch
from repro_torch.core import (OPTIMIZER_REGISTRY, LabelRules,
                              linear_warmup_cosine, make_optimizer)
from repro_torch.core.pipeline import HostCount
from repro_torch.data import make_dataset
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import init_params
from repro_torch.models.model import place_params
from repro_torch.models.sharding import Rules
from repro_torch.obs import (JSONLSink, MetricsLogger, ProfileWindow,
                             StatsPolicy, StepTimer, device_memory,
                             split_stats, trace_span)
from repro_torch.training import (GuardPolicy, init_guard_state, init_state,
                                  make_train_step, resolve_plan)


def build(args, lr_scale: float = 1.0):
    """(cfg, tx) for the run: the JAX launcher's ``build`` (the port's
    kernels choose their own tiles, so the attention block and loss-chunk
    settings it adjusts have no counterpart). ``lr_scale`` scales the peak
    LR (the rollback cut). A tied model gives ``LabelRules.tied()`` to an
    optimizer whose factory takes ``rules`` (SCALE would raise without
    them: a tied tree has no lm_head to carry the momentum); the others
    treat every matrix alike and get nothing, as in JAX."""
    cfg = get_arch(args.arch, smoke=args.smoke)
    if args.dtype:
        cfg.dtype = args.dtype
    if args.tie_embeddings:
        cfg.tie_embeddings = True
    sched = linear_warmup_cosine(args.lr * lr_scale, args.steps)
    spec = OPTIMIZER_REGISTRY.get(args.optimizer.lower())
    if (cfg.tie_embeddings and spec is not None
            and "rules" in spec.valid_kwargs()):
        return cfg, make_optimizer(args.optimizer, sched,
                                   rules=LabelRules.tied())
    return cfg, make_optimizer(args.optimizer, sched)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-130m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config for --arch")
    ap.add_argument("--optimizer", default="scale")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--pack-documents", dest="pack_documents",
                    action="store_true",
                    help="first-fit pack variable-length documents into "
                         "each (batch, seq) row; batches gain segment_ids "
                         "/ positions / loss_weights and attention + loss "
                         "stay within document boundaries")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--clip-norm", type=float, default=1.0)
    ap.add_argument("--dtype", default="")
    ap.add_argument("--tie-embeddings", dest="tie_embeddings",
                    action="store_true",
                    help="tie the LM head to the token embedding (no "
                         "lm_head params; SCALE momentum moves to the "
                         "tied matrix)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", default="none", choices=["none", "auto"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--log-dir", default="",
                    help="write schema-versioned JSONL metrics records "
                         "(metrics.0.jsonl) under this directory via the "
                         "non-blocking background logger")
    ap.add_argument("--metrics-every", type=int, default=10,
                    help="JSONL record cadence in steps (needs --log-dir)")
    ap.add_argument("--stats-every", type=int, default=0,
                    help="cadence of the per-layer-group gradient "
                         "statistics (Fig. 4/10 live: grad norms, column-"
                         "norm dispersion, update/param ratios, momentum "
                         "norms); 0 disables the collector entirely")
    ap.add_argument("--profile-steps", default="",
                    help="'A:B' (inclusive) or 'A': wrap those steps in a "
                         "torch.profiler trace written to --profile-dir")
    ap.add_argument("--profile-dir", default="",
                    help="profiler trace directory (default "
                         "<log-dir>/profile)")
    ap.add_argument("--no-guard", action="store_true",
                    help="disable the anomaly guard (finite checks "
                         "on loss/grad norm, step skipping, rollback)")
    ap.add_argument("--spike-factor", type=float, default=0.0,
                    help="skip steps whose loss exceeds this multiple of "
                         "the accepted-loss EMA (0 disables the spike "
                         "check; finite checks stay on)")
    ap.add_argument("--spike-warmup", type=int, default=20,
                    help="accepted steps before the spike check arms")
    ap.add_argument("--max-bad-steps", type=int, default=10,
                    help="consecutive guard-skipped steps before rolling "
                         "back to the last checkpoint with an LR cut "
                         "(0 = never roll back, skip forever)")
    ap.add_argument("--rollback-lr-cut", type=float, default=0.5,
                    help="multiply the peak LR by this on every rollback")
    ap.add_argument("--max-rollbacks", type=int, default=3,
                    help="abort the run after this many rollbacks (a "
                         "deterministic fault replays identically after "
                         "restore, so an unbounded loop would never "
                         "terminate)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back on its own")
    args = ap.parse_args(argv)

    world, rank, started = _init_world(args.device)
    try:
        return _main(args, world, rank)
    finally:
        if started:
            torch.distributed.destroy_process_group()


def _init_world(device: str):
    """(world, rank, started): the process group from ``torchrun``'s
    environment (an existing group is used as it is); one rank without
    one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), False
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return 1, 0, False
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if cuda else "gloo")
    return world, dist.get_rank(), True


def _main(args, world: int, rank: int) -> float:
    device = resolve_device(args.device)
    if device.type == "cuda" and world > 1:
        device = torch.device("cuda", torch.cuda.current_device())
    lead = rank == 0

    def say(msg):
        if lead:
            print(msg, flush=True)

    guard = None if args.no_guard else GuardPolicy(
        spike_factor=args.spike_factor, spike_warmup=args.spike_warmup,
        max_bad_steps=args.max_bad_steps)
    faults = resolve_plan()  # REPRO_FAULTS, read once
    if faults is not None:
        say(f"fault injection active: {faults}")

    # the telemetry plane: rank 0 writes one JSONL file (host 0)
    sinks = []
    if args.log_dir and lead:
        os.makedirs(args.log_dir, exist_ok=True)
        sinks.append(JSONLSink(os.path.join(args.log_dir, "metrics.0.jsonl")))
    logger = MetricsLogger(sinks, host=0)
    profile = ProfileWindow.parse(
        args.profile_steps,
        args.profile_dir or os.path.join(args.log_dir or ".", "profile"),
        device)

    cfg, tx = build(args)
    rules = Rules(cfg.rule_overrides)
    mesh = (make_host_mesh(data=world, device_type=device.type)
            if world > 1 else None)
    stats = StatsPolicy(every_k=args.stats_every,
                        tied=cfg.tie_embeddings) \
        if args.stats_every > 0 else None
    say(f"arch={cfg.name} optimizer={args.optimizer} device={device} "
        f"guard={'off' if guard is None else 'on'}"
        + (" pack_documents=True" if args.pack_documents else "")
        + (f" stats_every={args.stats_every}" if stats else "")
        + (f" devices={world}" if world > 1 else ""))
    logger.log("run_header", 0, arch=cfg.name, optimizer=args.optimizer,
               devices=world, guard=guard is not None,
               stats_every=args.stats_every, steps=args.steps,
               batch=args.batch, seq=args.seq, lr=args.lr,
               grad_accum=args.grad_accum,
               pack_documents=bool(args.pack_documents),
               tie_embeddings=bool(cfg.tie_embeddings))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=device)
    if mesh is not None:
        params = place_params(params, cfg, mesh, rules)
    state = init_state(params, tx, guard=guard is not None)
    del params
    start_step = 0
    if args.resume == "auto" and args.ckpt_dir:
        got = restore_latest(args.ckpt_dir, state)
        if got is not None:
            state, start_step = got
            state = state._replace(host_step=HostCount(start_step))
            say(f"resumed from step {start_step}")
    ds = make_dataset(cfg, seq_len=args.seq, global_batch=args.batch,
                      seed=args.seed, pack_documents=args.pack_documents,
                      device=device)

    def make_step(tx):
        return make_train_step(cfg, tx, grad_accum=args.grad_accum,
                               clip_norm=args.clip_norm, guard=guard,
                               faults=faults, stats=stats, rules=rules,
                               mesh=mesh)

    step_fn = make_step(tx)

    # SIGTERM (a preemption notice): finish the current step, write a final
    # synchronous checkpoint, exit cleanly; --resume auto picks it up
    stop = {"sigterm": False}

    def _on_sigterm(signum, frame):
        del signum, frame
        stop["sigterm"] = True

    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # not the main thread (embedded use): no handler
        prev_handler = None

    t0 = time.time()
    pending = None
    # packed rows carry fewer real tokens than batch*seq: tok/s counts the
    # loss's weight there (its mean over the grad_accum microbatches, times
    # grad_accum), summed on the device and read with the loss line
    tokens_per_step = args.batch * args.seq
    real_tokens = torch.zeros((), dtype=torch.float64, device=device)
    step, done_steps = start_step, 0
    lr_scale, rollbacks = 1.0, 0
    metrics = {"loss": torch.tensor(float("nan"))}
    timer = StepTimer()
    last_emitted = -1

    def throughput():
        done = (float(real_tokens) if args.pack_documents
                else done_steps * tokens_per_step)
        return done / max(time.time() - t0, 1e-9)

    def emit_record(step, tput):
        """One train_step record: the step's metrics, on-cadence stats, the
        step-time breakdown since the last record, memory."""
        nonlocal last_emitted
        last_emitted = step
        plain, stat_vals = split_stats(metrics, stats)
        rec = dict(plain)
        rec.update(stat_vals)
        rec.update(timer.snapshot())
        rec.update(device_memory(device))
        rec["tokens_per_s"] = tput
        rec["lr_scale"] = lr_scale
        rec["rollbacks"] = rollbacks
        logger.log("train_step", step, rec)

    try:
        while step < args.steps and not stop["sigterm"]:
            if profile is not None:
                profile.maybe_start(step)
            with timer.section("data"), trace_span("data_wait"):
                batch = ds.host_batch_at(step)
            with timer.section("step"), trace_span("train_step"):
                state, metrics = step_fn(state, batch)
            rollback_flag = False
            if guard is not None:
                with timer.section("sync"):
                    rollback_flag = bool(metrics["rollback"])
                    host = getattr(state.opt_state, "host_count", None)
                    if host is not None:
                        # the host's mirror of the count, which a skipped
                        # step passed through on the device
                        host.n = int(state.opt_state.count)
            if profile is not None:
                profile.maybe_stop(step)
            if rollback_flag:
                # a streak of bad steps: restore, cut the LR, rebuild
                lr_scale *= args.rollback_lr_cut
                rollbacks += 1
                logger.log("event", step, event="rollback",
                           rollbacks=rollbacks, lr_scale=lr_scale,
                           skipped=metrics["skipped"])
                logger.flush()     # the tail of a sick run must hit disk
                if rollbacks > args.max_rollbacks:
                    raise RuntimeError(
                        f"giving up after {args.max_rollbacks} rollbacks: "
                        f"the run keeps hitting {args.max_bad_steps} "
                        f"consecutive bad steps")
                got = restore_latest(args.ckpt_dir, state) \
                    if args.ckpt_dir else None
                if got is not None:
                    state, step = got
                    say(f"rollback #{rollbacks}: restored step {step}, "
                        f"peak lr x{lr_scale:g}")
                else:
                    # nothing to roll back to: reset the streak and push on
                    # with the cut LR (the guard keeps skipping bad steps)
                    step += 1
                    say(f"rollback #{rollbacks}: no checkpoint in "
                        f"{args.ckpt_dir or '<none>'}; continuing with "
                        f"peak lr x{lr_scale:g}")
                state = state._replace(guard=init_guard_state(device),
                                       host_step=HostCount(step))
                _, tx = build(args, lr_scale)
                step_fn = make_step(tx)
                continue
            step += 1
            done_steps += 1
            if args.pack_documents:
                real_tokens += metrics["weight"] * args.grad_accum
            if step % args.log_every == 0 or done_steps == 1:
                line = (f"step {step:6d} loss {float(metrics['loss']):.4f} "
                        f"|g| {float(metrics['grad_norm']):.3f} "
                        f"tok/s {throughput():,.0f}")
                if guard is not None:
                    line += (f" skipped {int(metrics['skipped'])}"
                             f" rollbacks {rollbacks}")
                say(line)
            if args.log_dir and (step % args.metrics_every == 0
                                 or done_steps == 1):
                emit_record(step, throughput())
            if args.ckpt_dir and step % args.ckpt_every == 0:
                with timer.section("ckpt"), trace_span("checkpoint"):
                    if pending is not None:
                        pending.wait()   # one checkpoint in flight at a time
                    pending = save_async(args.ckpt_dir, step, state)
        with timer.section("ckpt"), trace_span("checkpoint"):
            if pending is not None:
                pending.wait()
            if args.ckpt_dir:
                save(args.ckpt_dir, step, state)
        if stop["sigterm"]:
            say(f"sigterm: checkpointed step {step}, exiting cleanly")
        else:
            say(f"done: final loss {float(metrics['loss']):.4f}")
        if args.log_dir and done_steps and step != last_emitted:
            emit_record(step, throughput())
        logger.log("run_end", step,
                   reason="sigterm" if stop["sigterm"] else "done",
                   loss=metrics["loss"], rollbacks=rollbacks, fallbacks=None)
    finally:
        if profile is not None:
            profile.finalize()
        logger.close()
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
