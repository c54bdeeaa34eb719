"""End-to-end trainer (port of ``repro/launch/train.py``): real steps of
an arch's smoke configuration, with checkpoint/restart.

LM, GNN and recsys archs train as in the JAX package: AdamW (lr 1e-3,
10 warm-up steps), the LM on ``lm_batches`` at ``seq`` tokens, a GNN on
one fixed ``graph_batch`` of 64 nodes and 256 edges, SASRec on
``sasrec_batches``.  The weights are drawn from seed 0 by the port's own
initialisers.  Every ``ckpt_every`` steps the parameters are saved under
``ckpt_dir`` and the optimizer state under ``ckpt_dir + "/opt"``, in the
JAX package's on-disk format (``checkpoint/checkpointer.py``), so either
package continues the other's run.  A restart restores the newest step
and continues from it; as in the JAX trainer, the data stream starts
again from its seed (only the GNN's fixed batch sees the data an
unbroken run would).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch sasrec --steps 3 [--ckpt-dir /tmp/ckpt]
"""
from __future__ import annotations

import argparse
import itertools
import time

from repro_torch.checkpoint import checkpointer
from repro_torch.configs import REGISTRY
from repro_torch.data.synthetic import graph_batch, lm_batches, sasrec_batches
from repro_torch.device import resolve_device
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import sasrec as sasrec_mod
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step


def _build_smoke(arch: str, batch: int, seq: int, device):
    spec = REGISTRY[arch]
    cfg = spec.make_smoke_config()
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=1000)
    if spec.family == "lm":
        params = tfm.init_transformer(cfg, 0, device)
        step = make_train_step(
            lambda p, t, l: tfm.loss_fn(p, t, l, cfg), opt_cfg)
        batches = lm_batches(cfg.vocab, batch, seq, device=device)
    elif spec.family == "gnn":
        params = gnn_mod.init_gnn(cfg, 0, device)
        g = graph_batch(64, 256, cfg.d_in, cfg.n_classes, seed=0,
                        with_coords=cfg.arch in ("egnn", "dimenet"),
                        device=device)
        step = make_train_step(
            lambda p, gb: gnn_mod.gnn_loss(p, gb, cfg), opt_cfg)
        batches = itertools.repeat((g,))
    elif spec.family == "recsys":
        params = sasrec_mod.init_sasrec(cfg, 0, device)
        step = make_train_step(
            lambda p, s, po, ne: sasrec_mod.train_loss(p, s, po, ne, cfg),
            opt_cfg)
        batches = sasrec_batches(cfg.n_items, batch, cfg.seq_len,
                                 device=device)
    else:
        raise ValueError(f"train.py does not handle family {spec.family}; "
                         f"use launch/stream.py for mosso")
    opt = adamw.init(params, opt_cfg)
    return params, opt, step, batches


def train(arch: str, steps: int, batch: int = 8, seq: int = 64,
          ckpt_dir: str | None = None, ckpt_every: int = 25,
          log_every: int = 10, device="cuda") -> dict:
    """Train ``arch``'s smoke configuration up to step ``steps`` on
    ``device``, resuming from the newest checkpoint in ``ckpt_dir``.
    Returns the losses of the steps this call ran."""
    device = resolve_device(device)
    params, opt, step, batches = _build_smoke(arch, batch, seq, device)
    start = 0
    if ckpt_dir:
        latest = checkpointer.latest_step(ckpt_dir)
        if latest is not None:
            params = checkpointer.restore(ckpt_dir, latest, params, device)
            opt = checkpointer.restore(ckpt_dir + "/opt", latest, opt,
                                       device)
            start = latest
            print(f"restored step {latest}")
    losses = []
    t0 = time.time()
    for i in range(start, steps):
        b = next(batches)
        params, opt, metrics = step(params, opt, *b)
        losses.append(float(metrics["loss"]))
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i+1}: loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0)/max(1,i+1-start)*1e3:.0f} ms/step)")
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            checkpointer.save(ckpt_dir, i + 1, params)
            checkpointer.save(ckpt_dir + "/opt", i + 1, opt)
    return dict(first_loss=losses[0] if losses else None,
                last_loss=losses[-1] if losses else None,
                losses=losses)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--smoke", action="store_true", help="(default mode)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = train(args.arch, args.steps, args.batch, args.seq, args.ckpt_dir,
                device=args.device)
    print(f"loss {out['first_loss']:.4f} -> {out['last_loss']:.4f}")


if __name__ == "__main__":
    main()
