"""Training driver: an end-to-end loop with checkpoints and exact restart,
the port of ``repro/launch/train.py``.

The smoke config unless ``--full``; the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b --steps 20 \\
        --batch 8 --seq 64 --ckpt-dir /tmp/ckpt --device cpu

A checkpoint holds ``{"params", "opt"}`` under the reference's leaf keys
(``convert.lm_params_to_tree``: the ``dense``/``moe_stack`` layer stacks,
the moments in the same layout, ``opt/step``), so a checkpoint the
reference's ``train_lm`` wrote resumes here, and the reverse. Batches are
``LMTokenPipeline``'s, a pure function of (seed, step): a resumed run sees
the batches the uninterrupted one saw.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.convert import lm_params_into_, lm_params_to_tree
from repro_torch.data.pipeline import LMTokenPipeline
from repro_torch.models import transformer as tf
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.steps import make_lm_train_step
from repro_torch.utils import resolve_device


def train_state_tree(model, opt_state, cfg) -> dict:
    """``{"params", "opt": {"m", "v", "step"}}`` in the reference's layout,
    host copies: what ``train_lm`` checkpoints and restores."""
    return {"params": lm_params_to_tree(model, cfg),
            "opt": {"m": lm_params_to_tree(opt_state["m"], cfg),
                    "v": lm_params_to_tree(opt_state["v"], cfg),
                    "step": opt_state["step"].detach().to("cpu", copy=True)}}


def train_lm(arch: str, *, steps: int = 20, batch: int = 8, seq: int = 64,
             ckpt_dir: str | None = None, ckpt_every: int = 10, full: bool = False,
             restore: bool = True, seed: int = 0, log_every: int = 5,
             device=None) -> dict:
    """Train ``arch`` for ``steps`` steps (from the latest checkpoint in
    ``ckpt_dir`` when ``restore``), saving every ``ckpt_every`` steps and
    at the end. Returns the reference's ``{"losses": [float per step run],
    "params", "final_loss"}``, ``"params"`` the reference's LM tree
    (``convert.lm_params_to_tree``: one host copy, taken at the end), and
    beside them the trained ``"model"`` and its ``"opt_state"``. Weights
    are drawn from ``seed`` on ``device`` (default cuda); the step is the
    reference's (``chunk_q=min(seq, 512)``, no remat, full cross-entropy)."""
    dev = resolve_device(device)
    cfg = get_config(arch) if full else get_smoke(arch)
    pipe = LMTokenPipeline(cfg, batch, seq, seed=seed)
    model = tf.init_params(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    opt_state = opt.init_state(model)
    step_fn = make_lm_train_step(cfg, chunk_q=min(seq, 512), remat=False)

    start = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and restore and (latest := mgr.latest_step()) is not None:
        state = mgr.restore(latest, train_state_tree(model, opt_state, cfg), device=dev)
        lm_params_into_(model, state["params"], cfg)
        lm_params_into_(opt_state["m"], state["opt"]["m"], cfg)
        lm_params_into_(opt_state["v"], state["opt"]["v"], cfg)
        opt_state["step"].copy_(state["opt"]["step"])
        start = latest
        print(f"restored step {latest} from {ckpt_dir}")

    losses = []
    t0 = time.time()
    for step in range(start, steps):
        model, opt_state, metrics = step_fn(model, opt_state, pipe.batch_at(step))
        losses.append(float(metrics["loss"]))
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"({(time.time() - t0) / max(step - start + 1, 1):.2f}s/step)")
        if mgr and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, train_state_tree(model, opt_state, cfg))
    if mgr:
        mgr.save(steps, train_state_tree(model, opt_state, cfg), blocking=True)
    return {"losses": losses, "params": lm_params_to_tree(model, cfg), "model": model,
            "opt_state": opt_state, "final_loss": losses[-1] if losses else None}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi_6b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    out = train_lm(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, full=args.full,
                   seed=args.seed, device=args.device)
    print(f"final loss: {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
