"""End-to-end driver on the PyTorch port: train a ~100M-param GQA
transformer for a few hundred steps on the synthetic token pipeline, with
checkpoint/restart, on the card unless ``--device cpu``. ``--size tiny``
trains a two-layer model of the same shape family instead.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]
"""
import argparse
import os
import tempfile

from repro_torch.configs.base import LMConfig
import repro_torch.launch.train as T

# ~100M params: 12L d=512 8H GQA(kv=4) ffn 2048 vocab 32k
CONFIG_100M = LMConfig(
    name="demo-100m", n_layers=12, d_model=512, n_heads=8, n_kv_heads=4,
    d_ff=2048, vocab=32_000, act="swiglu",
)
CONFIG_TINY = LMConfig(
    name="demo-tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, act="swiglu",
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--size", choices=("100m", "tiny"), default="100m")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = CONFIG_100M if args.size == "100m" else CONFIG_TINY

    # route the driver through our local config
    orig_get = T.get_config
    T.get_config = lambda arch: cfg
    try:
        out = T.train_lm(cfg.name, steps=args.steps, batch=args.batch, seq=args.seq,
                         ckpt_dir=args.ckpt_dir, ckpt_every=50, full=True, log_every=10,
                         device=args.device)
    finally:
        T.get_config = orig_get
    n = cfg.n_params() / 1e6
    print(f"\ntrained {n:.1f}M params for {args.steps} steps; "
          f"loss {out['losses'][0]:.3f} → {out['final_loss']:.3f}")
    assert out["final_loss"] < out["losses"][0], "loss must improve"


if __name__ == "__main__":
    main()
