"""Serving example on the PyTorch port: prefill a batch of prompts, then
decode new tokens with the KV cache (GQA), on the card unless ``--device
cpu``. Each step's logits are then held against one full forward over the
prompt and the decoded tokens, within 1e-3 of their largest magnitude; the
script fails if they differ.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_smoke
from repro_torch.models.transformer import decode_step, forward, init_params, prefill

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

cfg = get_smoke("granite_8b")
gen = torch.Generator(device=args.device).manual_seed(0)
model = init_params(gen, cfg, device=args.device)

batch, prompt_len, s_max, new_tokens = 4, 24, 64, 16
prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen, device=args.device)

with torch.no_grad():
    logits, cache = prefill(model, cfg, prompts, s_max, chunk_q=16)
    tok = torch.argmax(logits, -1)[:, None]
    out, step_logits = [tok], [logits]
    for i in range(new_tokens):
        logits, cache = decode_step(model, cfg, cache, tok, prompt_len + i)
        tok = torch.argmax(logits, -1)[:, None]
        out.append(tok)
        step_logits.append(logits)
    generated = torch.cat(out, dim=1)
    # the logits at positions prompt_len - 1 ... prompt_len + new_tokens - 1
    # of one forward over the prompt and every decoded token but the last
    full, _ = forward(model, cfg, torch.cat([prompts, generated[:, :-1]], dim=1))
    want = full[:, prompt_len - 1:]

got = torch.stack(step_logits, dim=1)
err = float((got - want).abs().max())
tol = 1e-3 * float(want.abs().max())
print(f"prefilled {batch}×{prompt_len}, decoded {new_tokens} tokens each")
print("generated token ids:\n", generated.cpu().numpy())
print(f"every step's logits against one full forward: max abs err {err:.3e} (<= {tol:.3e})")
if not err <= tol:
    raise SystemExit(f"decode disagrees with the full forward: {err} > {tol}")
