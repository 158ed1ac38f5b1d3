"""Serving launcher: batched autoregressive decode for every arch of the
LM template (``repro.launch.serve``: the same flags and printout).

``--reduced`` is ``repro``'s flag as it is: ``store_true`` with default
True, so the CLI always runs the reduced config; ``generate`` takes any
config, full width included. Runs on CUDA unless ``--device cpu``.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --reduced --batch 4 --prompt-len 16 --new-tokens 32 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import resolve_device
from repro_torch.models import transformer as T
from repro_torch.training import make_serve_step


def generate(cfg: ModelConfig, params, prompt, new_tokens: int, *,
             device=None, cache_dtype=torch.float32) -> torch.Tensor:
    """``repro``'s serving loop: the prompt fed one token at a time through
    the greedy serve step into fresh caches (``cache_dtype``, fp32 as
    ``repro``'s launcher makes them) of prompt + ``new_tokens`` slots, then
    ``new_tokens`` steps each fed the previous step's token. Returns the
    tokens those steps chose, (B, new_tokens) int32 ((B, new_tokens, C)
    for audio), on the device."""
    device = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=device)
    b, plen = prompt.shape[:2]
    cache_len = plen + new_tokens
    caches = T.init_caches(cfg, b, cache_len, dtype=cache_dtype,
                           device=device)
    serve = make_serve_step(cfg)

    def pos(t):
        return torch.full((b,), t, dtype=torch.int32, device=device)

    for t in range(plen):
        cur, _, caches = serve(params, caches, prompt[:, t], pos(t))
    gen = []
    for t in range(plen, cache_len):
        cur, _, caches = serve(params, caches, cur, pos(t))
        gen.append(cur)
    return torch.stack(gen, dim=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--greedy", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(seq_len_hint=args.prompt_len)
    params = T.init_params(cfg, args.seed, device=device, cast=True)
    rng = np.random.default_rng(args.seed)
    b = args.batch
    tok_shape = ((b, args.prompt_len, cfg.num_codebooks)
                 if cfg.modality == "audio" else (b, args.prompt_len))
    prompt = rng.integers(0, cfg.vocab_size, tok_shape)
    t0 = time.perf_counter()
    gen = generate(cfg, params, prompt, args.new_tokens, device=device)
    gen = gen.cpu().numpy()
    dt = time.perf_counter() - t0
    total = b * (args.prompt_len + args.new_tokens)
    print(f"arch={cfg.name} decoded {args.new_tokens}×{b} tokens "
          f"({total / dt:.1f} tok/s incl. prefill)")
    print("sample:", gen[0].tolist()[:12])


if __name__ == "__main__":
    main()
