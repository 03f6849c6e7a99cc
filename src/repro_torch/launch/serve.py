"""Serving loop: batched prefill, then greedy decode.

Port of ``repro/launch/serve.py``. On the card, at the published size:

    python -m repro_torch.launch.serve --arch yi-9b --full

and on the CPU, at the reduced size:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --device cpu

The ported archs are rwkv6-3b (the default) and the dense ones (yi-9b,
qwen3-32b, granite-34b, minicpm-2b). The prefill runs every attention
layer through the flash-attention kernel and every RWKV layer's WKV
through its kernel (``serve(use_flash=False, use_rwkv_kernel=False)``
runs the plain versions instead); decode steps in plain PyTorch, as the
reference does.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..configs import ARCHS, get_config
from ..models import Model, build_model
from .steps import make_decode_step, make_prefill_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, prompts: torch.Tensor, new_tokens: int, *,
             use_flash: bool = True, use_rwkv_kernel: bool = True
             ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """Prefill ``prompts`` (B, S) and decode ``new_tokens`` greedily (the
    first from the prefill's logits). Returns the tokens (B, new_tokens)
    and the wall seconds of the prefill and of the decode steps, each
    ending in a device synchronise."""
    batch, prompt_len = prompts.shape
    prefill = make_prefill_step(model, max_seq=prompt_len + new_tokens,
                                use_flash=use_flash,
                                use_rwkv_kernel=use_rwkv_kernel)
    decode = make_decode_step(model)
    dev = prompts.device
    t0 = time.perf_counter()
    logits, caches = prefill({"tokens": prompts})
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    tok = logits.argmax(-1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for t in range(new_tokens - 1):
        logits, caches = decode({"token": tok, "index": prompt_len + t,
                                 "caches": caches})
        tok = logits.argmax(-1)[:, None]
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return torch.cat(out, dim=1), {"prefill_s": t_prefill,
                                   "decode_s": t_decode,
                                   "decode_steps": new_tokens - 1}


def serve(arch: str = "rwkv6-3b", smoke: bool = True, batch: int = 4,
          prompt_len: int = 32, new_tokens: int = 16, seed: int = 0,
          greedy: bool = True, verbose: bool = True,
          device: DeviceLike = None, use_flash: bool = True,
          use_rwkv_kernel: bool = True) -> torch.Tensor:
    """Weights from a generator seeded ``seed``, prompts from one seeded
    ``seed + 1``; returns the (B, new_tokens) greedy tokens."""
    if not greedy:
        raise NotImplementedError("sampling is not ported: the reference "
                                  "serves greedy tokens only")
    cfg = get_config(arch, smoke=smoke)
    dev = resolve_device(device)
    model = build_model(cfg, dev, torch.Generator(device=dev).manual_seed(
        seed))
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=torch.Generator(
                                device=dev).manual_seed(seed + 1),
                            device=dev)
    toks, t = generate(model, prompts, new_tokens, use_flash=use_flash,
                       use_rwkv_kernel=use_rwkv_kernel)
    if verbose:
        steps = t["decode_steps"]
        print(f"{arch}: prefill({batch}x{prompt_len}) "
              f"{t['prefill_s'] * 1e3:.1f} ms "
              f"({batch * prompt_len / t['prefill_s']:.1f} tok/s), decode "
              f"{steps} steps {t['decode_s'] * 1e3:.1f} ms "
              f"({batch * steps / max(t['decode_s'], 1e-9):.1f} tok/s) on "
              f"{dev}")
        print("sample:", toks[0, :12].tolist())
    return toks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="rwkv6-3b")
    ap.add_argument("--full", action="store_true",
                    help="the published size (default: the reduced one)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    serve(args.arch, not args.full, args.batch, args.prompt_len,
          args.new_tokens, args.seed, device=args.device)


if __name__ == "__main__":
    main()
