"""Serving loop: batched prefill, then greedy decode.

Port of ``repro/launch/serve.py``. On the card, at the published size:

    python -m repro_torch.launch.serve --arch yi-9b --full

and on the CPU, at the reduced size:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --device cpu

Every arch of ``configs.ARCHS`` serves (rwkv6-3b by default). An
encoder-decoder arch (seamless-m4t-large-v2) also takes ``src_embed``
frames, a vision arch (llama-3.2-vision-90b) ``vision_embed`` patches,
both drawn by :func:`make_inputs`; hymba's meta tokens sit before the
prompt, so its ring caches hold them and its decode positions count
them. The prefill runs every causal attention layer without a window
through the flash-attention kernel and every RWKV layer's WKV through its
kernel (``serve(use_flash=False, use_rwkv_kernel=False)`` runs the plain
versions instead); windowed, bidirectional and cross-attention take the
plain route, as in the reference; decode steps in plain PyTorch, as the
reference does.

On the card :func:`generate` replays the prefill and the greedy decode
step as CUDA graphs (:func:`~repro_torch.launch.steps.compiled_prefill`,
:func:`~repro_torch.launch.steps.compiled_decode`), as the reference
jits them; the first call at a shape captures them (``capture_s``). On
the CPU it calls the same steps eagerly, and ``generate(...,
graphs=False)`` does so on the card too.
"""
from __future__ import annotations

import argparse
import functools
import time
from typing import Dict, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..configs import ARCHS, get_config
from ..core import graphed
from ..models import Model, ModelConfig, build_model
from . import steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, prompts: torch.Tensor, new_tokens: int, *,
             use_flash: bool = True, use_rwkv_kernel: bool = True,
             src_embed: Optional[torch.Tensor] = None,
             vision_embed: Optional[torch.Tensor] = None,
             graphs: Optional[bool] = None, keep_logits: bool = False,
             mesh=None, batch: Optional[int] = None
             ) -> Tuple[torch.Tensor, Dict]:
    """Prefill ``prompts`` (B, S) and decode ``new_tokens`` greedily (the
    first from the prefill's logits). ``src_embed`` (an encoder-decoder
    arch's source) and ``vision_embed`` (a vision arch's patches) join the
    prefill's batch; the decode positions count the meta tokens.

    ``graphs`` (default: on the card, :func:`~repro_torch.core.graphed.
    graphs_on`) replays the prefill and the decode step as CUDA graphs,
    one of each per model and shapes, captured at the first call; a
    capture that fails raises. ``graphs=False`` calls the same steps
    eagerly.

    On a bound ``mesh`` (a model holding this rank's blocks,
    ``partition.build_local`` or ``steps.shard_model``) ``prompts`` are
    this rank's rows of a global ``batch`` (``steps.shard_batch`` under
    the serve rules), and the steps replay as chains of graphs cut at
    their collectives (``core/graphed.py::CutGraph``), every rank of the
    mesh calling ``generate`` alike.

    Returns the tokens (B, new_tokens) and a dict: the wall seconds of the
    prefill (the encoder and the cross keys and values included) and of
    the decode steps, each ending in a device synchronise, less the
    warm-up and capture seconds, which are ``capture_s``; ``decode_steps``;
    ``graphs``; ``pool_bytes`` (the two graphs' private pools); with
    ``keep_logits`` the logits of every token, (new_tokens, B, V) f32."""
    prompt_len = prompts.shape[1]
    meta = model.cfg.n_meta_tokens
    dev = prompts.device
    graphs = graphed.graphs_on(dev) if graphs is None else graphs
    b = {"tokens": prompts}
    if src_embed is not None:
        b["src_embed"] = src_embed
    if vision_embed is not None:
        b["vision_embed"] = vision_embed
    max_seq = prompt_len + new_tokens
    on_mesh = {} if mesh is None else {"mesh": mesh, "batch": batch}
    serving = (None if mesh is None else
               steps.mesh_serving(model, mesh, batch, max_seq + meta))
    if graphs:
        prefill = steps.compiled_prefill(model, b, max_seq=max_seq,
                                         use_flash=use_flash,
                                         use_rwkv_kernel=use_rwkv_kernel,
                                         **on_mesh)
    else:
        prefill = graphed.EagerStep(functools.partial(
            steps.serve_prefill_step, model, max_seq + meta, use_flash,
            use_rwkv_kernel, serving=serving), dev)
    captured = prefill.capture_s
    t0 = time.perf_counter()
    _, (logits, caches, cross_kvs) = prefill(b)
    _sync(dev)
    capture_s = prefill.capture_s - captured
    t_prefill = time.perf_counter() - t0 - capture_s
    carry = (logits.argmax(-1)[:, None], caches, cross_kvs)
    decode = (steps.compiled_decode(model, carry, max_seq=max_seq,
                                    **on_mesh) if graphs else
              graphed.EagerStep(functools.partial(
                  steps.serve_decode_step, model, serving=serving), dev))
    out, kept = [carry[0]], [logits]
    captured = decode.capture_s
    t0 = time.perf_counter()
    for t in range(new_tokens - 1):
        carry, logits = decode(carry, prompt_len + t + meta)
        out.append(decode.detach(carry[0]))
        if keep_logits:
            kept.append(logits)
    _sync(dev)
    capture_d = decode.capture_s - captured
    t_decode = time.perf_counter() - t0 - capture_d
    info = {"prefill_s": t_prefill, "decode_s": t_decode,
            "decode_steps": new_tokens - 1,
            "capture_s": capture_s + capture_d, "graphs": graphs,
            "pool_bytes": prefill.pool_bytes + decode.pool_bytes}
    if keep_logits:
        info["logits"] = torch.stack(kept)
    return torch.cat(out, dim=1), info


# source frames of an encoder-decoder arch's stub frontend, as the
# reference serves them
SRC_LEN = 16


def make_inputs(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
                device: torch.device
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prompts (B, S) from a generator seeded ``seed``, and the arch's
    other inputs from the same generator: ``src_embed`` (B, SRC_LEN, d)
    for an encoder-decoder arch, ``vision_embed`` (B, vision_seq, d) for
    a vision arch, normal draws in the activations' dtype."""
    gen = torch.Generator(device=device).manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device=device)
    extra = {}
    if cfg.n_encoder_layers:
        extra["src_embed"] = torch.randn(
            (batch, SRC_LEN, cfg.d_model), generator=gen,
            device=device).to(cfg.activation_dtype)
    if cfg.family == "vlm":
        extra["vision_embed"] = torch.randn(
            (batch, cfg.vision_seq, cfg.d_model), generator=gen,
            device=device).to(cfg.activation_dtype)
    return prompts, extra


def serve(arch: str = "rwkv6-3b", smoke: bool = True, batch: int = 4,
          prompt_len: int = 32, new_tokens: int = 16, seed: int = 0,
          greedy: bool = True, verbose: bool = True,
          device: DeviceLike = None, use_flash: bool = True,
          use_rwkv_kernel: bool = True) -> torch.Tensor:
    """Weights from a generator seeded ``seed``, the inputs
    (:func:`make_inputs`) from one seeded ``seed + 1``; returns the
    (B, new_tokens) greedy tokens."""
    if not greedy:
        raise NotImplementedError("sampling is not ported: the reference "
                                  "serves greedy tokens only")
    cfg = get_config(arch, smoke=smoke)
    dev = resolve_device(device)
    model = build_model(cfg, dev, torch.Generator(device=dev).manual_seed(
        seed))
    prompts, extra = make_inputs(cfg, batch, prompt_len, seed + 1, dev)
    toks, t = generate(model, prompts, new_tokens, use_flash=use_flash,
                       use_rwkv_kernel=use_rwkv_kernel, **extra)
    if verbose:
        n = t["decode_steps"]
        print(f"{arch}: prefill({batch}x{prompt_len}) "
              f"{t['prefill_s'] * 1e3:.1f} ms "
              f"({batch * prompt_len / t['prefill_s']:.1f} tok/s), decode "
              f"{n} steps {t['decode_s'] * 1e3:.1f} ms "
              f"({batch * n / max(t['decode_s'], 1e-9):.1f} tok/s) on "
              f"{dev}" + (f", CUDA graphs captured in "
                          f"{t['capture_s']:.2f} s ({t['pool_bytes']} B "
                          f"of pool)" if t["graphs"] else ""))
        print("sample:", toks[0, :12].tolist())
    return toks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="rwkv6-3b",
                    help="one of the ten archs (default rwkv6-3b)")
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
