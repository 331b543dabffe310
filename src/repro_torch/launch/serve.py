"""Serving launcher: batched prefill + decode with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu]

The port of ``repro.launch.serve``: the same flags and the same prompts
(numpy seed 0), random weights from a ``torch.Generator`` seeded with 0,
plus ``--device`` (default ``cuda``, which raises without a GPU).  Greedy
tokens; prefill and each decode step are timed on the host clock with the
device synchronised, and every logit is checked to be finite.
"""

from __future__ import annotations

import argparse
import math
import statistics
import time
from dataclasses import replace

import numpy as np
import torch

from ..configs import get_config, reduce_for_smoke
from ..models import mamba2, rwkv6
from ..models.lm import LM, decode_fn, init_cache, prefill_fn, resolve_device

__all__ = ["prompts", "generate", "seq_multiple", "cut_depth", "dropless",
           "teacher_forced", "parse_args", "main"]


def prompts(cfg, batch: int, prompt_len: int, seed: int = 0) -> dict:
    """The launcher's inputs as numpy arrays: uniform random ``tokens``
    ``[batch, prompt_len]`` and, for an encoder-decoder, standard normal
    ``frames`` ``[batch, prompt_len, d_model]``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, prompt_len)
                                  ).astype(np.int32)}
    if cfg.enc_dec:
        out["frames"] = rng.standard_normal(
            (batch, prompt_len, cfg.d_model)).astype(np.float32)
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(model: LM, inputs: dict, gen: int,
             keep_logits: bool = False) -> dict:
    """Greedy generation of ``gen`` tokens for each prompt of ``inputs``
    (:func:`prompts`): one prefill with a cache of ``prompt_len + gen``
    slots, then ``gen - 1`` decode steps.  Returns the tokens ``[B, gen]``,
    the prefill's and each decode step's seconds (device synchronised),
    the wall, tokens/s and whether every logit was finite; with
    ``keep_logits``, also ``logits`` ``[B, gen, vocab]`` (float32, on the
    model's device): the logits each token was chosen from."""
    cfg, dev = model.cfg, model.device
    B, Lp = inputs["tokens"].shape
    batch = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
    prefill, decode = prefill_fn(with_cache=True), decode_fn()
    with torch.inference_mode():
        cache = init_cache(cfg, B, cap=Lp + gen, device=dev,
                           dtype=model.dtype)
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(model, cache, batch)
        finite = torch.isfinite(logits).all()
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        kept = [logits.float()] if keep_logits else None
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        out, step_s = [nxt], []
        for i in range(gen - 1):
            t1 = time.perf_counter()
            step = {"token": nxt[:, None],
                    "pos": torch.full((B,), Lp + i, dtype=torch.int32,
                                      device=dev)}
            if cfg.mrope_sections:
                step["positions"] = torch.full((3, B, 1), Lp + i,
                                               dtype=torch.int32, device=dev)
            logits, cache = decode(model, cache, step)
            finite &= torch.isfinite(logits).all()
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            if keep_logits:
                kept.append(logits.float())
            out.append(nxt)
            _sync(dev)
            step_s.append(time.perf_counter() - t1)
        wall = time.perf_counter() - t0
        tokens = torch.stack(out, dim=1).cpu().numpy()
    res = {"tokens": tokens, "prefill_s": prefill_s, "decode_s": step_s,
           "wall_s": wall, "tok_per_s": B * gen / wall,
           "finite": bool(finite)}
    if keep_logits:
        res["logits"] = torch.stack(kept, dim=1)
    return res


def seq_multiple(cfg) -> int:
    """What a prompt's length must be a multiple of once it is longer than
    one chunk: Mamba2's and RWKV-6's chunk lengths where the config has
    such layers (their chunked prefill requires whole chunks), else 1."""
    kinds = cfg.layer_kinds()
    m = 1
    if any(k.startswith("mamba2") for k in kinds):
        m = math.lcm(m, mamba2.CHUNK)
    if "rwkv6" in kinds:
        m = math.lcm(m, rwkv6.CHUNK)
    return m


def cut_depth(cfg, min_layers: int = 4):
    """``cfg`` cut to the fewest whole layer cycles that hold at least
    ``min_layers`` layers (zamba2's cycle ends in its shared attention
    block), or left whole where it has no more; widths unchanged."""
    n = len(cfg.attn_pattern)
    return replace(cfg, n_layers=min(cfg.n_layers,
                                     n * math.ceil(min_layers / n)))


def dropless(cfg):
    """``cfg`` with an MoE capacity factor of ``n_experts / top_k``, so
    that every expert can take all of a dispatch group's tokens and none
    is dropped (``cfg`` itself without experts).  A decode step dispatches
    the batch as one group and a forward each sequence, so with a smaller
    factor the two drop different tokens, as the reference does."""
    if not cfg.n_experts:
        return cfg
    return replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def teacher_forced(model: LM, inputs: dict, tokens) -> torch.Tensor:
    """The forward's float32 logits ``[B, G, vocab]`` at the positions
    :func:`generate` read its ``G`` logits from (the prompt's last, then
    each fed-back token's): one forward over the prompt followed by
    ``tokens[:, :-1]`` (``tokens`` ``[B, G]``, the greedy tokens),
    right-padded with token 0 to a multiple of :func:`seq_multiple`.  The
    forward is causal, so the pad changes no compared position; an
    encoder-decoder's ``frames`` go in as they are."""
    cfg, dev = model.cfg, model.device
    B, Lp = inputs["tokens"].shape
    G = tokens.shape[1]
    toks = np.concatenate([inputs["tokens"], tokens[:, :-1]], axis=1)
    m = seq_multiple(cfg)
    pad = -toks.shape[1] % m if toks.shape[1] > m else 0
    toks = np.pad(toks, ((0, 0), (0, pad))).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    if cfg.enc_dec:
        batch["frames"] = torch.from_numpy(inputs["frames"]).to(dev)
    with torch.inference_mode():
        logits, _, _ = model(batch)
    return logits[:, Lp - 1:Lp - 1 + G].float()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    dev = resolve_device(args.device)
    model = LM(cfg, device=dev, seed=0)
    res = generate(model, prompts(cfg, args.batch, args.prompt_len),
                   args.gen)
    gen = res["tokens"]
    dec_ms = (statistics.median(res["decode_s"]) * 1e3
              if res["decode_s"] else 0.0)
    print(f"arch={cfg.name} device={dev} generated {gen.shape} in "
          f"{res['wall_s']:.2f}s ({res['tok_per_s']:.1f} tok/s); prefill "
          f"{res['prefill_s'] * 1e3:.1f} ms, decode p50 {dec_ms:.2f} ms/step; "
          f"logits finite={res['finite']}")
    print(gen[:, :12])
    return res


if __name__ == "__main__":
    main()
