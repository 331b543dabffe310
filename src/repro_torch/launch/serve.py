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
import statistics
import time

import numpy as np
import torch

from ..configs import get_config, reduce_for_smoke
from ..models.lm import LM, decode_fn, init_cache, prefill_fn, resolve_device

__all__ = ["prompts", "generate", "parse_args", "main"]


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


def generate(model: LM, inputs: dict, gen: int) -> dict:
    """Greedy generation of ``gen`` tokens for each prompt of ``inputs``
    (:func:`prompts`): one prefill with a cache of ``prompt_len + gen``
    slots, then ``gen - 1`` decode steps.  Returns the tokens ``[B, gen]``,
    the prefill's and each decode step's seconds (device synchronised),
    the wall, tokens/s and whether every logit was finite."""
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
            out.append(nxt)
            _sync(dev)
            step_s.append(time.perf_counter() - t1)
        wall = time.perf_counter() - t0
        tokens = torch.stack(out, dim=1).cpu().numpy()
    return {"tokens": tokens, "prefill_s": prefill_s, "decode_s": step_s,
            "wall_s": wall, "tok_per_s": B * gen / wall,
            "finite": bool(finite)}


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
