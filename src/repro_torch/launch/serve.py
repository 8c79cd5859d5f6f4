"""Batched LM serving: prefill + greedy decode over synthetic requests,
the twin of ``repro.launch.serve``'s ``--arch`` branch.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --reduced --batch 4 --prompt-len 32 --gen-len 16

Requests arrive in waves; each wave is prefilled as a batch and decoded
token by token (greedy), in float32; throughput is reported as decode
tokens/s.  It runs on the CUDA card (``serve_lm(..., device="cpu")`` runs
the plain PyTorch versions).  Serving DGO requests (``--dgo``) is not
ported yet (ROADMAP queue 1 #6).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.configs import REGISTRY, get_arch, reduced
from repro_torch.core.distributed import resolve_device
from repro_torch.models.lm import ArchConfig, init_model, lm_decode, lm_prefill


@dataclasses.dataclass
class ServeResult:
    """Per wave: the prompts (B, prompt_len), the generated tokens
    (B, gen_len) and the float32 logits each token was chosen from
    (gen_len, B, V); the wall seconds of each wave's prefill; the decode
    wall seconds and tokens of all waves (the first token of a wave comes
    from its prefill and is not counted)."""

    prompts: list[torch.Tensor]
    tokens: list[torch.Tensor]
    logits: list[torch.Tensor]
    prefill_s: list[float]
    decode_s: float
    decode_tokens: int

    @property
    def decode_tokens_per_s(self) -> float:
        return self.decode_tokens / max(self.decode_s, 1e-9)


def _clock(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def serve_lm(arch: ArchConfig, *, batch: int, prompt_len: int, gen_len: int,
             waves: int, seed: int, device=None, params=None) -> ServeResult:
    """Serve ``waves`` batches of ``batch`` random prompts of
    ``prompt_len`` tokens, each prefilled and then decoded greedily for
    ``gen_len`` tokens in all.  Weights: ``params`` when given (on the
    device), else :func:`init_model` from a generator on the device
    seeded with ``seed``.  Prompts are drawn from a CPU generator seeded
    with ``seed + 1``, so they do not depend on the device.  ``device``:
    None is the CUDA card (``RuntimeError`` without one), ``"cpu"`` runs
    the plain PyTorch versions.  Raises ``RuntimeError`` on non-finite
    logits."""
    dev = resolve_device(device)
    dtype = torch.float32
    if params is None:
        params = init_model(arch, torch.Generator(device=dev).manual_seed(
            seed), dtype)
    cache_len = prompt_len + gen_len
    prompt_gen = torch.Generator().manual_seed(seed + 1)
    res = ServeResult([], [], [], [], 0.0, 0)
    for _ in range(waves):
        prompts = torch.randint(0, arch.vocab_size, (batch, prompt_len),
                                generator=prompt_gen)
        t0 = _clock(dev)
        logits, cache = lm_prefill(params, arch, {"tokens": prompts.to(dev)},
                                   cache_len=cache_len, dtype=dtype)
        tok = torch.argmax(logits, dim=-1)
        t1 = _clock(dev)
        outs, step_logits = [tok], [logits]
        for _ in range(gen_len - 1):
            logits, cache = lm_decode(params, arch, tok, cache, dtype=dtype)
            tok = torch.argmax(logits, dim=-1)
            outs.append(tok)
            step_logits.append(logits)
        t2 = _clock(dev)
        all_logits = torch.stack(step_logits)
        if not bool(torch.isfinite(all_logits).all()):
            raise RuntimeError("non-finite logits")
        res.prompts.append(prompts)
        res.tokens.append(torch.stack(outs, dim=1))
        res.logits.append(all_logits)
        res.prefill_s.append(t1 - t0)
        res.decode_s += t2 - t1
        res.decode_tokens += batch * (gen_len - 1)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(REGISTRY))
    ap.add_argument("--dgo", action="store_true",
                    help="serve DGO optimization requests (not ported yet)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--waves", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.dgo:
        raise NotImplementedError("--dgo serving is not ported yet "
                                  "(ROADMAP queue 1 #6)")
    if args.arch is None:
        ap.error("--arch is required")
    arch = get_arch(args.arch)
    if args.reduced:
        arch = reduced(arch)
    res = serve_lm(arch, batch=args.batch, prompt_len=args.prompt_len,
                   gen_len=args.gen_len, waves=args.waves, seed=args.seed)
    for wave, toks in enumerate(res.tokens):
        print(f"[serve] wave {wave}: generated {tuple(toks.shape)} tokens")
    print(json.dumps({
        "decode_tokens_per_s": round(res.decode_tokens_per_s, 1),
        "total_tokens": res.decode_tokens,
    }))


if __name__ == "__main__":
    main()
