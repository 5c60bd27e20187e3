"""Serving launcher — a thin CLI over the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_14b \\
        --policy flexpe-fxp8 --kv-block-size 16 --requests 8 --slots 4 \\
        --prompt-len 64 --mixed --gen 16

`--arch deepseek_moe_16b` serves the MoE family the same way, and
`--policy edge4` serves FxP4 (packed-nibble weights, FxP4 activations).

Builds random weights from `--seed` (quantize-once FxP codes for an FxP
policy), a `ServingEngine` over a paged or contiguous KV cache, submits
`--requests` greedy requests and prints each completion, tok/s and the
kernel launch counts. Runs on CUDA unless `--device cpu` (the plain
PyTorch path; use `--reduced` there). `--backend kernels` (the default)
serves through the Hopper kernels; `reference` through the plain path.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.base import ARCH_IDS, get_config
from ..core.backend import BACKENDS, resolve_device
from ..core.precision import PrecisionPolicy
from ..core.qtensor import packed_bytes, quantize_params
from ..kernels.cordic_af.cordic_af import cordic_af
from ..kernels.cordic_softmax.cordic_softmax import cordic_softmax
from ..kernels.fxp_gemm.fxp_gemm import fxp_gemm_fused
from ..kernels.paged_attention.paged_attention import (paged_attention_float,
                                                      paged_attention_int)
from ..models import model as M
from ..serving import Request, SamplingParams, ServingEngine
from ..serving.scheduler import POLICIES


#: the kernel wrappers of the serving path, each with its launch counter
KERNELS = {"fxp_gemm_fused": fxp_gemm_fused,
           "paged_attention_float": paged_attention_float,
           "cordic_af": cordic_af, "cordic_softmax": cordic_softmax,
           "paged_attention_int": paged_attention_int}


def launch_counts() -> dict:
    """{kernel name: launches so far} of every kernel of the path."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def make_requests(cfg, n, prompt_len, gen, mixed=False, temp=0.0, top_k=0,
                  seed=0):
    """n requests of random prompts from `seed`; `mixed` varies prompt
    lengths over [plen/2, plen] as the reference launcher does."""
    rng = np.random.default_rng(seed + 1)
    reqs = []
    for i in range(n):
        plen = (max(1, prompt_len - (i % 4) * (prompt_len // 8))
                if mixed else prompt_len)
        prompt = rng.integers(0, cfg.vocab, size=plen).tolist()
        reqs.append(Request(prompt=prompt, max_new_tokens=gen,
                            sampling=SamplingParams(temperature=temp,
                                                    top_k=top_k)))
    return reqs


def build_engine(cfg, policy, *, seed=0, device=None, **engine_kw):
    """Random weights from `seed`, quantize-once surgery for an FxP policy,
    and the engine over them."""
    params = M.init_params(cfg, seed, device=device)
    if policy.matmul is not None:
        params = quantize_params(params, policy.matmul, consume=True)
    return ServingEngine(cfg, params, policy=policy, seed=seed,
                         device=device, **engine_kw)


def serve(engine, reqs):
    """Submit `reqs`, drain the event stream; -> (finished outputs sorted
    by id, seconds)."""
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    finished = [out for out in engine.events() if out.finished]
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return sorted(finished, key=lambda o: o.id), time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--mixed", action="store_true")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--overlap", default=True,
                    action=argparse.BooleanOptionalAction)
    ap.add_argument("--scheduler", default="fifo", choices=list(POLICIES))
    ap.add_argument("--kv-block-size", type=int, default=0)
    ap.add_argument("--kv-blocks", type=int, default=0)
    ap.add_argument("--policy", default="flexpe-fxp8")
    ap.add_argument("--backend", default="kernels", choices=list(BACKENDS))
    ap.add_argument("--temp", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "path)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    policy = PrecisionPolicy.from_name(args.policy, backend=args.backend)
    engine = build_engine(
        cfg, policy, seed=args.seed, device=device, max_slots=args.slots,
        max_len=args.prompt_len + args.gen, prefill_chunk=args.prefill_chunk,
        kv_block_size=args.kv_block_size or None,
        kv_blocks=args.kv_blocks or None, scheduler=args.scheduler,
        overlap=args.overlap)
    qb, fb = packed_bytes(engine.params)
    if fb:
        print(f"quantized weights: {qb / 2**20:.1f} MiB vs {fb / 2**20:.1f} "
              f"MiB fp32 ({fb / max(qb, 1):.1f}x reduction)")
    reqs = make_requests(cfg, args.requests, args.prompt_len, args.gen,
                         mixed=args.mixed, temp=args.temp, top_k=args.top_k,
                         seed=args.seed)
    before = launch_counts()
    finished, dt = serve(engine, reqs)
    for out in finished:
        print(f"  req {out.id} done ({out.finish_reason}) "
              f"prompt={out.prompt_len} toks={out.tokens[:8]}"
              f"{'...' if len(out.tokens) > 8 else ''} "
              f"[ticks {out.admitted_tick}-{out.tick}]")
    st = engine.stats()
    total = st["prompt_tokens"] + st["generated_tokens"]
    print(f"{len(finished)} requests, {total} tokens in {dt:.2f}s = "
          f"{total / dt:.1f} tok/s on {device}, slot utilization "
          f"{st['slot_utilization']:.0%} (policy {args.policy}, backend "
          f"{args.backend}, arch {cfg.name}, {cfg.n_layers} layers)")
    print("kernel launches: " + ", ".join(
        f"{name} {n - before[name]}" for name, n in launch_counts().items()))
    if engine.paged:
        print(f"paged KV: {st['kv_blocks']} blocks x {st['kv_block_size']} "
              f"tokens, peak in use {st['peak_blocks_used']}")
    return finished


if __name__ == "__main__":
    main()
