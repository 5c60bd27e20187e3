"""Serving launcher — a thin CLI over the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_14b \\
        --policy flexpe-fxp8 --kv-block-size 16 --requests 8 --slots 4 \\
        --prompt-len 64 --mixed --gen 16

`--arch deepseek_moe_16b` serves the MoE family the same way,
`--arch mamba2_370m` the SSM family (Mamba2 layers, a recurrent state per
slot, no KV cache) and `--arch zamba2_1p2b` the hybrid family (Mamba2
layers with a shared attention block, its KV paged or contiguous);
`--prefix-cache` (paged KV only) shares the KV of common prompt prefixes
across requests with copy-on-write, and `--shared-prefix N` prepends a
common N-token system prompt to every request (a no-op on the SSM and
hybrid families, whose recurrent state cannot start mid-prompt).
`--policy edge4` serves FxP4 (packed-nibble weights, FxP4 activations),
and `--policy flexpe-fxp32` (or `flexpe-fxp24`) the PE's FxP32 mode
(int32 codes, every GEMM on the fused GEMM's x32 mode).
A precision-tiered fleet serves one replica per tier from one shared
`TieredWeights` bank (`--policy` does not apply there):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_14b \
        --tiers fxp4,fxp8,fxp16,bf16 --routing tiered --kv-block-size 16

`--spec-decode fxp4:bf16` (with `--spec-k`) serves cross-tier speculative
decoding: an fxp4 draft engine proposes k tokens a round and the bf16
verify engine scores them in one chunked dispatch (greedy requests only).
With `--tiers` the verify-tier replicas turn speculative and the draft
tier joins the bank; without, every replica is a draft/verify pair.

Builds random weights from `--seed` (quantize-once FxP codes for an FxP
policy), a `ServingEngine` over a paged or contiguous KV cache, submits
`--requests` greedy requests and prints each completion, tok/s and the
kernel launch counts (the fused GEMM's also by mode); a fleet also prints
its placements, tok/s and weight bytes per tier bank, and a speculative
fleet its acceptance and rollback counters. Runs on CUDA unless
`--device cpu` (the plain
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
from ..core.qtensor import TieredWeights, packed_bytes, quantize_params
from ..kernels.cordic_af.cordic_af import cordic_af
from ..kernels.cordic_softmax.cordic_softmax import cordic_softmax
from ..kernels.fxp_gemm.fxp_gemm import fxp_gemm_fused, reset_launches
from ..kernels.paged_attention.paged_attention import (paged_attention_float,
                                                      paged_attention_int)
from ..models import model as M
from ..serving import EngineRouter, Request, SamplingParams, ServingEngine
from ..serving.router import ROUTING_POLICIES
from ..serving.scheduler import POLICIES


#: the kernel wrappers of the serving path, each with its launch counter
KERNELS = {"fxp_gemm_fused": fxp_gemm_fused,
           "paged_attention_float": paged_attention_float,
           "cordic_af": cordic_af, "cordic_softmax": cordic_softmax,
           "paged_attention_int": paged_attention_int}


def launch_counts() -> dict:
    """{kernel name: launches so far} of every kernel of the path."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def gemm_mode_counts() -> dict:
    """{mode: launches so far} of the fused GEMM's kernel modes."""
    return dict(fxp_gemm_fused.launches_by_mode)


def reset_launch_counts():
    """Every kernel's launch count, and the GEMM's per mode, to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
    reset_launches()


def make_requests(cfg, n, prompt_len, gen, mixed=False, temp=0.0, top_k=0,
                  seed=0, shared_prefix=0, tier=None, priority=0):
    """n requests of random prompts from `seed`; `mixed` varies prompt
    lengths over [plen/2, plen] as the reference launcher does;
    `shared_prefix` prepends a common system prompt of that many tokens
    to every request (the prefix-cache workload); `tier` pins each to a
    precision tier, `priority` stamps its SLO class."""
    rng = np.random.default_rng(seed + 1)
    system = np.random.default_rng(seed + 1000).integers(
        0, cfg.vocab, size=shared_prefix).tolist()
    reqs = []
    for i in range(n):
        plen = (max(1, prompt_len - (i % 4) * (prompt_len // 8))
                if mixed else prompt_len)
        prompt = system + rng.integers(0, cfg.vocab, size=plen).tolist()
        reqs.append(Request(prompt=prompt, max_new_tokens=gen,
                            sampling=SamplingParams(temperature=temp,
                                                    top_k=top_k),
                            tier=tier, priority=priority))
    return reqs


def serving_params(cfg, policy, seed=0, device=None):
    """Random weights from `seed`, with quantize-once surgery for an FxP
    policy."""
    params = M.init_params(cfg, seed, device=device)
    if policy.matmul is not None:
        params = quantize_params(params, policy.matmul, consume=True)
    return params


def build_engine(cfg, policy, *, seed=0, device=None, **engine_kw):
    """`serving_params` and the engine over them."""
    return ServingEngine(cfg, serving_params(cfg, policy, seed, device),
                         policy=policy, seed=seed, device=device,
                         **engine_kw)


def build_fleet(cfg, tiers, *, backend="kernels", seed=0, device=None,
                spec_decode=None, **router_kw):
    """Random weights from `seed`, one `TieredWeights` bank over `tiers`
    and the tiers of the `spec_decode` pair "draft:verify" (each float
    weight dropped once its tier codes exist, unless bf16 is served), and
    an `EngineRouter` over it: one replica per tier, the verify tier's a
    speculative pair, or with no `tiers` the router's `engines` replicas,
    each a speculative pair."""
    params = M.init_params(cfg, seed, device=device)
    pair = spec_decode.split(":") if spec_decode else []
    bank = TieredWeights(params, list(tiers) + pair, consume=True)
    return EngineRouter(cfg, bank, tiers=list(tiers) or None,
                        backend=backend, seed=seed, device=device,
                        spec_decode=spec_decode, **router_kw)


def serve(engine, reqs):
    """Submit `reqs`, drain the event stream; -> (finished outputs sorted
    by id, seconds)."""
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    finished = [out for out in engine.events() if out.finished]
    if torch.cuda.is_available():
        torch.cuda.synchronize()
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
    ap.add_argument("--prefix-cache", action="store_true",
                    help="cross-request prefix caching over the paged "
                         "pool (copy-on-write block sharing; requires "
                         "--kv-block-size)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend a common system prompt of N tokens to "
                         "every request (prefix-cache workload)")
    ap.add_argument("--policy", default="flexpe-fxp8")
    ap.add_argument("--backend", default="kernels", choices=list(BACKENDS))
    ap.add_argument("--temp", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "path)")
    ap.add_argument("--engines", type=int, default=1,
                    help="replicas behind one EngineRouter (untiered)")
    ap.add_argument("--routing", default="least-loaded",
                    choices=list(ROUTING_POLICIES))
    ap.add_argument("--stickiness", type=int, default=None,
                    help="prefix-affinity: the load lead the affinity "
                         "replica may have before a request spills")
    ap.add_argument("--tiers", default="",
                    help="comma-separated ladder tiers (fxp4,fxp8,fxp16,"
                         "bf16): one replica each over one TieredWeights "
                         "bank (overrides --engines and --policy)")
    ap.add_argument("--tier-threshold", type=float, default=1.0,
                    help="queue pressure above which a priority-0 request "
                         "degrades to a cheaper tier")
    ap.add_argument("--pin-tier", default=None,
                    help="pin every request to this tier")
    ap.add_argument("--priority", type=int, default=0,
                    help="SLO class of every request: > 0 best tier, < 0 "
                         "cheapest, 0 degrades under pressure")
    ap.add_argument("--spec-decode", default=None, metavar="DRAFT:VERIFY",
                    help="cross-tier speculative decoding, e.g. fxp4:bf16: "
                         "a draft engine proposes --spec-k tokens a round, "
                         "the verify engine scores them in one dispatch "
                         "(greedy only). With --tiers the verify-tier "
                         "replicas turn speculative; without, every "
                         "replica does (--policy does not apply)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="speculative draft depth a round "
                         "(k <= --prefill-chunk + 1)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    tiers = [t for t in args.tiers.split(",") if t]
    common = dict(max_slots=args.slots,
                  max_len=args.prompt_len + args.shared_prefix + args.gen,
                  prefill_chunk=args.prefill_chunk,
                  kv_block_size=args.kv_block_size or None,
                  kv_blocks=args.kv_blocks or None,
                  prefix_cache=args.prefix_cache, scheduler=args.scheduler,
                  overlap=args.overlap)
    if tiers or args.spec_decode:
        fleet_kw = (dict(tier_threshold=args.tier_threshold) if tiers
                    else dict(engines=args.engines))
        engine = build_fleet(cfg, tiers, backend=args.backend,
                             seed=args.seed, device=device,
                             spec_decode=args.spec_decode,
                             spec_k=args.spec_k, routing=args.routing,
                             stickiness=args.stickiness, **fleet_kw,
                             **common)
        bank = engine.tiered_weights
        per_tier = bank.bytes_by_tier()
        print("tiered weight banks: " + ", ".join(
            f"{t} {per_tier[t] / 2**20:.1f} MiB" for t in bank.tier_names))
    else:
        policy = PrecisionPolicy.from_name(args.policy, backend=args.backend)
        params = serving_params(cfg, policy, args.seed, device)
        qb, fb = packed_bytes(params)
        if fb:
            print(f"quantized weights: {qb / 2**20:.1f} MiB vs "
                  f"{fb / 2**20:.1f} MiB fp32 ({fb / max(qb, 1):.1f}x "
                  "reduction)")
        if args.engines > 1:
            engine = EngineRouter(cfg, params, engines=args.engines,
                                  policy=policy, routing=args.routing,
                                  stickiness=args.stickiness, seed=args.seed,
                                  device=device, **common)
        else:
            engine = ServingEngine(cfg, params, policy=policy, seed=args.seed,
                                   device=device, **common)
    reqs = make_requests(cfg, args.requests, args.prompt_len, args.gen,
                         mixed=args.mixed, temp=args.temp, top_k=args.top_k,
                         seed=args.seed, shared_prefix=args.shared_prefix,
                         tier=args.pin_tier,
                         priority=args.priority)
    before, modes_before = launch_counts(), gemm_mode_counts()
    finished, dt = serve(engine, reqs)
    for out in finished:
        print(f"  req {out.id} done ({out.finish_reason}) "
              f"prompt={out.prompt_len} toks={out.tokens[:8]}"
              f"{'...' if len(out.tokens) > 8 else ''} "
              f"[ticks {out.admitted_tick}-{out.tick}]")
    st = engine.stats()
    total = st["prompt_tokens"] + st["generated_tokens"]
    served = "tiers " + args.tiers if tiers else args.policy
    if args.spec_decode:
        served = (served + ", " if tiers else "") + "spec " + args.spec_decode
    print(f"{len(finished)} requests, {total} tokens in {dt:.2f}s = "
          f"{total / dt:.1f} tok/s on {device}, slot utilization "
          f"{st['slot_utilization']:.0%} (policy {served}, backend "
          f"{args.backend}, arch {cfg.name}, {cfg.n_layers} layers)")
    print("kernel launches: " + ", ".join(
        f"{name} {n - before[name]}" for name, n in launch_counts().items()))
    print("fxp_gemm_fused launches by mode: " + ", ".join(
        f"{m} {n - modes_before[m]}" for m, n in gemm_mode_counts().items()))
    if isinstance(engine, EngineRouter):
        if "spec_decode" in st:
            print(f"speculative: {st['spec_decode']} k={st['spec_k']}, "
                  f"{st['spec_accepted']}/{st['spec_proposed']} draft "
                  f"tokens accepted ({st['spec_acceptance_rate']:.0%}), "
                  f"{st['spec_verify_steps']} verify steps, "
                  f"{st['spec_rolled_back']} tokens rolled back")
        print(f"router: {st['engines']} engines, routing "
              f"{st['routing_policy']}, dispatched {st['dispatched']}")
        if "tier_placed" in st:
            placed = ", ".join(f"{t}: {n}"
                               for t, n in st["tier_placed"].items())
            print(f"tiers: placed {{{placed}}}, {st['tier_pinned']} pinned, "
                  f"{st['tier_degraded']} degraded under pressure "
                  f"(threshold {st['tier_threshold']:.2f})")
        for i, pe in enumerate(st["per_engine"]):
            tag = f" [{pe['tier']}]" if pe["tier"] else ""
            print(f"  engine {i}{tag}: {pe['dispatched']} requests, "
                  f"{pe['generated_tokens']} generated tokens "
                  f"({pe['generated_tokens'] / dt:.1f} tok/s), slot "
                  f"utilization {pe['slot_utilization']:.0%}")
        return finished
    if engine.paged:
        print(f"paged KV: {st['kv_blocks']} blocks x {st['kv_block_size']} "
              f"tokens, peak in use {st['peak_blocks_used']}")
    if "prefix_cache" in st:
        pc = st["prefix_cache"]
        print(f"prefix cache: {st['prefix_tokens_reused']} prompt tokens "
              f"reused ({st['prefill_tokens_computed']} computed), "
              f"{pc['hits']} block hits, {pc['evictions']} evictions, "
              f"{st['cow_copies']} CoW forks")
    return finished


if __name__ == "__main__":
    main()
