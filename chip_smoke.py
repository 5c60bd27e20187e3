"""On-card smoke test of the PyTorch/CUDA port (repro_torch) on one H100.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero before the last line:
  1. card     — `nvidia-smi` name and power limit;
  2. build    — nvcc builds every kernel under src/repro_torch/csrc, all
                at once;
  3. kernels  — each kernel against its plain PyTorch version on the card
                at the main paths' shapes, with its time, the plain
                version's time and its bound: the GEMM (bit-equal) at the
                dense projections and, batched over 64 experts, at the MoE
                banks; the attention (within 1%) at g 5 and g 1, and at
                long rows whose score row lives in a global scratch row;
                the CORDIC AF (bit-equal) at the MoE expert activations;
                the CORDIC softmax (bit-equal) at the router's rows and a
                wide row;
  4. check    — reduced Qwen2.5-14B and reduced DeepSeekMoE-16B, each
                served through the kernels and through the plain path on
                the card: the same greedy tokens;
  5. serve    — full-width Qwen2.5-14B (all 48 layers) and then full-width
                DeepSeekMoE-16B (all 28 layers), each with FxP8
                quantize-once weights from seed 0, paged int8 KV (block
                16), 4 slots, 8 mixed requests (prompts 40-64), 16 greedy
                tokens each, prefill chunk 16, overlap loop; the launches
                of every kernel counted over each serve run (set to 0 just
                before it) and per decode step against the model's count,
                tokens identical on a rerun, one decode step of the rerun
                traced with the profiler (kernel device time and the
                device's idle share), memory on the card and its peak.
The second-to-last lines are the card line and the kernels JSON; the last
line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
INT8_OPS_PER_S = 1.979e15      # H100 SXM dense int8 tensor-core peak
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
SLOTS = 4


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time per call of `fn()` between CUDA events around `iters`
    back-to-back calls: device time when the device is the bottleneck,
    the host's launch time when the host is."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_records(prof) -> dict:
    """{record name: (count, device ms)} of a profiler's device records."""
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t > 0:
            out[ev.key] = (ev.count, t / 1e3)
    return out


def matching(records: dict, match: str | None):
    """(launches, device ms) of the records whose name contains `match`
    (every record when None)."""
    sel = [v for k, v in records.items() if match is None or match in k]
    return sum(c for c, _ in sel), sum(ms for _, ms in sel)


def device_ms(fn, iters: int, match: str | None = None):
    """Mean device time per call of `fn()` from the profiler's CUDA kernel
    records: the kernels whose name contains `match`, or every kernel the
    call launches. None when the profiler records no device time."""
    fn()
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = matching(device_records(prof), match)[1]
    return total / iters if total > 0 else None


TIMING = {"source": "profiler"}     # set to "cuda events" on fallback


def timed(fn, iters: int, match: str | None = None) -> float:
    """Device time per call (profiler), else the CUDA-event time."""
    ms = device_ms(fn, iters, match)
    if ms is None:
        TIMING["source"] = "cuda events"
        return cuda_ms(fn, iters)
    return ms


def bound_ms(nbytes: float, ops: float, ops_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def gemm_phase(dev, gen):
    from repro_torch.kernels.fxp_gemm.fxp_gemm import (
        fxp_gemm_fused, fxp_gemm_fused_plain)
    # (M, K, N, af) of the full-width model
    shapes = [(SLOTS, 5120, 5120, None),       # wq, wo
              (SLOTS, 5120, 1024, None),       # wk, wv
              (SLOTS, 5120, 13824, "silu"),    # w1 + fused silu
              (SLOTS, 5120, 13824, None),      # w3
              (SLOTS, 13824, 5120, None),      # w2
              (SLOTS, 5120, 152064, None),     # lm_head
              (16, 5120, 5120, None)]          # a prefill chunk
    rows, worst = [], 0.0
    for m, k, n, af in shapes:
        x = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        scale = torch.rand((n,), generator=gen, device=dev) * 1e-4
        got = fxp_gemm_fused(x, w, scale, af=af)
        ref = fxp_gemm_fused_plain(x, w, scale, af=af)
        torch.cuda.synchronize()
        if af is None:
            if not torch.equal(got, ref):
                fail(f"fxp_gemm_fused {m}x{k}x{n}: not bit-equal to plain")
            err = 0.0
        else:
            # same f32 operations in the same order: at most 1 ulp apart
            err = (got - ref).abs().max().item()
            ulp = torch.finfo(torch.float32).eps * ref.abs().max().item()
            if err > ulp:
                fail(f"fxp_gemm_fused {m}x{k}x{n}+{af}: max |err| {err} "
                     f"> 1 ulp ({ulp})")
        worst = max(worst, err)
        ms = timed(lambda: fxp_gemm_fused(x, w, scale, af=af), 20,
                   "fxp_gemm_fused_kernel")
        call_ms = cuda_ms(lambda: fxp_gemm_fused(x, w, scale, af=af), 20)
        pms = timed(lambda: fxp_gemm_fused_plain(x, w, scale, af=af), 3)
        nbytes = m * k + k * n + 4 * n + 4 * m * n
        bms, by = bound_ms(nbytes, 2.0 * m * k * n, INT8_OPS_PER_S)
        rows.append(dict(m=m, k=k, n=n, af=af, ms=ms, plain_ms=pms,
                         bound_ms=bms, bound_by=by, max_abs_err=err,
                         call_ms=call_ms))
        print(f"kernel fxp_gemm_fused M={m} K={k} N={n} af={af}: "
              f"{ms:.4f} ms on the device, {call_ms:.4f} ms per wrapper "
              f"call (plain {pms:.4f} ms, bound {bms:.4f} ms by "
              f"{by}, {100 * bms / ms:.1f}% of bound), max|err| {err}",
              flush=True)
    return rows, worst


def batched_gemm_phase(dev, gen):
    """The expert-batched entry at the DeepSeekMoE banks (E 64; 4 queue
    slots per expert at decode, 16 per prefill chunk: a queue holds at
    most one row per token; silu not fused, as the MoE path calls it):
    bit-equal to its plain per-expert loop. At decode 4 tokens x top-6
    fill 24 of the 64 x 4 rows; the kernel skips the products of zero
    rows and the weight bytes of experts with none, so the bound counts
    the weights of the experts this input routes to. The last shape fills
    every row: the whole bank is read."""
    from repro_torch.kernels.fxp_gemm.fxp_gemm import (
        fxp_gemm_fused_batched, fxp_gemm_fused_batched_plain)
    e, top_k = 64, 6
    for m, k, n, tokens in ((SLOTS, 2048, 1408, SLOTS),
                            (SLOTS, 1408, 2048, SLOTS),
                            (16, 2048, 1408, 16),
                            (SLOTS, 2048, 1408, None)):
        x = torch.zeros((e, m, k), dtype=torch.int8, device=dev)
        if tokens is None:          # every queue full: all 64 banks read
            x.random_(-127, 128, generator=gen)
        else:                       # each token's top-6 experts, in turn
            choice = torch.stack([torch.randperm(e, generator=gen,
                                                 device=dev)[:top_k]
                                  for _ in range(tokens)])
            for t in range(tokens):
                for ex in choice[t].tolist():
                    slot = int((x[ex].abs().sum(-1) > 0).sum())
                    x[ex, slot].random_(-127, 128, generator=gen)
                    x[ex, slot, 0] = 1      # no all-zero filled row
        w = torch.randint(-127, 128, (e, k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        scale = torch.rand((e, 1, n), generator=gen, device=dev) * 1e-4
        got = fxp_gemm_fused_batched(x, w, scale)
        ref = fxp_gemm_fused_batched_plain(x, w, scale.reshape(e, n))
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"fxp_gemm_fused batched E={e} M={m} K={k} N={n}: not "
                 "bit-equal to the per-expert loop")
        ms = timed(lambda: fxp_gemm_fused_batched(x, w, scale), 20,
                   "fxp_gemm_fused_kernel")
        pms = timed(lambda: fxp_gemm_fused_batched_plain(
            x, w, scale.reshape(e, n)), 2)
        active = int((x.reshape(e, -1) != 0).any(-1).sum())
        filled = int((x != 0).any(-1).sum())
        nbytes = e * m * k + active * k * n + 4 * e * n + 4 * e * m * n
        bms, by = bound_ms(nbytes, 2.0 * filled * k * n, INT8_OPS_PER_S)
        occupancy = ("all queues full" if tokens is None else
                     f"{tokens} tokens x top-{top_k}: {filled} filled rows "
                     f"in {active} experts")
        print(f"kernel fxp_gemm_fused batched E={e} M={m} K={k} N={n} "
              f"({occupancy}): {ms:.4f} ms on the device (plain loop "
              f"{pms:.4f} ms, bound {bms:.4f} ms by {by}, "
              f"{100 * bms / ms:.1f}% of bound), bit-equal", flush=True)


def paged_attention_inputs(dev, gen, quant: bool, lengths, kvh=8, g=5):
    """Pools, tables and metadata for SLOTS rows holding `lengths` cached
    tokens each, in blocks shuffled over the pool, tables ending in
    sentinel entries."""
    hd, bs = 128, 16
    mb = -(-(max(lengths) + 1) // bs) + 2      # sentinel tail entries
    need = [-(-(n + 1) // bs) for n in lengths]
    nb = sum(need) + 8
    perm = torch.randperm(
        nb, generator=torch.Generator().manual_seed(nb)).tolist()
    tables = torch.full((SLOTS, mb), nb, dtype=torch.int32)
    it = iter(perm)
    for b, n_blk in enumerate(need):
        for j in range(n_blk):
            tables[b, j] = next(it)
    shape = (nb, bs, kvh, hd)
    if quant:
        k = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        ks = torch.rand((nb, bs, kvh, 1), generator=gen, device=dev) * 0.02
        vs = torch.rand((nb, bs, kvh, 1), generator=gen, device=dev) * 0.02
    else:
        k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        ks = vs = None
    q = torch.randn((SLOTS, kvh, g, hd), generator=gen,
                    device=dev).to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32)
    meta = torch.stack([lens, lens + 1, lens], dim=1).to(dev)
    alloc_blocks = sum(need)
    return (q, k, v, ks, vs, tables.to(dev), meta, alloc_blocks,
            sum(n + 1 for n in lengths))


def attention_phase(dev, gen):
    from repro_torch.core.activation import softmax_lv_stages
    from repro_torch.kernels.paged_attention.paged_attention import (
        paged_attention_float, paged_attention_float_plain, scores_in_scratch)
    result = None
    short, long_ = [1024, 1536, 2000, 1200], [12000, 9000, 11000, 4000]
    # (int8 pool + CORDIC softmax, cached tokens per row, KV heads, query
    # heads per KV head): Qwen2.5-14B's g 5, DeepSeekMoE-16B's g 1; the
    # long rows' score row does not fit in shared memory
    for quant, lengths, kvh, g in ((True, short, 8, 5), (False, short, 8, 5),
                                   (True, long_, 8, 5), (True, short, 16, 1)):
        cordic_sm = quant
        (q, k, v, ks, vs, tables, meta, alloc_blocks,
         valid) = paged_attention_inputs(dev, gen, quant, lengths, kvh, g)
        width = tables.shape[1] * k.shape[1]
        scratch = scores_in_scratch(q.shape[2], q.shape[3], width)
        if scratch != (lengths is long_):
            fail(f"paged_attention_float at table width {width}: score row "
                 f"{'in' if scratch else 'not in'} global scratch")
        kw = dict(k_scale=ks, v_scale=vs, cordic_softmax=cordic_sm,
                  hr_stages=4,
                  lv_stages=softmax_lv_stages(width, "fxp8"),
                  out_dtype=torch.bfloat16)
        got = paged_attention_float(q, k, v, tables, meta, **kw)
        ref = paged_attention_float_plain(q, k, v, tables, meta, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            fail("paged_attention_float: non-finite output")
        err = (got.float() - ref.float()).abs().max().item()
        # bf16 output, reductions in another order than the plain einsums:
        # within 1% of the output's range
        tol = 1e-2 * ref.float().abs().max().item()
        body = ("dequant+cordic" if quant else "bf16+exact") + (
            ", scores in global scratch" if scratch else "")
        if err > tol:
            fail(f"paged_attention_float ({body}): max |err| {err} > {tol}")
        ms = timed(lambda: paged_attention_float(q, k, v, tables, meta,
                                                 **kw), 20,
                   "paged_attention_kernel")
        pms = timed(lambda: paged_attention_float_plain(
            q, k, v, tables, meta, **kw), 3)
        b, kvh, g, hd = q.shape
        bs = k.shape[1]
        per_pos = kvh * hd * k.element_size() * 2 + (8 * kvh if quant else 0)
        nbytes = (alloc_blocks * bs * per_pos + q.numel() * 2
                  + b * kvh * g * hd * 2 + tables.numel() * 4 + meta.numel()
                  * 4)
        ops = 4.0 * valid * kvh * g * hd
        bms, by = bound_ms(nbytes, ops, F32_OPS_PER_S)
        print(f"kernel paged_attention_float {body} B={b} KV={kvh} g={g} "
              f"hd={hd} bs={bs} MB={tables.shape[1]}: {ms:.4f} ms (plain "
              f"{pms:.4f} ms, bound {bms:.4f} ms by {by}, "
              f"{100 * bms / ms:.1f}% of bound), max|err| {err} "
              f"(tol {tol:.4g})", flush=True)
        if result is None:
            result = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                          max_abs_err=err)
    return result


# f32 operations per element, counted from csrc/cordic.cuh at FxP8's stage
# counts (4 HR stages, LV 5 for the AF, 12 for the 64-way softmax): the HR
# exp ~45 (clamp, range reduction, 4 stages of 9, 2^k), an LV stage 7
CORDIC_SILU_OPS = 45 + 3 + 5 * 7 + 1
CORDIC_SOFTMAX_OPS = 2 + 45 + 1 + 12 * 7


def cordic_af_phase(dev, gen):
    """The CORDIC AF kernel at the MoE expert activations (silu; 64
    experts x 4 queue slots x 1408 at decode, x 16 per prefill chunk, and
    the shared experts' 4 x 2816), bit-equal to its plain version."""
    from repro_torch.kernels.cordic_af.cordic_af import (
        cordic_af, cordic_af_plain, cordic_af_reference)
    rows = []
    for shape in ((1, 64, SLOTS, 1408), (1, 64, 16, 1408), (1, SLOTS, 2816)):
        x = torch.randn(shape, generator=gen, device=dev) * 3
        for precision in ("fxp8", None):
            got = cordic_af(x, "silu", precision=precision)
            ref = (cordic_af_plain(x, "silu", 4, 5) if precision is None
                   else cordic_af_reference(x, "silu", precision=precision))
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                err = (got - ref).abs().max().item()
                fail(f"cordic_af silu {shape} precision {precision}: max "
                     f"|err| {err}, not bit-equal to the plain version")
        n = x.numel()
        ms = timed(lambda: cordic_af(x, "silu"), 20, "cordic_af_kernel")
        pms = timed(lambda: cordic_af_plain(x, "silu", 4, 5), 3)
        bms, by = bound_ms(8.0 * n, CORDIC_SILU_OPS * n, F32_OPS_PER_S)
        rows.append(dict(shape=shape, ms=ms, plain_ms=pms, bound_ms=bms,
                         bound_by=by, max_abs_err=0.0))
        print(f"kernel cordic_af silu {list(shape)}: {ms:.4f} ms (plain "
              f"{pms:.4f} ms, bound {bms:.4f} ms by {by}, "
              f"{100 * bms / ms:.1f}% of bound), bit-equal with and "
              f"without the FxP8 snaps", flush=True)
    return rows


def cordic_softmax_phase(dev, gen):
    """The CORDIC softmax kernel at the router's rows (4 decode tokens, one
    16-token prefill chunk, 64 experts, lv 12) and at a wide row (the
    lane loop over 4096 columns), bit-equal to its plain version."""
    from repro_torch.core.activation import softmax_lv_stages
    from repro_torch.kernels.cordic_softmax.cordic_softmax import (
        cordic_softmax, cordic_softmax_plain, cordic_softmax_reference)
    rows = []
    for m, n in ((SLOTS, 64), (16, 64), (8, 4096)):
        x = torch.randn((m, n), generator=gen, device=dev) * 2
        lv = softmax_lv_stages(n, "fxp8")
        got = cordic_softmax(x, precision="fxp8")
        ref = cordic_softmax_reference(x, precision="fxp8")
        raw = cordic_softmax(x, hr_stages=4, lv_stages=lv)
        raw_ref = cordic_softmax_plain(x, 4, lv)
        torch.cuda.synchronize()
        for a, b, what in ((got, ref, "FxP8 op"), (raw, raw_ref, "rows")):
            if not torch.equal(a, b):
                fail(f"cordic_softmax [{m}, {n}] ({what}): max |err| "
                     f"{(a - b).abs().max().item()}, not bit-equal to the "
                     "plain version")
        if (raw.sum(-1) - 1).abs().max().item() > n * 2.0 ** -(lv - 1):
            fail(f"cordic_softmax [{m}, {n}]: rows do not sum to 1")
        ms = timed(lambda: cordic_softmax(x, hr_stages=4, lv_stages=lv), 20,
                   "cordic_softmax_kernel")
        pms = timed(lambda: cordic_softmax_plain(x, 4, lv), 3)
        bms, by = bound_ms(8.0 * m * n, CORDIC_SOFTMAX_OPS * m * n,
                           F32_OPS_PER_S)
        rows.append(dict(shape=(m, n), ms=ms, plain_ms=pms, bound_ms=bms,
                         bound_by=by, max_abs_err=0.0))
        print(f"kernel cordic_softmax [{m}, {n}] lv={lv}: {ms:.4f} ms "
              f"(plain {pms:.4f} ms, bound {bms:.6f} ms by {by}), "
              f"bit-equal", flush=True)
    return rows


# ---------------------------------------------------------------------------
# phases 4-5: serving
# ---------------------------------------------------------------------------

def serve_tokens(engine, reqs):
    from repro_torch.launch.serve import serve
    finished, dt = serve(engine, reqs)
    return [o.tokens for o in finished], finished, dt


def check_phase(dev, arch):
    """The reduced model through the kernels and through the plain path,
    both on the card: the same greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.launch.serve import build_engine, make_requests
    cfg = get_config(arch).reduced()
    toks = {}
    for backend in ("kernels", "reference"):
        eng = build_engine(cfg, PrecisionPolicy.flexpe(8, backend=backend),
                           seed=0, device=dev, max_slots=SLOTS, max_len=48,
                           prefill_chunk=16, kv_block_size=16, overlap=True)
        reqs = make_requests(cfg, 6, 32, 16, mixed=True, seed=0)
        toks[backend] = serve_tokens(eng, reqs)[0]
    if toks["kernels"] != toks["reference"]:
        fail(f"reduced {arch}: kernels {toks['kernels']} != plain "
             f"{toks['reference']}")
    print(f"check reduced {arch}: kernels == plain path on the card, "
          f"{sum(map(len, toks['kernels']))} greedy tokens", flush=True)


#: each kernel wrapper's name and the name of its device record
RECORDS = {"fxp_gemm_fused": "fxp_gemm_fused_kernel",
           "paged_attention_float": "paged_attention_kernel",
           "cordic_af": "cordic_af_kernel",
           "cordic_softmax": "cordic_softmax_kernel"}


def launches_per_decode_step(cfg) -> dict:
    """The launches one decode step must make: per layer the q/k/v/o
    GEMMs, one attention, and the FFN's GEMMs (w1/w3/w2, or the three
    expert banks and the three shared-expert GEMMs of a MoE block, whose
    expert and shared activations and router softmax are one CORDIC
    launch each); one lm_head GEMM."""
    moe = cfg.family == "moe"
    return {"fxp_gemm_fused": cfg.n_layers * (4 + (6 if moe else 3)) + 1,
            "paged_attention_float": cfg.n_layers,
            "cordic_af": 2 * cfg.n_layers if moe else 0,
            "cordic_softmax": cfg.n_layers if moe else 0}


def serve_phase(dev, arch):
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.launch.serve import (KERNELS, build_engine,
                                          launch_counts, make_requests)
    cfg = get_config(arch)
    gen_tokens, prompt_len = 16, 64
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = build_engine(cfg, PrecisionPolicy.flexpe(8, backend="kernels"),
                          seed=0, device=dev, max_slots=SLOTS,
                          max_len=prompt_len + gen_tokens, prefill_chunk=16,
                          kv_block_size=16, overlap=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    gib = 2 ** 30
    setup_peak = torch.cuda.max_memory_allocated() / gib
    print(f"serve setup: full-width {arch}, {cfg.n_layers} layers, random "
          f"weights quantized to FxP8 in {setup_s:.1f} s, "
          f"{torch.cuda.memory_allocated() / gib:.2f} GiB on the card, "
          f"peak {setup_peak:.2f} GiB while building", flush=True)
    expect = launches_per_decode_step(cfg)
    path = [name for name, n in expect.items() if n]

    def counts():
        return tuple(launch_counts()[name] for name in path)

    # each decode step: its span on the device stream (events, no sync),
    # the host time to enqueue it, and the kernel launches it made
    ex = engine.ex
    spans = []
    decode = ex.decode_and_sample

    def timed_decode(*a, **kw):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        c0 = counts()
        h0 = time.perf_counter()
        s.record()
        out = decode(*a, **kw)
        e.record()
        c1 = counts()
        spans.append((s, e, time.perf_counter() - h0,
                      tuple(b - a for a, b in zip(c0, c1))))
        return out
    ex.decode_and_sample = timed_decode

    reqs = make_requests(cfg, 8, prompt_len, gen_tokens, mixed=True, seed=0)
    torch.cuda.reset_peak_memory_stats()
    for name in KERNELS:
        KERNELS[name].launches = 0
    toks, finished, dt = serve_tokens(engine, reqs)
    launches = {name: KERNELS[name].launches for name in path}
    serve_peak = torch.cuda.max_memory_allocated() / gib
    n_decode = len(spans)
    dev_ms = statistics.median(s.elapsed_time(e) for s, e, _, _ in spans)
    host_ms = 1e3 * statistics.median(h for _, _, h, _ in spans)
    per_step = sorted({c for _, _, _, c in spans})

    if len(finished) != len(reqs):
        fail(f"serve {arch}: {len(finished)} of {len(reqs)} requests "
             "finished")
    for o in finished:
        if len(o.tokens) != gen_tokens or not all(
                0 <= t < cfg.vocab for t in o.tokens):
            fail(f"serve {arch}: request {o.id} returned {o.tokens}")
    for name, n in launches.items():
        if n == 0:
            fail(f"serve {arch}: kernel {name} was never launched")
    if per_step != [tuple(expect[name] for name in path)]:
        fail(f"serve {arch}: launches per decode step {per_step} of "
             f"{path}, the model needs {[expect[n] for n in path]}")
    st = engine.stats()
    total = st["prompt_tokens"] + st["generated_tokens"]
    print(f"serve {arch}: {len(finished)} requests, {st['prompt_tokens']} "
          f"prompt + {st['generated_tokens']} generated tokens in {dt:.3f} "
          f"s = {total / dt:.1f} tok/s ({st['generated_tokens'] / dt:.1f} "
          f"generated tok/s); {n_decode} decode steps, median "
          f"{dev_ms:.2f} ms on the device stream, {host_ms:.2f} ms to "
          f"enqueue; launches {launches}, per decode step "
          f"{dict(zip(path, per_step[0]))}; peak {serve_peak:.2f} GiB on "
          f"the card while serving", flush=True)

    # rerun: the same tokens; its middle decode step synced on both sides
    # and traced, so the trace holds that step's kernels and nothing else
    target, calls, trace = n_decode // 2, [], {}

    def traced_decode(*a, **kw):
        calls.append(None)
        if len(calls) - 1 != target:
            return decode(*a, **kw)
        torch.cuda.synchronize()
        act = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=act) as prof:
            c0 = counts()
            h0 = time.perf_counter()
            out = decode(*a, **kw)
            torch.cuda.synchronize()
            trace["wall_ms"] = 1e3 * (time.perf_counter() - h0)
            c1 = counts()
        trace["counted"] = tuple(b - a for a, b in zip(c0, c1))
        trace["records"] = device_records(prof)
        return out
    ex.decode_and_sample = traced_decode
    again, _, dt2 = serve_tokens(engine, make_requests(
        cfg, 8, prompt_len, gen_tokens, mixed=True, seed=0))
    ex.decode_and_sample = decode
    if again != toks:
        fail(f"serve {arch}: rerun of the same workload gave other tokens")
    print(f"serve {arch} rerun: identical tokens ({dt2:.3f} s); first "
          f"request {toks[0]}", flush=True)

    rec = trace["records"]
    kern = {name: matching(rec, RECORDS[name]) for name in path}
    n_all, all_ms = matching(rec, None)
    if tuple(kern[name][0] for name in path) != trace["counted"]:
        fail(f"traced decode step of {arch}: kernel records "
             f"{ {n: c for n, (c, _) in kern.items()} }, the counters say "
             f"{trace['counted']}")
    kern_ms = sum(ms for _, ms in kern.values())
    idle = 1.0 - all_ms / trace["wall_ms"]
    print(f"traced decode step of {arch} (rerun step {target} of "
          f"{n_decode}, synced, under the profiler): "
          f"{trace['wall_ms']:.3f} ms wall; device time {all_ms:.3f} ms in "
          f"{n_all} records = " + " + ".join(
              f"{c} {name} {ms:.3f} ms" for name, (c, ms) in kern.items())
          + f" + {n_all - sum(c for c, _ in kern.values())} other "
          f"{all_ms - kern_ms:.3f} ms; device idle {100 * idle:.1f}% of the "
          "step", flush=True)
    top = sorted(rec.items(), key=lambda kv: -kv[1][1])[:8]
    print(f"traced decode step of {arch}, largest device records: "
          + "; ".join(f"{k[:60]} x{c} {ms:.3f} ms" for k, (c, ms) in top),
          flush=True)
    ex.decode_and_sample = decode
    return launches, dict(
        arch=arch, layers=cfg.n_layers, setup_s=setup_s,
        gib_on_card=torch.cuda.memory_allocated() / gib,
        setup_peak_gib=setup_peak, serve_peak_gib=serve_peak,
        tok_s=total / dt, generated_tok_s=st["generated_tokens"] / dt,
        decode_ms=dev_ms, enqueue_ms=host_ms, seconds=dt,
        launches_per_decode_step=dict(zip(path, per_step[0])),
        traced_step=dict(wall_ms=trace["wall_ms"], device_ms=all_ms,
                         idle_share=idle, kernels={
                             name: dict(launches=c, ms=ms)
                             for name, (c, ms) in kern.items()}))


def kernel_entry(name, source, replaces, row, launches, **extra):
    return dict({"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches["deepseek_moe_16b"]
                 .get(name, 0), "max_abs_err": row["max_abs_err"],
                 "ms": row["ms"], "plain_ms": row["plain_ms"],
                 "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                 "library_ms": None, "timing": TIMING["source"],
                 "launches_by_path": {arch: n.get(name, 0)
                                      for arch, n in launches.items()}},
                **extra)


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke runs on a GPU")
    try:
        from repro_torch.kernels import build as kbuild
    except ImportError as e:
        fail(f"the repro_torch package is missing beside chip_smoke.py: {e}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    built = kbuild.build()
    for name, (path, secs, log) in built.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"build {name}: {path.name} in {secs:.1f} s; "
              + " | ".join(regs), flush=True)
    print(f"build: {len(built)} kernels in {time.perf_counter() - t0:.1f} s "
          f"(nvcc sm_90a, in parallel)", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    gemm_rows, gemm_err = gemm_phase(dev, gen)
    batched_gemm_phase(dev, torch.Generator(device=dev).manual_seed(2))
    attn = attention_phase(dev, torch.Generator(device=dev).manual_seed(1))
    af_rows = cordic_af_phase(dev, torch.Generator(device=dev).manual_seed(3))
    sm_rows = cordic_softmax_phase(
        dev, torch.Generator(device=dev).manual_seed(4))
    for arch in ("qwen2_5_14b", "deepseek_moe_16b"):
        check_phase(dev, arch)
    launches, summaries = {}, []
    for arch in ("qwen2_5_14b", "deepseek_moe_16b"):
        launches[arch], summary = serve_phase(dev, arch)
        summaries.append(summary)
        gc.collect()                 # the engine and its weights go here
        torch.cuda.empty_cache()

    w1 = next(r for r in gemm_rows if r["af"] == "silu")
    w1["max_abs_err"] = gemm_err
    kernels = [
        kernel_entry("fxp_gemm_fused", "src/repro_torch/csrc/fxp_gemm.cu",
                     "src/repro/kernels/fxp_gemm/fxp_gemm.py:158", w1,
                     launches, call_ms=w1["call_ms"],
                     shape=f"M={w1['m']} K={w1['k']} N={w1['n']} +silu "
                           "(Qwen2.5-14B w1)"),
        kernel_entry("paged_attention_float",
                     "src/repro_torch/csrc/paged_attention.cu",
                     "src/repro/kernels/paged_attention/paged_attention.py"
                     ":172", attn, launches,
                     shape="B=4 KV=8 g=5 hd=128 bs=16, 1024-2000 cached "
                           "tokens, int8 pool, CORDIC softmax"),
        kernel_entry("cordic_af", "src/repro_torch/csrc/cordic_af.cu",
                     "src/repro/kernels/cordic_af/cordic_af.py:89",
                     af_rows[0], launches,
                     shape="silu [1, 64, 4, 1408] (expert activations at "
                           "decode)"),
        kernel_entry("cordic_softmax", "src/repro_torch/csrc/cordic_softmax.cu",
                     "src/repro/kernels/cordic_softmax/cordic_softmax.py:33",
                     sm_rows[0], launches,
                     shape="[4, 64], lv 12 (router at decode)"),
    ]
    print("kernels: " + ", ".join(
        f"{k['name']} launched {k['launches_by_path']}" for k in kernels),
        flush=True)
    for summary in summaries:
        print(f"serve summary: {json.dumps(summary)}", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
