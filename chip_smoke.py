"""On-card smoke test of the PyTorch/CUDA port (repro_torch) on one H100.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero before the last line:
  1. card     — `nvidia-smi` name and power limit;
  2. build    — nvcc builds every kernel under src/repro_torch/csrc, all
                at once;
  3. kernels  — each kernel against its plain PyTorch version on the card
                at the main paths' shapes, with its time, the plain
                version's time and its bound: the GEMM (bit-equal) at the
                dense projections, on int8 and on packed FxP4 weights, and,
                batched over 64 experts, at the MoE banks; the raw code
                GEMMs (bit-equal; int8 beside torch._int_mm, int16, packed
                FxP4); the float attention (within 1%) at g 5 and g 1, and
                at long rows whose score row lives in a global scratch
                row; the integer attention (within 1%) at g 5, short and
                long rows; the CORDIC AF (bit-equal) at the MoE expert
                activations; the CORDIC softmax (bit-equal) at the
                router's rows and a wide row;
  4. check    — reduced Qwen2.5-14B (under FxP8, edge4 and integer
                attention) and reduced DeepSeekMoE-16B (FxP8), each served
                through the kernels and through the plain path on the
                card: the same greedy tokens;
  5. serve    — four paths, each at full width from seed 0: Qwen2.5-14B
                (48 layers) with FxP8 weights, DeepSeekMoE-16B (28 layers)
                with FxP8 weights, Qwen2.5-14B under edge4 (packed FxP4
                weights and activations) and Qwen2.5-14B under integer
                attention (FxP8, exact AF, `int_attention`); each with
                paged int8 KV (block 16), 4 slots, 8 mixed requests
                (prompts 40-64), 16 greedy tokens each, prefill chunk 16,
                overlap loop; the launches of every kernel counted over
                each serve run (set to 0 just before it) and per decode
                step against the model's count, tokens identical on a
                rerun, one decode step of the rerun traced with the
                profiler (kernel device time and the device's idle share),
                memory on the card and its peak.
The second-to-last lines are the card line and the kernels JSON; the last
line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
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


def bound_ms(nbytes: float, ops: float, ops_rate: float, *more):
    """The least time for the work: bytes over the memory rate, or the
    operations over their type's peak (`more`: further (ops, rate) pairs
    of other types, whose times add), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_rate + sum(o / r for o, r in more)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def gemm_phase(dev, gen, packed=False):
    """The fused GEMM at the full-width model's shapes, on int8 codes or
    (`packed`) on FxP4 codes with nibble-packed weights [K, N/2] bytes,
    whose bytes bound counts half the int8 weight bytes. Packed weights
    must be bit-equal to the plain version, with the AF too."""
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
    qa = 7 if packed else 127
    label = "fxp_gemm_fused packed FxP4" if packed else "fxp_gemm_fused"
    rows, worst = [], 0.0
    for m, k, n, af in shapes:
        x = torch.randint(-qa, qa + 1, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        w = (torch.randint(-128, 128, (k, n // 2), generator=gen, device=dev,
                           dtype=torch.int8) if packed else
             torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                           dtype=torch.int8))
        scale = torch.rand((n,), generator=gen, device=dev) * 1e-4

        def run():
            return fxp_gemm_fused(x, w, scale, af=af, packed=packed)

        def plain():
            return fxp_gemm_fused_plain(x, w, scale, af=af, packed=packed)
        got, ref = run(), plain()
        torch.cuda.synchronize()
        if af is None or packed:
            if not torch.equal(got, ref):
                fail(f"{label} {m}x{k}x{n}+{af}: not bit-equal to plain "
                     f"(max |err| {(got - ref).abs().max().item()})")
            err = 0.0
        else:
            # same f32 operations in the same order: at most 1 ulp apart
            err = (got - ref).abs().max().item()
            ulp = torch.finfo(torch.float32).eps * ref.abs().max().item()
            if err > ulp:
                fail(f"{label} {m}x{k}x{n}+{af}: max |err| {err} > 1 ulp "
                     f"({ulp})")
        worst = max(worst, err)
        ms = timed(run, 20, "fxp_gemm_fused_kernel")
        call_ms = cuda_ms(run, 20)
        pms = timed(plain, 3)
        nbytes = m * k + w.numel() + 4 * n + 4 * m * n
        bms, by = bound_ms(nbytes, 2.0 * m * k * n, INT8_OPS_PER_S)
        rows.append(dict(m=m, k=k, n=n, af=af, ms=ms, plain_ms=pms,
                         bound_ms=bms, bound_by=by, max_abs_err=err,
                         call_ms=call_ms))
        print(f"kernel {label} M={m} K={k} N={n} af={af}: "
              f"{ms:.4f} ms on the device, {call_ms:.4f} ms per wrapper "
              f"call (plain {pms:.4f} ms, bound {bms:.4f} ms by "
              f"{by}, {100 * bms / ms:.1f}% of bound), max|err| {err}",
              flush=True)
    return rows, worst


def code_gemm_phase(dev, gen):
    """The raw code GEMMs at M 32, K 5120, N 5120: int8 codes beside
    torch._int_mm (one PyTorch call for the same int32 product), packed
    FxP4 weights, and FxP12 codes in int16 at K 512 (inside the bound
    K * qmax^2 < 2^31 the caller owns); each bit-equal to its plain
    version. -> {kernel name: row}."""
    from repro_torch.kernels.fxp_gemm.fxp_gemm import (
        fxp4_gemm_packed, fxp4_gemm_packed_plain, fxp_gemm_codes,
        fxp_gemm_codes_plain)
    m, k, n = 32, 5120, 5120

    def codes(shape, q, dtype=torch.int8):
        return torch.randint(-q, q + 1, shape, generator=gen, device=dev,
                             dtype=dtype)
    cases = [("fxp_gemm_codes", "int8", fxp_gemm_codes, fxp_gemm_codes_plain,
              codes((m, k), 127), codes((k, n), 127)),
             ("fxp4_gemm_packed", "FxP4 x packed nibbles", fxp4_gemm_packed,
              fxp4_gemm_packed_plain, codes((m, k), 7), codes((k, n // 2),
                                                              127)),
             ("fxp_gemm_codes", "int16 FxP12, K 512", fxp_gemm_codes,
              fxp_gemm_codes_plain, codes((m, 512), 2047, torch.int16),
              codes((512, n), 2047, torch.int16))]
    rows = {}
    for name, what, fn, plain, x, w in cases:
        got, ref = fn(x, w), plain(x, w)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"{name} ({what}): not bit-equal to plain")
        record = ("gemm_codes_wide_kernel" if x.dtype == torch.int16
                  else "fxp_gemm_fused_kernel")
        ms = timed(lambda: fn(x, w), 20, record)
        pms = timed(lambda: plain(x, w), 3)
        kk = x.shape[1]
        nbytes = x.numel() * x.element_size() + w.numel() * w.element_size()
        nbytes += 4 * m * n
        if x.dtype == torch.int8:
            bms, by = bound_ms(nbytes, 2.0 * m * kk * n, INT8_OPS_PER_S)
        else:           # no published int16 rate: the bytes bound alone
            bms, by = bound_ms(nbytes, 0.0, INT8_OPS_PER_S)
        lib_ms, lib_note = None, "none"
        if name == "fxp_gemm_codes" and x.dtype == torch.int8:
            lib_ms, lib_note = library_int_mm(x, w, ref)
        print(f"kernel {name} ({what}) M={m} K={kk} N={n}: {ms:.4f} ms on "
              f"the device (plain {pms:.4f} ms, bound {bms:.4f} ms by {by}, "
              f"{100 * bms / ms:.1f}% of bound; library {lib_note}), "
              "bit-equal", flush=True)
        rows.setdefault(name, dict(ms=ms, plain_ms=pms, bound_ms=bms,
                                   bound_by=by, max_abs_err=0.0,
                                   library_ms=lib_ms,
                                   shape=f"M={m} K={kk} N={n} {what}"))
    return rows


def library_int_mm(x, w, ref):
    """torch._int_mm on the same codes (its CUDA path wants the second
    operand column-major, so it gets a column-major copy): -> (ms, note).
    Its result must equal the kernel's."""
    wc = w.t().contiguous().t()
    try:
        out = torch._int_mm(x, wc)
    except RuntimeError as e:
        return None, f"torch._int_mm refused: {str(e).splitlines()[0]}"
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        fail("torch._int_mm disagrees with the plain int32 product")
    ms = timed(lambda: torch._int_mm(x, wc), 20)
    return ms, f"torch._int_mm {ms:.4f} ms, equal"


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


# f32 operations per cached position and query head of the integer
# attention's epilogue, counted from csrc/paged_attention.cu: the scale
# fold 2, the max 1, exp with its subtract ~2, the sum 1, the divide and
# the v-scale product 2, the amax 1, the requantize divide, round and
# clip 4
INT_ATTN_F32_OPS = 2 + 1 + 2 + 1 + 2 + 1 + 4


def attention_int_phase(dev, gen):
    """The integer attention kernel at Qwen2.5-14B's g 5 (4 rows x 8 KV
    heads x hd 128), q / sqrt(hd) quantized per head to FxP8 as the serving
    path does, at 1024-2000 cached tokens and at 4000-12000 (score row in a
    global scratch row): within 1% of the output range of its plain
    version."""
    from repro_torch.core.fxp import FORMATS, quantize
    from repro_torch.kernels.paged_attention.paged_attention import (
        paged_attention_int, paged_attention_int_plain, scores_in_scratch)
    fmt = FORMATS["fxp8"]
    result = None
    short, long_ = [1024, 1536, 2000, 1200], [12000, 9000, 11000, 4000]
    for lengths in (short, long_):
        (q, k, v, ks, vs, tables, meta, alloc_blocks,
         valid) = paged_attention_inputs(dev, gen, True, lengths, 8, 5)
        b, kvh, g, hd = q.shape
        bs = k.shape[1]
        qc, sq = quantize(q.float() / math.sqrt(hd), fmt, axis=3)
        width = tables.shape[1] * bs
        scratch = scores_in_scratch(g, hd, width, integer=True)
        if scratch != (lengths is long_):
            fail(f"paged_attention_int at table width {width}: score row "
                 f"{'in' if scratch else 'not in'} global scratch")
        args = (qc, sq, k, v, ks, vs, tables, meta)
        kw = dict(fmt=fmt, out_dtype=torch.bfloat16)
        got = paged_attention_int(*args, **kw)
        ref = paged_attention_int_plain(*args, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            fail("paged_attention_int: non-finite output")
        err = (got.float() - ref.float()).abs().max().item()
        # exact integer dots; the softmax sums and exponentiates in another
        # order than torch's, and a flipped p.v code moves the output by a
        # v step times the row scale: within 1% of the output's range
        tol = 1e-2 * ref.float().abs().max().item()
        body = "exact softmax" + (", scores in global scratch" if scratch
                                  else "")
        if err > tol:
            fail(f"paged_attention_int ({body}): max |err| {err} > {tol}")
        ms = timed(lambda: paged_attention_int(*args, **kw), 20,
                   "paged_attention_int_kernel")
        pms = timed(lambda: paged_attention_int_plain(*args, **kw), 3)
        per_pos = 2 * kvh * hd + 8 * kvh
        nbytes = (alloc_blocks * bs * per_pos + qc.numel() + 4 * sq.numel()
                  + 2 * b * kvh * g * hd + 4 * tables.numel()
                  + 4 * meta.numel())
        bms, by = bound_ms(nbytes, 4.0 * valid * kvh * g * hd,
                           INT8_OPS_PER_S,
                           (INT_ATTN_F32_OPS * valid * kvh * g,
                            F32_OPS_PER_S))
        print(f"kernel paged_attention_int ({body}) B={b} KV={kvh} g={g} "
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


def policy(name: str, backend: str):
    """The serving policies of the paths: FxP8 (the CLI's flexpe-fxp8),
    edge4 (the CLI's edge4: packed FxP4 weights, FxP4 activations, CORDIC
    AF and attention softmax at FxP4 stages) and integer attention (FxP8
    with the exact AF and softmax and `int_attention`, the reference's
    int8_attn serving variant)."""
    from repro_torch.core.precision import PrecisionPolicy
    if name == "edge4":
        return PrecisionPolicy.edge4(backend=backend)
    if name == "int-attention":
        return dataclasses.replace(
            PrecisionPolicy.flexpe(8, af_impl="exact", backend=backend),
            int_attention=True)
    return PrecisionPolicy.flexpe(8, backend=backend)


#: the served paths: (architecture, policy)
PATHS = (("qwen2_5_14b", "fxp8"), ("deepseek_moe_16b", "fxp8"),
         ("qwen2_5_14b", "edge4"), ("qwen2_5_14b", "int-attention"))


def check_phase(dev, arch, policy_name):
    """The reduced model through the kernels and through the plain path,
    both on the card: the same greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine, make_requests
    cfg = get_config(arch).reduced()
    toks = {}
    for backend in ("kernels", "reference"):
        eng = build_engine(cfg, policy(policy_name, backend), seed=0,
                           device=dev, max_slots=SLOTS, max_len=48,
                           prefill_chunk=16, kv_block_size=16, overlap=True)
        reqs = make_requests(cfg, 6, 32, 16, mixed=True, seed=0)
        toks[backend] = serve_tokens(eng, reqs)[0]
    if toks["kernels"] != toks["reference"]:
        fail(f"reduced {arch} {policy_name}: kernels {toks['kernels']} != "
             f"plain {toks['reference']}")
    print(f"check reduced {arch} {policy_name}: kernels == plain path on "
          f"the card, {sum(map(len, toks['kernels']))} greedy tokens",
          flush=True)


#: each kernel wrapper's name and the name of its device record
RECORDS = {"fxp_gemm_fused": "fxp_gemm_fused_kernel",
           "paged_attention_float": "paged_attention_kernel",
           "cordic_af": "cordic_af_kernel",
           "cordic_softmax": "cordic_softmax_kernel",
           "paged_attention_int": "paged_attention_int_kernel"}


def launches_per_decode_step(cfg, pol) -> dict:
    """The launches one decode step must make, of every kernel: per layer
    the q/k/v/o GEMMs, one attention (the integer kernel under integer
    attention with the exact softmax, the float kernel otherwise), and
    the FFN's GEMMs (w1/w3/w2, or the three expert banks and the three
    shared-expert GEMMs of a MoE block, whose expert and shared
    activations and router softmax are one CORDIC launch each); one
    lm_head GEMM."""
    moe = cfg.family == "moe"
    int_attn = pol.int_attention and pol.attn_softmax != "cordic"
    return {"fxp_gemm_fused": cfg.n_layers * (4 + (6 if moe else 3)) + 1,
            "paged_attention_float": 0 if int_attn else cfg.n_layers,
            "cordic_af": 2 * cfg.n_layers if moe else 0,
            "cordic_softmax": cfg.n_layers if moe else 0,
            "paged_attention_int": cfg.n_layers if int_attn else 0}


def serve_phase(dev, arch, policy_name):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (KERNELS, build_engine,
                                          launch_counts, make_requests)
    cfg = get_config(arch)
    pol = policy(policy_name, "kernels")
    label = f"{arch} {policy_name}"
    gen_tokens, prompt_len = 16, 64
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = build_engine(cfg, pol, seed=0, device=dev, max_slots=SLOTS,
                          max_len=prompt_len + gen_tokens, prefill_chunk=16,
                          kv_block_size=16, overlap=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    gib = 2 ** 30
    setup_peak = torch.cuda.max_memory_allocated() / gib
    print(f"serve setup: full-width {label}, {cfg.n_layers} layers, random "
          f"weights quantized to {pol.matmul} in {setup_s:.1f} s, "
          f"{torch.cuda.memory_allocated() / gib:.2f} GiB on the card, "
          f"peak {setup_peak:.2f} GiB while building", flush=True)
    expect = launches_per_decode_step(cfg, pol)
    if set(expect) != set(KERNELS):
        fail(f"expected launches {sorted(expect)} do not name every kernel "
             f"of the serving path {sorted(KERNELS)}")
    path = list(expect)

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
        fail(f"serve {label}: {len(finished)} of {len(reqs)} requests "
             "finished")
    for o in finished:
        if len(o.tokens) != gen_tokens or not all(
                0 <= t < cfg.vocab for t in o.tokens):
            fail(f"serve {label}: request {o.id} returned {o.tokens}")
    for name, n in launches.items():
        if expect[name] and n == 0:
            fail(f"serve {label}: kernel {name} was never launched")
    if per_step != [tuple(expect[name] for name in path)]:
        fail(f"serve {label}: launches per decode step {per_step} of "
             f"{path}, the model needs {[expect[n] for n in path]}")
    st = engine.stats()
    total = st["prompt_tokens"] + st["generated_tokens"]
    print(f"serve {label}: {len(finished)} requests, {st['prompt_tokens']} "
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
        fail(f"serve {label}: rerun of the same workload gave other tokens")
    print(f"serve {label} rerun: identical tokens ({dt2:.3f} s); first "
          f"request {toks[0]}", flush=True)

    rec = trace["records"]
    kern = {name: matching(rec, RECORDS[name]) for name in path}
    n_all, all_ms = matching(rec, None)
    if tuple(kern[name][0] for name in path) != trace["counted"]:
        fail(f"traced decode step of {label}: kernel records "
             f"{ {n: c for n, (c, _) in kern.items()} }, the counters say "
             f"{trace['counted']}")
    kern_ms = sum(ms for _, ms in kern.values())
    idle = 1.0 - all_ms / trace["wall_ms"]
    print(f"traced decode step of {label} (rerun step {target} of "
          f"{n_decode}, synced, under the profiler): "
          f"{trace['wall_ms']:.3f} ms wall; device time {all_ms:.3f} ms in "
          f"{n_all} records = " + " + ".join(
              f"{c} {name} {ms:.3f} ms" for name, (c, ms) in kern.items())
          + f" + {n_all - sum(c for c, _ in kern.values())} other "
          f"{all_ms - kern_ms:.3f} ms; device idle {100 * idle:.1f}% of the "
          "step", flush=True)
    top = sorted(rec.items(), key=lambda kv: -kv[1][1])[:8]
    print(f"traced decode step of {label}, largest device records: "
          + "; ".join(f"{k[:60]} x{c} {ms:.3f} ms" for k, (c, ms) in top),
          flush=True)
    ex.decode_and_sample = decode
    return launches, dict(
        arch=arch, policy=policy_name, layers=cfg.n_layers, setup_s=setup_s,
        gib_on_card=torch.cuda.memory_allocated() / gib,
        setup_peak_gib=setup_peak, serve_peak_gib=serve_peak,
        tok_s=total / dt, generated_tok_s=st["generated_tokens"] / dt,
        decode_ms=dev_ms, enqueue_ms=host_ms, seconds=dt,
        launches_per_decode_step=dict(zip(path, per_step[0])),
        traced_step=dict(wall_ms=trace["wall_ms"], device_ms=all_ms,
                         idle_share=idle, kernels={
                             name: dict(launches=c, ms=ms)
                             for name, (c, ms) in kern.items()}))


def kernel_entry(name, source, replaces, row, launches, path=None,
                 counter=None, **extra):
    """One kernel's line: `launches` counted over the serve run of `path`
    (architecture/policy) on the wrapper's counter `counter` (default:
    `name`); None for a kernel no serving path runs."""
    counter = counter or name
    return dict({"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": launches[path].get(counter, 0) if path else 0,
                 "max_abs_err": row["max_abs_err"],
                 "ms": row["ms"], "plain_ms": row["plain_ms"],
                 "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                 "library_ms": row.get("library_ms"),
                 "timing": TIMING["source"], "path": path,
                 "launches_by_path": {p: n.get(counter, 0)
                                      for p, n in launches.items()}},
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
    packed_rows, _ = gemm_phase(dev, torch.Generator(device=dev).manual_seed(5),
                                packed=True)
    code_rows = code_gemm_phase(dev, torch.Generator(device=dev).manual_seed(6))
    batched_gemm_phase(dev, torch.Generator(device=dev).manual_seed(2))
    attn = attention_phase(dev, torch.Generator(device=dev).manual_seed(1))
    attn_int = attention_int_phase(
        dev, torch.Generator(device=dev).manual_seed(7))
    af_rows = cordic_af_phase(dev, torch.Generator(device=dev).manual_seed(3))
    sm_rows = cordic_softmax_phase(
        dev, torch.Generator(device=dev).manual_seed(4))
    for arch, policy_name in PATHS:
        check_phase(dev, arch, policy_name)
    launches, summaries = {}, []
    for arch, policy_name in PATHS:
        key = f"{arch}/{policy_name}"
        launches[key], summary = serve_phase(dev, arch, policy_name)
        summaries.append(summary)
        gc.collect()                 # the engine and its weights go here
        torch.cuda.empty_cache()

    w1 = next(r for r in gemm_rows if r["af"] == "silu")
    w1["max_abs_err"] = gemm_err
    pw1 = next(r for r in packed_rows if r["af"] == "silu")
    gemm_src = "src/repro_torch/csrc/fxp_gemm.cu"
    gemm_ref = "src/repro/kernels/fxp_gemm/fxp_gemm.py"
    attn_src = "src/repro_torch/csrc/paged_attention.cu"
    attn_ref = "src/repro/kernels/paged_attention/paged_attention.py"
    kernels = [
        kernel_entry("fxp_gemm_fused", gemm_src, f"{gemm_ref}:158", w1,
                     launches, "deepseek_moe_16b/fxp8", call_ms=w1["call_ms"],
                     shape=f"M={w1['m']} K={w1['k']} N={w1['n']} +silu "
                           "(Qwen2.5-14B w1), int8 codes"),
        kernel_entry("fxp_gemm_fused_packed", gemm_src, f"{gemm_ref}:158",
                     pw1, launches, "qwen2_5_14b/edge4",
                     counter="fxp_gemm_fused", call_ms=pw1["call_ms"],
                     shape=f"M={pw1['m']} K={pw1['k']} N={pw1['n']} +silu "
                           "(Qwen2.5-14B w1), FxP4 codes x packed nibbles "
                           f"(fxp_gemm_fused_pallas packed=True; "
                           f"_unpack_nibbles {gemm_ref}:51)"),
        kernel_entry("paged_attention_float", attn_src, f"{attn_ref}:172",
                     attn, launches, "deepseek_moe_16b/fxp8",
                     shape="B=4 KV=8 g=5 hd=128 bs=16, 1024-2000 cached "
                           "tokens, int8 pool, CORDIC softmax"),
        kernel_entry("paged_attention_int", attn_src, f"{attn_ref}:208",
                     attn_int, launches, "qwen2_5_14b/int-attention",
                     shape="B=4 KV=8 g=5 hd=128 bs=16, 1024-2000 cached "
                           "tokens, int8 pool, exact softmax"),
        kernel_entry("cordic_af", "src/repro_torch/csrc/cordic_af.cu",
                     "src/repro/kernels/cordic_af/cordic_af.py:89",
                     af_rows[0], launches, "deepseek_moe_16b/fxp8",
                     shape="silu [1, 64, 4, 1408] (expert activations at "
                           "decode)"),
        kernel_entry("cordic_softmax", "src/repro_torch/csrc/cordic_softmax.cu",
                     "src/repro/kernels/cordic_softmax/cordic_softmax.py:33",
                     sm_rows[0], launches, "deepseek_moe_16b/fxp8",
                     shape="[4, 64], lv 12 (router at decode)"),
        kernel_entry("fxp_gemm_codes", gemm_src, f"{gemm_ref}:111",
                     code_rows["fxp_gemm_codes"], launches,
                     shape=code_rows["fxp_gemm_codes"]["shape"],
                     on_path=False),
        kernel_entry("fxp4_gemm_packed", gemm_src, f"{gemm_ref}:138",
                     code_rows["fxp4_gemm_packed"], launches,
                     shape=code_rows["fxp4_gemm_packed"]["shape"],
                     on_path=False),
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
