"""On-card smoke test of the PyTorch/CUDA port (repro_torch) on one H100.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero before the last line:
  1. card     — `nvidia-smi` name and power limit;
  2. build    — nvcc builds every kernel under src/repro_torch/csrc, all
                at once;
  3. kernels  — each kernel against its plain PyTorch version on the card
                at the main paths' shapes, with its time, the plain
                version's time and its bound: the GEMM (bit-equal, every
                mode on the tensor-core core) at both families' dense
                projections, on int8, on packed FxP4 weights, on FxP16
                codes in int16 (the wide mode beside torch.matmul of the
                codes in f32, also at codes at the ends of int16) and on
                FxP32 (and, at w1, FxP24) codes in int32 (the x32 mode,
                byte planes on the tensor cores, beside torch.matmul of
                the codes in f32, also at codes at the ends of int32),
                and,
                batched over 64 experts, at the MoE banks, int8 and packed
                FxP4; every GEMM window holds a record of its kernel for
                each call; the raw code GEMMs
                (bit-equal: int8 beside torch._int_mm, int16 and packed
                FxP4 on the tensor cores, int32 inside the caller's bound
                on the CUDA cores, beside torch.matmul of f32 codes); both attentions (a
                cluster of CTAs per row and KV head; within 1%, finite,
                one launch a call, two calls bit-identical, the cluster
                size on each line) at g 5 over 1024-2000 and 4000-12000
                tokens, the serve paths' width, a sentinel inside a window
                with an empty window over allocated blocks, and a table
                whose score rows live in a global scratch row; the float
                one also on a bf16 pool and at g 1 (beside
                scaled_dot_product_attention on pre-gathered rows, a
                yardstick that does less work); an empty launch, the
                floor of a one-launch op; the CORDIC AF op and the
                CORDIC softmax op (each one launch holding both FxP
                snaps; bit-equal to the plain op; timed by all of a
                call's device records and by the kernel's) at the MoE
                expert activations in bf16 under FxP8 and FxP4 and past
                the resident grid's registers, and at the router's f32
                rows under FxP8 and a wide row, and without a precision;
                the shapes the SSM and hybrid paths add: the GEMM at
                Mamba2-370M's and Zamba2-1.2B's projections, w1 + GELU
                and lm_heads (decode rows and 16-row prefill chunks,
                bit-equal), the float attention at Zamba2's plain
                multi-head g 1, hd 64 over 32 KV heads (within 1%), the
                CORDIC AF at the SSM gate's bf16 rows under FxP8
                (bit-equal);
  4. check    — the FxP32 quantize on the card (it saturates to the
                reference's codes); reduced Qwen2.5-14B (under FxP8,
                edge4, integer attention and FxP32), reduced
                DeepSeekMoE-16B (FxP8 and edge4), reduced Mamba2-370M and
                reduced Zamba2-1.2B (FxP8),
                each served through the kernels and through the plain path
                on the card: the same greedy tokens; the reduced fleet of
                every rung (fxp4, fxp8, fxp16 and bf16 replicas over one
                TieredWeights bank): the same tiers and tokens on both
                paths (an fxp4 request may differ only where the kernels
                with the attentions' plain versions in place give the
                plain path's tokens exactly, `against_plain`), and with
                every request pinned to one tier, the tokens of a single
                engine of that tier over the same bank; the reduced
                speculative fleet (`check_spec_phase`): the same tokens
                and `spec_*` counters on both paths, and the tokens of a
                plain fxp4+bf16 fleet over the same bank;
  5. serve    — ten paths, each at full width from seed 0: Qwen2.5-14B
                (48 layers) with FxP8 weights, DeepSeekMoE-16B (28 layers)
                with FxP8 weights, Qwen2.5-14B under edge4 (packed FxP4
                weights and activations), Qwen2.5-14B under integer
                attention (FxP8, exact AF, `int_attention`),
                DeepSeekMoE-16B under edge4 (packed FxP4 expert banks) and
                the precision-tiered fleet of Qwen2.5-14B (an fxp8 and an
                fxp16 replica over one TieredWeights bank, tiered routing,
                threshold 1.0, priority 0) and Qwen2.5-14B under FxP32
                (48 layers of int32 weights, every GEMM on the x32 mode,
                its KV codes wrapped into the int8 pool as the
                reference's are), Mamba2-370M (48 SSM layers, FxP8, a
                recurrent state per slot and no KV), Zamba2-1.2B (38
                SSM layers and 6 applications of one shared attention +
                GELU MLP block, FxP8) and the speculative fleet of
                Qwen2.5-14B (`spec_phase`: an fxp4 replica and a bf16
                replica drafting on the bank's fxp4 view, k 4, beside a
                plain fxp4+bf16 fleet over the same bank; its gates (b)
                to (d) there); each with paged int8 KV (bf16 for bf16; block
                16; none for Mamba2), 4 slots (per replica), 8 mixed
                requests (prompts
                40-64), 16 greedy tokens each, prefill chunk 16, overlap
                loop; the launches of every kernel, and of each GEMM mode,
                counted over each serve run (set to 0 just before it) and
                per decode step (of each replica) against the model's
                count, tokens identical on a rerun, one decode step of
                each replica of the rerun traced with the profiler (kernel
                device time and the device's idle share; where the
                profiler loses records of every traced step, the step's
                launches are counted as the kernel nodes of a captured
                CUDA graph), memory on the card and its peak;
  6. prefix   — after the Qwen2.5-14B FxP8 path, on its weights: 8
                requests sharing a 48-token system prompt, cold, then
                with the prefix cache under the sync and the overlap
                loops (`prefix_phase`): the same tokens, prompt tokens
                reused, fewer computed; and one mixed stream cold and
                warm, reported.
The second-to-last lines are the card line and the kernels JSON; the last
line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
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
FLEET = ("fxp8", "fxp16")      # the tiered fleet's replicas
LADDER = ("fxp4", "fxp8", "fxp16", "bf16")      # every rung, reduced check
SPEC_TIERS = ("fxp4", "bf16")  # the speculative fleet's replicas
SPEC, SPEC_K = "fxp4:bf16", 4  # its draft:verify pair and draft depth
SPEC_COUNTERS = ("spec_proposed", "spec_accepted", "spec_verify_steps",
                 "spec_rolled_back")
TRACE_TRIES = 3                # decode steps traced at most per replica
WINDOW_TRIES = 5               # profiler windows taken at most per timing


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


def matching(records: dict, match):
    """(launches, device ms) of the records whose name contains `match`
    (one name, or any of a tuple of names; every record when None)."""
    names = (match,) if isinstance(match, str) else match
    sel = [v for k, v in records.items()
           if names is None or any(n in k for n in names)]
    return sum(c for c, _ in sel), sum(ms for _, ms in sel)


def profile_window(fn, iters: int) -> dict:
    """{record name: (count, device ms)} of `iters` calls of `fn()` under
    the profiler. The profiler delivers a few records late, into its next
    session: a throwaway session first takes those of earlier windows."""
    act = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act):
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return device_records(prof)


def device_ms(fn, iters: int, match: str | None = None,
              tries: int = WINDOW_TRIES):
    """(mean device time per call of `fn()` from the profiler's CUDA
    kernel records, records of `match` the last window held): the
    kernels whose name contains `match` (one launch per call), or every
    kernel the call launches. The profiler now and then delivers records
    late, into its next session, or loses them; each window follows a
    throwaway session that takes the late records of earlier ones, and a
    window that holds fewer than `iters` records of `match` is measured
    again, up to `tries` windows. The time is None when no window holds
    them all, or the profiler records no device time."""
    fn()
    for _ in range(tries):
        held, total = matching(profile_window(fn, iters), match)
        if match is None or held == iters:
            return (total / iters if total > 0 else None), held
        print(f"profiler: {held} records of {match} for {iters} launches; "
              "measuring again", flush=True)
    return None, held


TIMING = {"source": "profiler"}     # set to "cuda events" on fallback


def timed(fn, iters: int, match: str | None = None,
          window: dict | None = None) -> float:
    """Device time per call (profiler), else the CUDA-event time.
    `window` takes the kernel records the last profiler window held
    ("held", of "iters" calls; fewer held means the CUDA-event time)."""
    ms, held = device_ms(fn, iters, match)
    if window is not None:
        window.update(held=held, iters=iters)
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

def held_all(what, win, record="fxp_gemm_tc_kernel"):
    """Fail unless the last profiler window of `what` held a record of
    the kernel `record` for each of its calls."""
    if win["held"] != win["iters"]:
        fail(f"{what}: {win['held']} records of {record} for "
             f"{win['iters']} calls")


# (M, K, N, af): Qwen2.5-14B's, then DeepSeekMoE-16B's dense GEMMs
DENSE_GEMM_SHAPES = [(SLOTS, 5120, 5120, None),       # wq, wo
                     (SLOTS, 5120, 1024, None),       # wk, wv
                     (SLOTS, 5120, 13824, "silu"),    # w1 + fused silu
                     (SLOTS, 5120, 13824, None),      # w3
                     (SLOTS, 13824, 5120, None),      # w2
                     (SLOTS, 5120, 152064, None),     # lm_head
                     (16, 5120, 5120, None),          # a prefill chunk
                     (SLOTS, 2048, 2048, None),       # moe q, k, v, o
                     (SLOTS, 2048, 2816, None),       # moe shared w1, w3
                     (SLOTS, 2816, 2048, None),       # moe shared w2
                     (SLOTS, 2048, 102400, None)]     # moe lm_head

# the SSM and hybrid paths' GEMMs: Mamba2-370M's, then Zamba2-1.2B's
# (its q/k/v/o are the MoE path's 4 x 2048 x 2048), each at a decode
# step's 4 rows and, but for the lm_head, a 16-row prefill chunk
SSM_GEMM_SHAPES = [(SLOTS, 1024, 4384, None),         # mamba2 in_proj
                   (16, 1024, 4384, None),
                   (SLOTS, 2048, 1024, None),         # mamba2 out_proj
                   (16, 2048, 1024, None),
                   (SLOTS, 1024, 50432, None),        # mamba2 lm_head
                   (SLOTS, 2048, 8384, None),         # zamba2 in_proj
                   (16, 2048, 8384, None),
                   (SLOTS, 4096, 2048, None),         # out_proj, shared in
                   (16, 4096, 2048, None),
                   (16, 2048, 2048, None),            # shared q, k, v, o
                   (SLOTS, 2048, 8192, "gelu"),       # shared w1 + GELU
                   (16, 2048, 8192, "gelu"),
                   (SLOTS, 8192, 2048, None),         # shared w2
                   (16, 8192, 2048, None),
                   (SLOTS, 2048, 32000, None)]        # zamba2 lm_head


def gemm_phase(dev, gen, packed=False, shapes=DENSE_GEMM_SHAPES,
               label=None):
    """The fused GEMM at the full-width models' shapes (`shapes`), on int8
    codes or (`packed`) on FxP4 codes with nibble-packed weights [K, N/2]
    bytes, whose bytes bound counts half the int8 weight bytes: bit-equal
    to the plain version, with the AF too. Each time counts the
    tensor-core core's records, and each window must hold one per call."""
    from repro_torch.kernels.fxp_gemm.fxp_gemm import (
        fxp_gemm_fused, fxp_gemm_fused_plain)
    qa = 7 if packed else 127
    label = label or ("fxp_gemm_fused packed FxP4" if packed
                      else "fxp_gemm_fused")
    rows = []
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
        if not torch.equal(got, ref):
            fail(f"{label} {m}x{k}x{n}+{af}: not bit-equal to plain "
                 f"(max |err| {(got - ref).abs().max().item()})")
        win = {}
        ms = timed(run, 20, "fxp_gemm_tc_kernel", win)
        held_all(f"{label} {m}x{k}x{n}+{af}", win)
        call_ms = cuda_ms(run, 20)
        pms = timed(plain, 3)
        nbytes = m * k + w.numel() + 4 * n + 4 * m * n
        bms, by = bound_ms(nbytes, 2.0 * m * k * n, INT8_OPS_PER_S)
        rows.append(dict(m=m, k=k, n=n, af=af, ms=ms, plain_ms=pms,
                         bound_ms=bms, bound_by=by, max_abs_err=0.0,
                         call_ms=call_ms, **win))
        print(f"kernel {label} M={m} K={k} N={n} af={af}: "
              f"{ms:.4f} ms on the device ({win['held']} of {win['iters']} "
              f"records), {call_ms:.4f} ms per wrapper call (plain "
              f"{pms:.4f} ms, bound {bms:.4f} ms by {by}, "
              f"{100 * bms / ms:.1f}% of bound), bit-equal", flush=True)
    return rows


def code_gemm_phase(dev, gen):
    """The raw code GEMMs at M 32, K 5120, N 5120: int8 codes beside
    torch._int_mm (one PyTorch call for the same int32 product), packed
    FxP4 weights, and FxP12 codes in int16 and in int32 at K 512 (inside
    the bound K * qmax^2 < 2^31 the caller owns; int32 codes take the
    tiled int32 kernel on the CUDA cores); each bit-equal to its plain
    version. The kernel's time counts its own records; `call_device_ms`
    every device record of a wrapper call (with the zeroed split-K
    workspace).
    -> {kernel name: row}."""
    from repro_torch.kernels.fxp_gemm.fxp_gemm import (
        fxp4_gemm_packed, fxp4_gemm_packed_plain, fxp_gemm_codes,
        fxp_gemm_codes_plain)
    m, k, n = 32, 5120, 5120

    def codes(shape, q, dtype=torch.int8):
        return torch.randint(-q, q + 1, shape, generator=gen, device=dev,
                             dtype=dtype)
    cases = [("fxp_gemm_codes", "int8", fxp_gemm_codes, fxp_gemm_codes_plain,
              codes((m, k), 127), codes((k, n), 127), "fxp_gemm_tc_kernel"),
             ("fxp4_gemm_packed", "FxP4 x packed nibbles", fxp4_gemm_packed,
              fxp4_gemm_packed_plain, codes((m, k), 7), codes((k, n // 2),
                                                              127),
              "fxp_gemm_tc_kernel"),
             ("fxp_gemm_codes_int16", "int16 FxP12, K 512", fxp_gemm_codes,
              fxp_gemm_codes_plain, codes((m, 512), 2047, torch.int16),
              codes((512, n), 2047, torch.int16), "fxp_gemm_tc_kernel"),
             ("fxp_gemm_codes_int32", "int32 codes in +-2047, K 512",
              fxp_gemm_codes, fxp_gemm_codes_plain,
              codes((m, 512), 2047, torch.int32),
              codes((512, n), 2047, torch.int32), "gemm_codes_wide_kernel")]
    rows = {}
    for name, what, fn, plain, x, w, record in cases:
        got, ref = fn(x, w), plain(x, w)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"{name} ({what}): not bit-equal to plain")
        win = {}
        ms = timed(lambda: fn(x, w), 20, record, win)
        held_all(f"{name} ({what})", win, record)
        call_ms = timed(lambda: fn(x, w), 20)
        pms = timed(lambda: plain(x, w), 3)
        kk = x.shape[1]
        nbytes = x.numel() * x.element_size() + w.numel() * w.element_size()
        nbytes += 4 * m * n
        if x.dtype == torch.int8:
            bms, by = bound_ms(nbytes, 2.0 * m * kk * n, INT8_OPS_PER_S)
        elif x.dtype == torch.int32:
            # on the CUDA cores: the products at the f32 rate (the table
            # has no int32 rate), as for the x32 mode
            bms, by = bound_ms(nbytes, 2.0 * m * kk * n, F32_OPS_PER_S)
        else:           # no published int16 rate: the bytes bound alone
            bms, by = bound_ms(nbytes, 0.0, INT8_OPS_PER_S)
        lib_ms, lib_note = None, "none"
        if name == "fxp_gemm_codes":
            lib_ms, lib_note = library_int_mm(x, w, ref)
        elif x.dtype != torch.int8:
            # torch.matmul of the same codes already cast to f32 (TF32
            # off), as beside the wide and x32 modes (a yardstick: its f32
            # sums round past 2^24)
            xf, wf = x.float(), w.float()
            lib_ms = timed(lambda: torch.matmul(xf, wf), 20)
            lib_note = f"torch.matmul on f32 codes {lib_ms:.4f} ms"
        print(f"kernel {name} ({what}) M={m} K={kk} N={n}: {ms:.4f} ms on "
              f"the device, {call_ms:.4f} ms of device records per wrapper "
              f"call (plain {pms:.4f} ms, bound {bms:.4f} ms by {by}, "
              f"{100 * bms / ms:.1f}% of bound; library {lib_note}), "
              "bit-equal", flush=True)
        rows[name] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                          max_abs_err=0.0, library_ms=lib_ms,
                          call_device_ms=call_ms,
                          shape=f"M={m} K={kk} N={n} {what}", **win)
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
    fill 24 of the 64 x 4 rows; the kernel's blocks of experts no token
    routes to read no weight bytes, so the bound counts the weights of
    the experts this input routes to. The last shape fills every row:
    the whole bank is read. -> the decode w1 bank's row."""
    from repro_torch.kernels.fxp_gemm.fxp_gemm import (
        fxp_gemm_fused_batched, fxp_gemm_fused_batched_plain)
    e, top_k = 64, 6
    first = None
    for m, k, n, tokens in ((SLOTS, 2048, 1408, SLOTS),
                            (SLOTS, 1408, 2048, SLOTS),
                            (16, 2048, 1408, 16),
                            (SLOTS, 2048, 1408, None)):
        x = expert_queues(dev, gen, e, m, k, tokens, top_k, 127)
        w = torch.randint(-127, 128, (e, k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        scale = torch.rand((e, 1, n), generator=gen, device=dev) * 1e-4
        got = fxp_gemm_fused_batched(x, w, scale)
        ref = fxp_gemm_fused_batched_plain(x, w, scale.reshape(e, n))
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"fxp_gemm_fused batched E={e} M={m} K={k} N={n}: not "
                 "bit-equal to the per-expert loop")
        win = {}
        ms = timed(lambda: fxp_gemm_fused_batched(x, w, scale), 20,
                   "fxp_gemm_tc_kernel", win)
        held_all(f"fxp_gemm_fused batched E={e} M={m} K={k} N={n}", win)
        pms = timed(lambda: fxp_gemm_fused_batched_plain(
            x, w, scale.reshape(e, n)), 2)
        active = int((x.reshape(e, -1) != 0).any(-1).sum())
        filled = int((x != 0).any(-1).sum())
        nbytes = e * m * k + active * k * n + 4 * e * n + 4 * e * m * n
        bms, by = bound_ms(nbytes, 2.0 * filled * k * n, INT8_OPS_PER_S)
        occupancy = ("all queues full" if tokens is None else
                     f"{tokens} tokens x top-{top_k}") + (
                         f": {filled} filled rows in {active} routed experts")
        print(f"kernel fxp_gemm_fused batched E={e} M={m} K={k} N={n} "
              f"({occupancy}): {ms:.4f} ms on the device (plain loop "
              f"{pms:.4f} ms, bound {bms:.4f} ms by {by}, "
              f"{100 * bms / ms:.1f}% of bound), bit-equal", flush=True)
        if first is None:
            first = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                         max_abs_err=0.0, **win,
                         shape=f"E={e} M={m} K={k} N={n} ({occupancy})")
    return first


def wide_gemm_phase(dev, gen):
    """The fused GEMM's wide mode (the tensor-core core's byte planes) at
    the full-width model's shapes on FxP16 codes in int16 (the fleet's
    fxp16 replica), bit-equal to its plain version (both take the exact
    sum of the code products and round it once to f32), beside
    torch.matmul of the same codes already cast to f32 (TF32 off): the
    nearest single PyTorch call, which leaves out the casts, the scale and
    the AF. The bound counts the int16 operand bytes and the 2 M K N
    products at the f32 rate outside the tensor cores (the table has no
    int16 rate). Then codes at the ends of int16 at w2's shape (sums near
    K * 2^30, which a wrong int32 combine of the planes would wrap):
    bit-equal too."""
    from repro_torch.kernels.fxp_gemm.fxp_gemm import (
        fxp_gemm_fused, fxp_gemm_fused_plain)
    shapes = [(SLOTS, 5120, 5120, None), (SLOTS, 5120, 1024, None),
              (SLOTS, 5120, 13824, "silu"), (SLOTS, 5120, 13824, None),
              (SLOTS, 13824, 5120, None), (SLOTS, 5120, 152064, None),
              (16, 5120, 5120, None)]
    rows = []
    for m, k, n, af in shapes:
        x = torch.randint(-32767, 32768, (m, k), generator=gen, device=dev,
                          dtype=torch.int16)
        w = torch.randint(-32767, 32768, (k, n), generator=gen, device=dev,
                          dtype=torch.int16)
        scale = torch.rand((n,), generator=gen, device=dev) * 1e-9

        def run():
            return fxp_gemm_fused(x, w, scale, af=af)
        got, ref = run(), fxp_gemm_fused_plain(x, w, scale, af=af)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"fxp_gemm_fused wide {m}x{k}x{n}+{af}: not bit-equal to "
                 f"plain (max |err| {(got - ref).abs().max().item()})")
        win = {}
        ms = timed(run, 20, "fxp_gemm_tc_kernel", win)
        held_all(f"fxp_gemm_fused wide {m}x{k}x{n}+{af}", win)
        pms = timed(lambda: fxp_gemm_fused_plain(x, w, scale, af=af), 2)
        xf, wf = x.float(), w.float()
        lib_ms = timed(lambda: torch.matmul(xf, wf), 20)
        del xf, wf
        nbytes = 2 * m * k + 2 * k * n + 4 * n + 4 * m * n
        bms, by = bound_ms(nbytes, 2.0 * m * k * n, F32_OPS_PER_S)
        rows.append(dict(m=m, k=k, n=n, af=af, ms=ms, plain_ms=pms,
                         bound_ms=bms, bound_by=by, max_abs_err=0.0,
                         library_ms=lib_ms, **win))
        print(f"kernel fxp_gemm_fused wide (FxP16 int16 codes) M={m} K={k} "
              f"N={n} af={af}: {ms:.4f} ms on the device (plain {pms:.4f} "
              f"ms, bound {bms:.4f} ms by {by}, {100 * bms / ms:.1f}% of "
              f"bound; library torch.matmul on f32 codes {lib_ms:.4f} ms), "
              "bit-equal", flush=True)
    m, k, n = SLOTS, 13824, 5120
    x = torch.full((m, k), 32767, dtype=torch.int16, device=dev)
    x[1] = -32768
    x[-1, ::3] = -32767
    w = torch.where(torch.arange(n, device=dev) % 2 == 0, 32767, -32767)
    w = w.to(torch.int16).expand(k, n).clone()
    w[:, 2] = -32768
    scale = torch.full((n,), 2.0 ** -40, device=dev)
    for af in (None, "silu"):
        got = fxp_gemm_fused(x, w, scale, af=af)
        ref = fxp_gemm_fused_plain(x, w, scale, af=af)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"fxp_gemm_fused wide at extreme codes {m}x{k}x{n}+{af}: "
                 "not bit-equal to plain")
    ms = timed(lambda: fxp_gemm_fused(x, w, scale), 20, "fxp_gemm_tc_kernel")
    print(f"kernel fxp_gemm_fused wide at codes +-32767 and -32768 M={m} "
          f"K={k} N={n}: {ms:.4f} ms on the device, sums up to "
          f"{k * 32768 ** 2:.3e}, bit-equal with and without silu",
          flush=True)
    return rows


def x32_gemm_phase(dev, gen, record="fxp_gemm_tc_kernel"):
    """The fused GEMM's x32 mode (csrc/fxp_gemm.cu: int32 codes as four
    byte planes on the tensor-core core, the exact sum in 128 bits rounded
    once to f32) at the
    full-width Qwen2.5-14B's shapes on FxP32 codes (the fxp32 path), and
    w1 + SiLU on FxP24 codes too, each bit-equal to its plain version,
    beside torch.matmul of the same codes already cast to f32 (TF32 off;
    it rounds every code past 2^24 and every partial sum: a yardstick, not
    the same function). The bound counts the int32 operand bytes and the
    2 M K N products at the f32 rate outside the tensor cores (the table
    has no int32 rate). Each window must hold one record of `record` a
    call (tools/x32_sweep.py names an older kernel's record to time an
    older checkout). Then codes at the ends of int32 at w2's shape (sums
    of K * 2^62, past 2^64): bit-equal too, and timed."""
    from repro_torch.kernels.fxp_gemm.fxp_gemm import (
        fxp_gemm_fused, fxp_gemm_fused_plain)
    hr, lv = 8, 10                # default_stages of FxP24 and FxP32
    shapes = [(SLOTS, 5120, 5120, None, 32), (SLOTS, 5120, 1024, None, 32),
              (SLOTS, 5120, 13824, "silu", 32),
              (SLOTS, 5120, 13824, None, 32), (SLOTS, 13824, 5120, None, 32),
              (SLOTS, 5120, 152064, None, 32), (16, 5120, 5120, None, 32),
              (SLOTS, 5120, 13824, "silu", 24)]
    rows = []
    for m, k, n, af, bits in shapes:
        q = (1 << (bits - 1)) - 1
        x = torch.randint(-q - 1, q + 1, (m, k), generator=gen, device=dev,
                          dtype=torch.int32)
        w = torch.randint(-q - 1, q + 1, (k, n), generator=gen, device=dev,
                          dtype=torch.int32)
        scale = torch.rand((n,), generator=gen, device=dev) / (
            float(q) ** 2 * k ** 0.5)

        def run():
            return fxp_gemm_fused(x, w, scale, af=af, hr_stages=hr,
                                  lv_stages=lv)

        def plain():
            return fxp_gemm_fused_plain(x, w, scale, af=af, hr_stages=hr,
                                        lv_stages=lv)
        what = f"fxp_gemm_fused x32 FxP{bits} {m}x{k}x{n}+{af}"
        got, ref = run(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"{what}: not bit-equal to plain (max |err| "
                 f"{(got - ref).abs().max().item()})")
        win = {}
        ms = timed(run, 20, record, win)
        held_all(what, win, record)
        call_ms = cuda_ms(run, 20)
        pms = timed(plain, 2)
        xf, wf = x.float(), w.float()
        lib_ms = timed(lambda: torch.matmul(xf, wf), 20)
        del xf, wf
        nbytes = 4 * m * k + 4 * k * n + 4 * n + 4 * m * n
        bms, by = bound_ms(nbytes, 2.0 * m * k * n, F32_OPS_PER_S)
        rows.append(dict(m=m, k=k, n=n, af=af, bits=bits, ms=ms, plain_ms=pms,
                         bound_ms=bms, bound_by=by, max_abs_err=0.0,
                         library_ms=lib_ms, call_ms=call_ms, **win))
        print(f"kernel fxp_gemm_fused x32 (FxP{bits} int32 codes) M={m} "
              f"K={k} N={n} af={af}: {ms:.4f} ms on the device ({win['held']} "
              f"of {win['iters']} records), {call_ms:.4f} ms per wrapper "
              f"call (plain {pms:.4f} ms, bound {bms:.4f} ms by {by}, "
              f"{100 * bms / ms:.1f}% of bound; library torch.matmul on f32 "
              f"codes {lib_ms:.4f} ms), bit-equal", flush=True)
        del x, w
    m, k, n = SLOTS, 13824, 5120
    q = (1 << 31) - 1
    x = torch.full((m, k), q, dtype=torch.int32, device=dev)
    x[1] = -q - 1
    x[-1, ::3] = -q
    w = torch.where(torch.arange(n, device=dev) % 2 == 0, q, -q)
    w = w.to(torch.int32).expand(k, n).clone()
    w[:, 2] = -q - 1
    scale = torch.full((n,), 2.0 ** -70, device=dev)
    for af in (None, "silu"):
        got = fxp_gemm_fused(x, w, scale, af=af, hr_stages=hr, lv_stages=lv)
        ref = fxp_gemm_fused_plain(x, w, scale, af=af, hr_stages=hr,
                                   lv_stages=lv)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"fxp_gemm_fused x32 at extreme codes {m}x{k}x{n}+{af}: "
                 "not bit-equal to plain")
    win = {}
    ms = timed(lambda: fxp_gemm_fused(x, w, scale), 20, record, win)
    held_all("fxp_gemm_fused x32 at extreme codes", win, record)
    print(f"kernel fxp_gemm_fused x32 at codes +-(2^31 - 1) and -2^31 M={m} "
          f"K={k} N={n}: {ms:.4f} ms on the device ({win['held']} of "
          f"{win['iters']} records), sums up to {float(k) * 2.0 ** 62:.3e}, "
          "bit-equal with and without silu", flush=True)
    return rows


def expert_queues(dev, gen, e, m, k, tokens, top_k, q):
    """Activation codes [e, m, k] of a routed bank: each of `tokens`
    tokens fills a row of its top-k experts' queues (codes in [-q, q], no
    all-zero filled row); `tokens` None fills every row."""
    x = torch.zeros((e, m, k), dtype=torch.int8, device=dev)
    if tokens is None:
        x.random_(-q, q + 1, generator=gen)
        return x
    choice = torch.stack([torch.randperm(e, generator=gen,
                                         device=dev)[:top_k]
                          for _ in range(tokens)])
    for t in range(tokens):
        for ex in choice[t].tolist():
            slot = int((x[ex].abs().sum(-1) > 0).sum())
            x[ex, slot].random_(-q, q + 1, generator=gen)
            x[ex, slot, 0] = 1
    return x


def packed_batched_gemm_phase(dev, gen):
    """The expert-batched entry on packed FxP4 banks (DeepSeekMoE under
    edge4) at the decode and prefill banks, as `batched_gemm_phase`: FxP4
    activation codes, nibble bytes [64, K, N/2]; bit-equal to its plain
    per-expert loop, timed on the tensor-core core's records. The bound
    counts half a byte per weight of the experts this input routes to.
    -> the decode w1 bank's row."""
    from repro_torch.kernels.fxp_gemm.fxp_gemm import (
        fxp_gemm_fused_batched, fxp_gemm_fused_batched_plain)
    e, top_k = 64, 6
    first = None
    for m, k, n, tokens in ((SLOTS, 2048, 1408, SLOTS),
                            (SLOTS, 1408, 2048, SLOTS),
                            (16, 2048, 1408, 16),
                            (SLOTS, 2048, 1408, None)):
        x = expert_queues(dev, gen, e, m, k, tokens, top_k, 7)
        w = torch.randint(-128, 128, (e, k, n // 2), generator=gen,
                          device=dev, dtype=torch.int8)
        scale = torch.rand((e, 1, n), generator=gen, device=dev) * 1e-2

        def run():
            return fxp_gemm_fused_batched(x, w, scale, packed=True)

        def plain():
            return fxp_gemm_fused_batched_plain(x, w, scale, packed=True)
        got, ref = run(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"fxp_gemm_fused batched packed E={e} M={m} K={k} N={n}: "
                 "not bit-equal to the per-expert loop")
        win = {}
        ms = timed(run, 20, "fxp_gemm_tc_kernel", win)
        held_all(f"fxp_gemm_fused batched packed E={e} M={m} K={k} N={n}",
                 win)
        pms = timed(plain, 2)
        active = int((x.reshape(e, -1) != 0).any(-1).sum())
        filled = int((x != 0).any(-1).sum())
        nbytes = e * m * k + active * k * n // 2 + 4 * e * n + 4 * e * m * n
        bms, by = bound_ms(nbytes, 2.0 * filled * k * n, INT8_OPS_PER_S)
        occupancy = ("all queues full" if tokens is None else
                     f"{tokens} tokens x top-{top_k}") + (
                         f": {filled} filled rows in {active} routed experts")
        print(f"kernel fxp_gemm_fused batched packed FxP4 E={e} M={m} K={k} "
              f"N={n} ({occupancy}): {ms:.4f} ms on the device (plain loop "
              f"{pms:.4f} ms, bound {bms:.4f} ms by {by}, "
              f"{100 * bms / ms:.1f}% of bound), bit-equal", flush=True)
        if first is None:
            first = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                         max_abs_err=0.0, **win,
                         shape=f"E={e} M={m} K={k} N={n} ({occupancy})")
    return first


def paged_attention_inputs(dev, gen, quant: bool, lengths, kvh=8, g=5, *,
                           hd=128, mb=None, holes=(), empty=()):
    """Pools, tables and metadata for SLOTS rows holding `lengths` cached
    tokens each (the query at that position, valid length one more), in
    blocks shuffled over the pool, tables ending in sentinel entries (`mb`
    slots; by default two past the longest row's blocks). `holes`: (row,
    slot) entries set back to the sentinel inside the row's window, as
    clear_table_entry can leave; `empty`: rows whose valid length is 0
    over their allocated blocks (an empty window). Returns a dict of the
    tensors, `nbytes`, the pool bytes the function needs (K, V and their
    scales at each allocated position of a window; V and its scales over
    the whole table of an empty window), and for the operation count
    `scored`, the positions of the windows, and `weighed`, the positions
    AV weighs (an empty window's: the whole table)."""
    bs = 16
    need = [-(-(n + 1) // bs) for n in lengths]
    mb = mb or max(need) + 2
    nb = sum(need) + 8
    perm = torch.randperm(
        nb, generator=torch.Generator().manual_seed(nb)).tolist()
    tables = torch.full((SLOTS, mb), nb, dtype=torch.int32)
    it = iter(perm)
    for b, n_blk in enumerate(need):
        for j in range(n_blk):
            tables[b, j] = next(it)
    for b, j in holes:
        tables[b, j] = nb
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
    kvv = lens + 1
    kvv[list(empty)] = 0
    meta = torch.stack([lens, kvv, lens], dim=1).to(dev)
    row = kvh * (hd * k.element_size() + (4 if quant else 0))
    nbytes = scored = weighed = 0
    for b, n in enumerate(lengths):
        alloc = (tables[b] < nb).tolist()
        if b in empty:
            nbytes += row * bs * sum(alloc)
            weighed += mb * bs
            continue
        w = n + 1
        held = sum(min(bs, w - j * bs) for j in range(need[b]) if alloc[j])
        nbytes += 2 * row * held
        scored += w
        weighed += w
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, tables=tables.to(dev),
                meta=meta, nbytes=nbytes, scored=scored, weighed=weighed)


# rows of the attention phases (cached tokens per row): the smoke's
# 1024-2000 and 4000-12000; the serve paths' own (prompts of 40-64 tokens
# and 16 generated, in 6-block tables of 16 positions); the layouts a
# split must keep (a sentinel entry inside row 0's window, row 1 ending
# mid-block, a one-token row 2, an empty window over row 3's allocated
# blocks); a table wider than a CTA's shared memory holds at C 8 (a row of
# 80000 tokens, as Qwen2.5-14B's 131072-token context reaches), whose
# score rows take the global scratch branch
ATTN_CASES = {
    "1024-2000 tokens": dict(lengths=[1024, 1536, 2000, 1200]),
    "4000-12000 tokens": dict(lengths=[12000, 9000, 11000, 4000]),
    "serve width": dict(lengths=[64, 72, 80, 70], mb=6),
    "layouts": dict(lengths=[1500, 1000, 0, 600], holes=[(0, 40)],
                    empty=[3]),
    "scores in global scratch": dict(lengths=[80000, 1200, 30000, 500]),
}


def attention_plan(t, integer=False):
    """(C, scores in global scratch) the wrappers pick for inputs `t`."""
    from repro_torch.kernels.paged_attention.paged_attention import (
        cluster_plan)
    b, kvh, g, hd = t["q"].shape
    return cluster_plan(b, kvh, g, hd, t["tables"].shape[1], t["k"].shape[1],
                        elem_bytes=t["k"].element_size(), integer=integer)


def check_attention(what, kernel, plain, record, case, want_scratch, c,
                    scratch):
    """Launch `kernel()` twice and hold it against `plain()`: one launch
    per call, bit-identical outputs, finite, within 1% of the output's
    range, the score-row branch the case is meant to take. Returns the
    output, the plain version's and the max |err|."""
    if scratch != want_scratch:
        fail(f"{what} ({case}, C={c}): score rows "
             f"{'in' if scratch else 'not in'} global scratch")
    before = record.launches
    got = kernel()
    again = kernel()
    if record.launches != before + 2:
        fail(f"{what} ({case}): {record.launches - before} launches for 2 "
             "calls")
    ref = plain()
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        fail(f"{what} ({case}): non-finite output")
    if not torch.equal(got, again):
        fail(f"{what} ({case}): two calls on the same inputs differ")
    err = (got.float() - ref.float()).abs().max().item()
    # bf16 output, reductions in another order than the plain einsums
    # (and, integer, a p.v code that flips with them): within 1% of the
    # output's range
    tol = 1e-2 * ref.float().abs().max().item()
    if err > tol:
        fail(f"{what} ({case}, C={c}): max |err| {err} > {tol}")
    return got, ref, err, tol


def attention_phase(dev, gen):
    """The float attention kernel (within 1% of its plain version) on the
    int8 pool with the CORDIC softmax at Qwen2.5-14B's g 5 (4 rows x 8 KV
    heads x hd 128) over every case of ATTN_CASES, on the bf16 pool with
    the exact softmax and at DeepSeekMoE-16B's g 1 (16 KV heads) at
    1024-2000 tokens, and at Zamba2-1.2B's shared attention (plain
    multi-head, g 1, 32 KV heads of hd 64, int8 pool, CORDIC softmax) at
    the serve width and 1024-2000 tokens; each line names the cluster
    size the wrapper picked. Also times scaled_dot_product_attention on
    the 1024-2000 rows, gathered and dequantized beforehand, as a
    yardstick that does less work (no paged gather, no dequant, no
    mask). -> (the first row, Zamba2's rows)."""
    from repro_torch.core.activation import softmax_lv_stages
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.paged_attention import (
        gather_pool_view, paged_attention_float, paged_attention_float_plain)
    result, zamba2 = None, []
    runs = [(True, name, 8, 5, 128) for name in ATTN_CASES]
    runs.insert(1, (False, "1024-2000 tokens", 8, 5, 128))
    runs.insert(2, (True, "1024-2000 tokens", 16, 1, 128))
    runs += [(True, name, 32, 1, 64) for name in ("serve width",
                                                  "1024-2000 tokens")]
    for quant, case, kvh, g, hd in runs:
        t = paged_attention_inputs(dev, gen, quant, kvh=kvh, g=g, hd=hd,
                                   **ATTN_CASES[case])
        q, k, v, tables, meta = (t[n] for n in ("q", "k", "v", "tables",
                                                "meta"))
        c, scratch = attention_plan(t)
        width = tables.shape[1] * k.shape[1]
        kw = dict(k_scale=t["ks"], v_scale=t["vs"], cordic_softmax=quant,
                  hr_stages=4, lv_stages=softmax_lv_stages(width, "fxp8"),
                  out_dtype=torch.bfloat16)
        body = "dequant+cordic" if quant else "bf16+exact"
        _, _, err, tol = check_attention(
            "paged_attention_float",
            lambda: paged_attention_float(q, k, v, tables, meta, **kw),
            lambda: paged_attention_float_plain(q, k, v, tables, meta, **kw),
            paged_attention_float, case, case == "scores in global scratch",
            c, scratch)
        win = {}
        ms = timed(lambda: paged_attention_float(q, k, v, tables, meta,
                                                 **kw), 20,
                   "paged_attention_kernel", win)
        held_all(f"paged_attention_float ({case})", win,
                 "paged_attention_kernel")
        pms = timed(lambda: paged_attention_float_plain(
            q, k, v, tables, meta, **kw), 3)
        b, kvh, g, hd = q.shape
        nbytes = (t["nbytes"] + q.numel() * 2 + b * kvh * g * hd * 2
                  + tables.numel() * 4 + meta.numel() * 4)
        ops = 2.0 * (t["scored"] + t["weighed"]) * kvh * g * hd
        bms, by = bound_ms(nbytes, ops, F32_OPS_PER_S)
        print(f"kernel paged_attention_float {body}, {case}, C={c}"
              f"{', scores in global scratch' if scratch else ''}: B={b} "
              f"KV={kvh} g={g} hd={hd} bs={k.shape[1]} MB={tables.shape[1]}:"
              f" {ms:.4f} ms (plain {pms:.4f} ms, bound {bms:.4f} ms by "
              f"{by}, {100 * bms / ms:.1f}% of bound), max|err| {err} (tol "
              f"{tol:.4g}), two calls bit-identical", flush=True)
        if hd == 64:
            zamba2.append(dict(case=case, ms=ms, plain_ms=pms, bound_ms=bms,
                               bound_by=by, max_abs_err=err, cluster=c,
                               shape=f"B={b} KV={kvh} g={g} hd={hd} bs="
                                     f"{k.shape[1]} MB={tables.shape[1]}",
                               **win))
        if result is None:
            result = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                          max_abs_err=err, cluster=c, **win)
            kd = (gather_pool_view(k, tables).float()
                  * gather_pool_view(t["ks"], tables)).to(torch.bfloat16)
            vd = (gather_pool_view(v, tables).float()
                  * gather_pool_view(t["vs"], tables)).to(torch.bfloat16)
            kd, vd = kd.transpose(1, 2), vd.transpose(1, 2)
            qd = q.reshape(b, kvh * g, 1, hd)
            sdpa = timed(lambda: F.scaled_dot_product_attention(
                qd, kd, vd, enable_gqa=True), 20)
            print(f"yardstick scaled_dot_product_attention(enable_gqa=True) "
                  f"on the {case} rows gathered and dequantized to bf16 "
                  f"beforehand ([{b}, {kvh * g}, 1, {hd}] x [{b}, {kvh}, "
                  f"{kd.shape[2]}, {hd}], no mask): {sdpa:.4f} ms, beside "
                  f"the kernel's {ms:.4f} ms (less work: no paged gather, "
                  "no dequant, no mask, exact softmax)", flush=True)
            del kd, vd
    return result, zamba2


# f32 operations per cached position and query head of the integer
# attention's epilogue, counted from csrc/paged_attention.cu: the scale
# fold 2, the max 1, exp with its subtract ~2, the sum 1, the divide and
# the v-scale product 2, the amax 1, the requantize divide, round and
# clip 4
INT_ATTN_F32_OPS = 2 + 1 + 2 + 1 + 2 + 1 + 4


def attention_int_phase(dev, gen):
    """The integer attention kernel at Qwen2.5-14B's g 5 (4 rows x 8 KV
    heads x hd 128), q / sqrt(hd) quantized per head to FxP8 as the serving
    path does, over every case of ATTN_CASES: within 1% of the output
    range of its plain version; each line names the cluster size the
    wrapper picked."""
    from repro_torch.core.fxp import FORMATS, quantize
    from repro_torch.kernels.paged_attention.paged_attention import (
        paged_attention_int, paged_attention_int_plain)
    fmt = FORMATS["fxp8"]
    result = None
    for case, rows in ATTN_CASES.items():
        t = paged_attention_inputs(dev, gen, True, **rows)
        q, k, tables = t["q"], t["k"], t["tables"]
        b, kvh, g, hd = q.shape
        bs, mb = k.shape[1], tables.shape[1]
        qc, sq = quantize(q.float() / math.sqrt(hd), fmt, axis=3)
        c, scratch = attention_plan(t, integer=True)
        args = (qc, sq, k, t["v"], t["ks"], t["vs"], tables, t["meta"])
        kw = dict(fmt=fmt, out_dtype=torch.bfloat16)
        _, _, err, tol = check_attention(
            "paged_attention_int", lambda: paged_attention_int(*args, **kw),
            lambda: paged_attention_int_plain(*args, **kw),
            paged_attention_int, case, case == "scores in global scratch",
            c, scratch)
        win = {}
        ms = timed(lambda: paged_attention_int(*args, **kw), 20,
                   "paged_attention_int_kernel", win)
        held_all(f"paged_attention_int ({case})", win,
                 "paged_attention_int_kernel")
        pms = timed(lambda: paged_attention_int_plain(*args, **kw), 3)
        nbytes = (t["nbytes"] + qc.numel() + 4 * sq.numel()
                  + 2 * b * kvh * g * hd + 4 * tables.numel()
                  + 4 * t["meta"].numel())
        bms, by = bound_ms(nbytes,
                           2.0 * (t["scored"] + t["weighed"]) * kvh * g * hd,
                           INT8_OPS_PER_S,
                           (INT_ATTN_F32_OPS * t["weighed"] * kvh * g,
                            F32_OPS_PER_S))
        print(f"kernel paged_attention_int exact softmax, {case}, C={c}"
              f"{', scores in global scratch' if scratch else ''}: B={b} "
              f"KV={kvh} g={g} hd={hd} bs={bs} MB={mb}: {ms:.4f} ms (plain "
              f"{pms:.4f} ms, bound {bms:.4f} ms by {by}, "
              f"{100 * bms / ms:.1f}% of bound), max|err| {err} "
              f"(tol {tol:.4g}), two calls bit-identical", flush=True)
        if result is None:
            result = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                          max_abs_err=err, cluster=c, **win)
    return result


# f32 operations per element, counted from csrc/cordic.cuh at FxP8's stage
# counts (4 HR stages, LV 5 for the AF, 12 for the 64-way softmax): the HR
# exp ~45 (clamp, range reduction, 4 stages of 9, 2^k), an LV stage 7; the
# two per-tensor snaps of csrc/fxp_snap.cuh: |x| into the max, a divide,
# rint, the clamp, the codes' round trip and the multiply, twice
CORDIC_SILU_OPS = 45 + 3 + 5 * 7 + 1
CORDIC_SOFTMAX_OPS = 2 + 45 + 1 + 12 * 7
CORDIC_SNAP_OPS = 2 * (1 + 1 + 1 + 2 + 2 + 1)


def op_ms(fn, iters: int, record: str):
    """(device ms per call of every record, records per call, device ms
    per call of the kernel `record`, window) of `fn()`, one profiler
    window (taken again, up to WINDOW_TRIES times, while it holds fewer than
    `iters` kernel records; then both times are the CUDA-event time)."""
    fn()
    for _ in range(WINDOW_TRIES):
        rec = profile_window(fn, iters)
        held, kernel_ms = matching(rec, record)
        n_all, all_ms = matching(rec, None)
        if held == iters and kernel_ms > 0:
            return (all_ms / iters, n_all / iters, kernel_ms / iters,
                    dict(held=held, iters=iters))
        print(f"profiler: {held} records of {record} for {iters} launches; "
              "measuring again", flush=True)
    TIMING["source"] = "cuda events"
    ms = cuda_ms(fn, iters)
    return ms, None, ms, dict(held=held, iters=iters)


def empty_launch_ms() -> float:
    """Device time of an empty launch (`torch.cuda._sleep(0)`): the floor
    any one-launch op pays, whatever its work."""
    ms = timed(lambda: torch.cuda._sleep(0), 20)
    print(f"empty launch (torch.cuda._sleep(0)): {ms:.4f} ms a call, the "
          "floor of any one-launch op", flush=True)
    return ms


def cordic_af_phase(dev, gen):
    """The CORDIC AF op, one launch of csrc/cordic_af.cu with both FxP
    snaps, at the MoE expert activations as the path calls it (silu on
    bf16; 64 experts x 4 queue slots x 1408 at decode, x 16 per prefill
    chunk, and the shared experts' 4 x 2816) under FxP8 (moe fxp8) and
    FxP4 (moe edge4), and at a tensor past the registers of the resident
    grid (the fallback that reads x in each phase): bit-equal to the plain
    op, timed by all of its device records and by its kernel record; and
    without a precision on f32 (the kernel alone) against the plain AF."""
    from repro_torch.kernels.cordic_af.cordic_af import (
        cordic_af, cordic_af_plain, cordic_af_reference)
    rows = []
    shapes = ((1, 64, SLOTS, 1408), (1, 64, 16, 1408), (1, SLOTS, 2816),
              (4, 1 << 20, 2))
    for shape in shapes:
        xf = torch.randn(shape, generator=gen, device=dev) * 3
        x = xf.to(torch.bfloat16)
        for inp, precision in ((x, "fxp8"), (x, "fxp4"), (x, None),
                               (xf, "fxp8"), (xf, None)):
            got = cordic_af(inp, "silu", precision=precision)
            ref = cordic_af_reference(inp, "silu", precision=precision)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                err = (got.float() - ref.float()).abs().max().item()
                fail(f"cordic_af silu {shape} {inp.dtype} precision "
                     f"{precision}: max |err| {err}, not bit-equal to the "
                     "plain op")
        if not torch.equal(cordic_af(xf, "silu"),
                           cordic_af_plain(xf, "silu", 4, 5)):
            fail(f"cordic_af silu {shape}: not bit-equal to the plain AF")
        n = x.numel()
        for precision in ("fxp8", "fxp4"):
            ms, recs, kms, win = op_ms(
                lambda: cordic_af(x, "silu", precision=precision), 20,
                "cordic_af_kernel")
            pms = timed(lambda: cordic_af_reference(x, "silu",
                                                    precision=precision), 3)
            bms, by = bound_ms(4.0 * n, (CORDIC_SILU_OPS + CORDIC_SNAP_OPS)
                               * n, F32_OPS_PER_S)
            rows.append(dict(shape=shape, precision=precision, ms=kms,
                             op_ms=ms, records=recs, plain_ms=pms,
                             bound_ms=bms, bound_by=by, max_abs_err=0.0,
                             **win))
            print(f"kernel cordic_af silu bf16 {precision} {list(shape)}: "
                  f"op {ms:.4f} ms in {recs} records a call, kernel record "
                  f"{kms:.4f} ms (plain op {pms:.4f} ms, bound {bms:.4f} ms "
                  f"by {by}, {100 * bms / kms:.1f}% of bound), bit-equal",
                  flush=True)
        raw = timed(lambda: cordic_af(xf, "silu"), 20, "cordic_af_kernel")
        raw_plain = timed(lambda: cordic_af_plain(xf, "silu", 4, 5), 3)
        print(f"kernel cordic_af silu f32, no precision, {list(shape)}: "
              f"{raw:.4f} ms (plain AF {raw_plain:.4f} ms), bit-equal",
              flush=True)
    return rows


def cordic_gate_phase(dev, gen):
    """The CORDIC AF op at the SSM gate (`ssm._gated_norm`: SiLU on bf16
    under FxP8), one launch a call: Mamba2-370M's [4, 1, 2048] at decode
    and [1, 16, 2048] per prefill chunk, Zamba2-1.2B's [4, 1, 4096] and
    [1, 16, 4096]; bit-equal to the plain op, timed by all of its device
    records and by its kernel record. -> the rows."""
    from repro_torch.kernels.cordic_af.cordic_af import (
        cordic_af, cordic_af_reference)
    rows = []
    for shape in ((SLOTS, 1, 2048), (1, 16, 2048), (SLOTS, 1, 4096),
                  (1, 16, 4096)):
        x = (torch.randn(shape, generator=gen, device=dev) * 3).to(
            torch.bfloat16)
        before = cordic_af.launches
        got = cordic_af(x, "silu", precision="fxp8")
        if cordic_af.launches != before + 1:
            fail(f"cordic_af gate {list(shape)}: "
                 f"{cordic_af.launches - before} launches for one call")
        ref = cordic_af_reference(x, "silu", precision="fxp8")
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"cordic_af gate silu bf16 fxp8 {list(shape)}: max |err| "
                 f"{(got.float() - ref.float()).abs().max().item()}, not "
                 "bit-equal to the plain op")
        ms, recs, kms, win = op_ms(
            lambda: cordic_af(x, "silu", precision="fxp8"), 20,
            "cordic_af_kernel")
        pms = timed(lambda: cordic_af_reference(x, "silu", precision="fxp8"),
                    3)
        n = x.numel()
        bms, by = bound_ms(4.0 * n, (CORDIC_SILU_OPS + CORDIC_SNAP_OPS) * n,
                           F32_OPS_PER_S)
        rows.append(dict(shape=shape, precision="fxp8", ms=kms, op_ms=ms,
                         records=recs, plain_ms=pms, bound_ms=bms,
                         bound_by=by, max_abs_err=0.0, **win))
        print(f"kernel cordic_af silu bf16 fxp8 SSM gate {list(shape)}: op "
              f"{ms:.4f} ms in {recs} records a call, kernel record "
              f"{kms:.4f} ms (plain op {pms:.4f} ms, bound {bms:.6f} ms by "
              f"{by}, {100 * bms / kms:.1f}% of bound), bit-equal",
              flush=True)
    return rows


def cordic_softmax_phase(dev, gen):
    """The CORDIC softmax op, one launch of csrc/cordic_softmax.cu with
    both FxP snaps, at the router's rows as the path calls it (f32 logits,
    4 decode tokens and one 16-token prefill chunk, 64 experts, lv 12)
    under FxP8, and at a wide row (the fallback that walks 4096 columns
    from memory): bit-equal to the plain op, timed by all of its device
    records and by its kernel record; and without a precision (the row
    softmax alone) against the plain version."""
    from repro_torch.core.activation import softmax_lv_stages
    from repro_torch.kernels.cordic_softmax.cordic_softmax import (
        cordic_softmax, cordic_softmax_plain, cordic_softmax_reference)
    rows = []
    for m, n in ((SLOTS, 64), (16, 64), (8, 4096)):
        x = torch.randn((m, n), generator=gen, device=dev) * 2
        lv = softmax_lv_stages(n, "fxp8")
        for inp in (x, x.to(torch.bfloat16)):
            for precision in ("fxp8", "fxp4", None):
                got = cordic_softmax(inp, precision=precision)
                ref = cordic_softmax_reference(inp, precision=precision)
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    fail(f"cordic_softmax [{m}, {n}] {inp.dtype} precision "
                         f"{precision}: max |err| "
                         f"{(got.float() - ref.float()).abs().max().item()}, "
                         "not bit-equal to the plain op")
        raw = cordic_softmax(x, hr_stages=4, lv_stages=lv)
        if not torch.equal(raw, cordic_softmax_plain(x, 4, lv)):
            fail(f"cordic_softmax [{m}, {n}]: the rows are not bit-equal to "
                 "the plain version")
        if (raw.sum(-1) - 1).abs().max().item() > n * 2.0 ** -(lv - 1):
            fail(f"cordic_softmax [{m}, {n}]: rows do not sum to 1")
        ms, recs, kms, win = op_ms(
            lambda: cordic_softmax(x, precision="fxp8"), 20,
            "cordic_softmax_kernel")
        pms = timed(lambda: cordic_softmax_reference(x, precision="fxp8"), 3)
        bms, by = bound_ms(8.0 * m * n, (CORDIC_SOFTMAX_OPS + CORDIC_SNAP_OPS)
                           * m * n, F32_OPS_PER_S)
        raw_ms = timed(lambda: cordic_softmax(x, hr_stages=4, lv_stages=lv),
                       20, "cordic_softmax_kernel")
        raw_plain = timed(lambda: cordic_softmax_plain(x, 4, lv), 3)
        rows.append(dict(shape=(m, n), precision="fxp8", ms=kms, op_ms=ms,
                         records=recs, plain_ms=pms, bound_ms=bms,
                         bound_by=by, max_abs_err=0.0, **win))
        print(f"kernel cordic_softmax f32 fxp8 [{m}, {n}] lv={lv}: op "
              f"{ms:.4f} ms in {recs} records a call, kernel record "
              f"{kms:.4f} ms (plain op {pms:.4f} ms, bound {bms:.6f} ms by "
              f"{by}); no precision {raw_ms:.4f} ms (plain rows "
              f"{raw_plain:.4f} ms); bit-equal", flush=True)
    return rows


# ---------------------------------------------------------------------------
# phases 4-5: serving
# ---------------------------------------------------------------------------

def serve_tokens(engine, reqs):
    from repro_torch.launch.serve import serve
    finished, dt = serve(engine, reqs)
    return [o.tokens for o in finished], finished, dt


def policy(name: str, backend: str):
    """The serving policies of the paths: FxP8 and FxP32 (the CLI's
    flexpe-fxp8 and flexpe-fxp32), edge4 (the CLI's edge4: packed FxP4
    weights, FxP4 activations, CORDIC AF and attention softmax at FxP4
    stages) and integer attention (FxP8 with the exact AF and softmax and
    `int_attention`, the reference's int8_attn serving variant). The
    fleet's replicas take the ladder's `tier_policy`."""
    from repro_torch.core.precision import PrecisionPolicy
    if name == "edge4":
        return PrecisionPolicy.edge4(backend=backend)
    if name == "int-attention":
        return dataclasses.replace(
            PrecisionPolicy.flexpe(8, af_impl="exact", backend=backend),
            int_attention=True)
    return PrecisionPolicy.flexpe(int(name[3:]), backend=backend)


#: the served paths: (architecture, policy, "fleet" for the tiered fleet
#: of FLEET's replicas, or "spec" for the speculative fleet, `spec_phase`)
PATHS = (("qwen2_5_14b", "fxp8"), ("deepseek_moe_16b", "fxp8"),
         ("qwen2_5_14b", "edge4"), ("qwen2_5_14b", "int-attention"),
         ("deepseek_moe_16b", "edge4"), ("qwen2_5_14b", "fleet"),
         ("qwen2_5_14b", "fxp32"), ("mamba2_370m", "fxp8"),
         ("zamba2_1p2b", "fxp8"), ("qwen2_5_14b", "spec"))


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


def check_quantize_phase(dev):
    """The FxP32 quantize on the card: 1 / scale is 2^31 in f32 and
    saturates to 2^31 - 1, as the reference's XLA cast does (the codes of
    [1, -1, 0.5, 0.3] below are the reference's, which the CPU tests hold
    bit for bit); on seeded rows the card's codes equal the CPU's at FxP24
    and FxP32 under the same scale."""
    from repro_torch.core.fxp import FORMATS, quantize
    want = [(1 << 31) - 1, -(1 << 31), 1 << 30, 644245120]
    got = quantize(torch.tensor([1.0, -1.0, 0.5, 0.3], device=dev),
                   FORMATS["fxp32"])[0].tolist()
    if got != want:
        fail(f"FxP32 quantize on the card: {got}, the reference's {want}")
    x = torch.randn((64, 5120), generator=torch.Generator().manual_seed(0))
    for fmt in ("fxp24", "fxp32"):
        codes, scale = quantize(x, FORMATS[fmt], axis=1)
        on_card = quantize(x.to(dev), FORMATS[fmt], scale=scale.to(dev))[0]
        if not torch.equal(on_card.cpu(), codes):
            fail(f"{fmt} quantize: the card's codes differ from the CPU's")
    cast = torch.tensor([2.0 ** 31], device=dev).to(torch.int32).item()
    print(f"check FxP32 quantize on the card: [1, -1, 0.5, 0.3] -> {got} "
          "(saturated, the reference's codes); FxP24 and FxP32 codes of "
          "64 x 5120 seeded rows equal the CPU's; PyTorch's own f32 -> "
          f"int32 cast of 2^31 on the card gives {cast}", flush=True)


@contextlib.contextmanager
def plain_attention():
    """The kernels backend with the paged attentions' plain versions in
    place of their kernels; every other kernel stays."""
    from repro_torch.kernels import dispatch
    key = ("paged_attention", "kernels")
    kernel = dispatch._REGISTRY[key]
    dispatch._REGISTRY[key] = dispatch.lookup("paged_attention", "reference")
    try:
        yield
    finally:
        dispatch._REGISTRY[key] = kernel


def against_plain(label, run):
    """`run(backend)` -> ([(tier, tokens)] of every request, anything else
    to compare). The kernels must give the plain path's result. Only an
    fxp4 request may differ, and then the kernels with the attentions'
    plain versions in place (`plain_attention`) must give the plain
    path's result exactly: every other kernel is bit-equal, the attention
    kernel sums in another order (held within 1% in the kernels phase),
    and FxP4's 16-step per-tensor grid can snap that into other codes.
    -> {request index: first differing generated token}."""
    got = {b: run(b) for b in ("kernels", "reference")}
    if got["kernels"] == got["reference"]:
        return {}
    first = {}
    for i, ((tier, a), (_, b)) in enumerate(zip(got["kernels"][0],
                                                got["reference"][0])):
        if a != b:
            if tier != "fxp4":
                fail(f"{label}: {tier} request {i}: kernels {a} != plain {b}")
            first[i] = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
    with plain_attention():
        again = run("kernels")
    if again != got["reference"]:
        fail(f"{label}: kernels {got['kernels']} != plain "
             f"{got['reference']}, also with the attentions' plain versions "
             f"in place: {again}")
    rest = ("equal" if got["kernels"][1:] == got["reference"][1:]
            else "differ")
    print(f"{label}: fxp4 requests {sorted(first)} differ between kernels "
          f"and plain path from generated tokens {first} on (the other "
          f"results {rest}); with the attentions' plain versions in place "
          "the kernels give the plain path's result exactly", flush=True)
    return first


def check_fleet_phase(dev):
    """The reduced fleet of every rung of the ladder (fxp4, fxp8, fxp16 and
    bf16 replicas, tiered routing; 16 requests, so four land on each)
    through the kernels and through the plain path: the same tier stamped
    on every request and the same greedy tokens. Then the pin contract:
    with every request pinned to one tier, the fleet gives the tokens of
    a single engine of that tier over the same bank."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import tier_policy
    from repro_torch.core.qtensor import TieredWeights
    from repro_torch.launch.serve import build_fleet, make_requests
    from repro_torch.models import model as M
    from repro_torch.serving import EngineRouter, ServingEngine
    cfg = get_config("qwen2_5_14b").reduced()
    kw = dict(max_slots=SLOTS, max_len=48, prefill_chunk=16,
              kv_block_size=16, overlap=True)
    got = {}

    def run(backend):
        router = build_fleet(cfg, list(LADDER), backend=backend, seed=0,
                             device=dev, routing="tiered", **kw)
        finished = serve_tokens(router, make_requests(cfg, 16, 32, 16,
                                                      mixed=True, seed=0))[1]
        res = [(o.tier, o.tokens) for o in finished]
        got.setdefault(backend, res)     # the first run of each backend
        return (res,)
    differ = against_plain(f"check reduced fleet {','.join(LADDER)}", run)
    got = got["reference"]
    placed = sorted({t for t, _ in got})
    if placed != sorted(LADDER):
        fail(f"reduced fleet: requests placed on {placed} only")
    bank = TieredWeights(M.init_params(cfg, 0, device=dev), LADDER,
                         consume=True)
    for tier in LADDER:
        router = EngineRouter(cfg, bank, tiers=list(LADDER),
                              routing="tiered", backend="kernels", seed=0,
                              device=dev, **kw)
        pinned = serve_tokens(router, make_requests(
            cfg, 8, 32, 16, mixed=True, seed=0, tier=tier))[1]
        single = ServingEngine(cfg, bank.for_tier(tier),
                               policy=tier_policy(tier, backend="kernels"),
                               seed=0, device=dev, **kw)
        alone = serve_tokens(single, make_requests(cfg, 8, 32, 16, mixed=True,
                                                   seed=0))[0]
        if [o.tokens for o in pinned] != alone or any(
                o.tier != tier for o in pinned):
            fail(f"reduced fleet pinned to {tier}: tokens or tiers differ "
                 "from a single engine of that tier over the same bank")
    print(f"check reduced fleet {','.join(LADDER)}: kernels == plain path on "
          f"the card ({sum(len(t) for _, t in got)} greedy tokens, the same "
          f"tiers; {len(differ)} fxp4 requests only with the attentions' "
          "plain versions); pinned to each tier == a single engine of that "
          "tier over the same bank", flush=True)


def spec_requests(cfg, prompt_len):
    """The serve workload (8 mixed requests, 16 greedy tokens each), pinned
    alternately to the speculative fleet's two tiers."""
    from repro_torch.launch.serve import make_requests
    reqs = make_requests(cfg, 8, prompt_len, 16, mixed=True, seed=0)
    for i, r in enumerate(reqs):
        r.tier = SPEC_TIERS[i % 2]
    return reqs


def drive_audited(router, reqs):
    """Serve `reqs`, auditing every replica's block ledger (and each
    coordinator's slot pairing) after every round; after the drain every
    pool must hold all its blocks again. -> (finished outputs in id order,
    seconds)."""
    from repro_torch.serving import SpecDecodeCoordinator
    t0 = time.perf_counter()
    for r in reqs:
        router.submit(r)
    done = {}
    while router.has_work():
        for out in router.step():
            if out.finished:
                done[out.id] = out
        router.check_invariants()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for eng in router.engines:
        for side in ([eng.draft, eng.verify]
                     if isinstance(eng, SpecDecodeCoordinator) else [eng]):
            st = side.sched.stats()
            if st["held_blocks"] or (st["free_blocks"] + st["cached_blocks"]
                                     != st["kv_blocks"]):
                fail(f"a {side.tier} engine's pool did not get its blocks "
                     f"back after the drain: {st}")
    return [done[i] for i in sorted(done)], dt


def top2_margin(cfg, params, policy, prompt, prefix, dev):
    """(top-1 minus top-2 logit, logit range) of the next token after
    `prompt + prefix` under `policy`, prefilled in chunks of 16 into a
    batch-1 cache: how near a tie that position is."""
    from repro_torch.models import model as M
    seq = list(prompt) + list(prefix)
    cache = M.init_cache(cfg, 1, len(seq) + 16, policy, device=dev)
    for s in range(0, len(seq), 16):
        block = seq[s:s + 16]
        tokens = torch.zeros((1, 16), dtype=torch.long, device=dev)
        tokens[0, :len(block)] = torch.tensor(block, device=dev)
        logits, cache = M.decode_step(
            cfg, params, cache, tokens, policy=policy,
            n_valid=torch.tensor([len(block)], dtype=torch.int32,
                                 device=dev), last_only=True)
    lg = logits[0, -1, :cfg.vocab].float()
    top = torch.topk(lg, 2).values
    return float(top[0] - top[1]), float(lg.max() - lg.min())


def spec_against_plain(label, cfg, bank, spec, plain, dev):
    """Gate (b): every request of the speculative fleet equals the plain
    fleet's over the same bank. The fxp4 replicas see the same batches,
    so their requests must be equal outright. A bf16 request may diverge
    only at a near tie of the verify tier (the verify dispatch's f32
    GEMMs run M = B(k+1) rows, a decode's B, and cuBLAS may sum them in
    another order): each divergence's first position and top-2 logit
    margin are printed, and every margin must be under 1% of the logit
    range. -> the divergences."""
    from repro_torch.core.precision import tier_policy
    diverged = []
    for s, p in zip(spec, plain):
        if (s.id, s.tier) != (p.id, p.tier):
            fail(f"{label}: request {s.id} served at {s.tier}, request "
                 f"{p.id} at {p.tier} in the plain fleet")
        if s.tokens == p.tokens:
            continue
        if s.tier != "bf16":
            fail(f"{label}: {s.tier} request {s.id} gave {s.tokens} in the "
                 f"speculative fleet, {p.tokens} in the plain fleet")
        j = next(i for i, (a, b) in enumerate(zip(s.tokens, p.tokens))
                 if a != b)
        margin, span = top2_margin(
            cfg, bank.for_tier("bf16"), tier_policy("bf16", "kernels"),
            s.prompt, p.tokens[:j], dev)
        diverged.append(dict(id=s.id, position=j, margin=margin,
                             logit_range=span,
                             share=margin / max(span, 1e-30)))
        print(f"{label}: bf16 request {s.id} diverges at generated token "
              f"{j} (speculative {s.tokens[j]}, plain {p.tokens[j]}); top-2 "
              f"logit margin there {margin:.6f} of a range {span:.4f} "
              f"({100 * margin / max(span, 1e-30):.3f}%)", flush=True)
    wide = [d for d in diverged if d["share"] >= 0.01]
    if wide:
        fail(f"{label}: bf16 divergences at margins of 1% of the logit "
             f"range or more: {wide}")
    return diverged


def check_spec_phase(dev):
    """Reduced Qwen2.5-14B's speculative fleet (an fxp4 replica and a bf16
    replica whose draft is the bank's fxp4 view, `spec_decode="fxp4:bf16"`,
    k 4) through the kernels and through the plain path on the card: the
    same tokens and the same `spec_*` counters (gate a); and against a
    plain fxp4+bf16 fleet over the same bank (gate b)."""
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import TieredWeights
    from repro_torch.models import model as M
    from repro_torch.serving import EngineRouter
    cfg = get_config("qwen2_5_14b").reduced()
    bank = TieredWeights(M.init_params(cfg, 0, device=dev), SPEC_TIERS,
                         consume=True)
    kw = dict(max_slots=SLOTS, max_len=48, prefill_chunk=16,
              kv_block_size=16, seed=0, device=dev, routing="tiered")
    outs, counters = {}, {}

    def run(backend):
        router = EngineRouter(cfg, bank, tiers=list(SPEC_TIERS),
                              spec_decode=SPEC, spec_k=SPEC_K,
                              backend=backend, **kw)
        res = drive_audited(router, spec_requests(cfg, 32))[0]
        st = router.stats()
        outs.setdefault(backend, res)    # the first run of each backend
        counters.setdefault(backend, {c: st[c] for c in SPEC_COUNTERS})
        return ([(o.tier, o.tokens) for o in res],
                {c: st[c] for c in SPEC_COUNTERS})
    label = f"check reduced speculative fleet {SPEC} k={SPEC_K}"
    differ = against_plain(label, run)
    counters = counters["kernels"]
    plain = EngineRouter(cfg, bank, tiers=list(SPEC_TIERS),
                         backend="kernels", **kw)
    plain_outs = drive_audited(plain, spec_requests(cfg, 32))[0]
    diverged = spec_against_plain(label, cfg, bank, outs["kernels"],
                                  plain_outs, dev)
    print(f"{label}: kernels == plain path on the card "
          f"({sum(len(o.tokens) for o in outs['kernels'])} greedy tokens, "
          f"counters {counters}; {len(differ)} fxp4 requests only with the "
          "attentions' plain versions); against a plain fxp4+bf16 fleet "
          f"over the same bank: {len(diverged)} bf16 requests diverge at a "
          "near tie, the rest are equal", flush=True)


#: each kernel wrapper's name and the names of its device records
RECORDS = {"fxp_gemm_fused": "fxp_gemm_tc_kernel",
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
    lm_head GEMM; no GEMM kernel under bf16, whose matmuls are
    `torch.matmul` in f32. A Mamba2 layer makes its in_proj and out_proj
    GEMMs
    and one CORDIC AF (the SiLU gate); the hybrid's shared block, after
    each group of attn_every layers, its in_proj, q/k/v/o, w1 + GELU and
    w2 GEMMs and one float attention."""
    gemm = pol.matmul is not None       # bf16: every matmul torch.matmul
    if cfg.family in ("ssm", "hybrid"):
        apps = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
                else 0)
        return {"fxp_gemm_fused": gemm * (2 * cfg.n_layers + 7 * apps + 1),
                "paged_attention_float": apps,
                "cordic_af": cfg.n_layers, "cordic_softmax": 0,
                "paged_attention_int": 0}
    moe = cfg.family == "moe"
    int_attn = pol.int_attention and pol.attn_softmax != "cordic"
    return {"fxp_gemm_fused": gemm * (cfg.n_layers * (4 + (6 if moe else 3))
                                      + 1),
            "paged_attention_float": 0 if int_attn else cfg.n_layers,
            "cordic_af": 2 * cfg.n_layers if moe else 0,
            "cordic_softmax": cfg.n_layers if moe else 0,
            "paged_attention_int": cfg.n_layers if int_attn else 0}


def modes_per_decode_step(cfg, pol) -> dict:
    """The fused GEMM's launches per decode step by kernel mode: every
    GEMM on the x32 mode past 16 bits and on the wide mode past 8 bits;
    the three routed expert banks of a MoE layer on a batched mode;
    packed modes under FxP4."""
    from repro_torch.core.fxp import FORMATS
    from repro_torch.kernels.fxp_gemm.fxp_gemm import GEMM_MODES
    n = launches_per_decode_step(cfg, pol)["fxp_gemm_fused"]
    out = dict.fromkeys(GEMM_MODES, 0)
    if pol.matmul is None:
        return out
    bits = FORMATS[pol.matmul].bits
    if bits > 8:
        out["x32" if bits > 16 else "wide"] = n
        return out
    packed = pol.matmul == "fxp4"
    banks = 3 * cfg.n_layers if cfg.family == "moe" else 0
    out["batched_packed" if packed else "batched"] = banks
    out["packed" if packed else "int8"] += n - banks
    return out


def build_path(dev, cfg, policy_name, **kw):
    """(engine or router, [(label, executor, policy)] of its replicas) of a
    full-width path, from seed 0."""
    from repro_torch.launch.serve import build_engine, build_fleet
    if policy_name == "fleet":
        router = build_fleet(cfg, list(FLEET), backend="kernels", seed=0,
                             device=dev, routing="tiered", tier_threshold=1.0,
                             **kw)
        return router, [(f"{e.tier} replica", e.ex, e.policy)
                        for e in router.engines]
    pol = policy(policy_name, "kernels")
    engine = build_engine(cfg, pol, seed=0, device=dev, **kw)
    return engine, [("", engine.ex, pol)]


class _KernelNodeParams(ctypes.Structure):
    """`CUDA_KERNEL_NODE_PARAMS_v2` of cuda.h (libcuda)."""
    _fields_ = [("func", ctypes.c_void_p)] + [
        (f, ctypes.c_uint) for f in ("grid_x", "grid_y", "grid_z", "block_x",
                                     "block_y", "block_z", "shared_bytes")
    ] + [("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
         ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_kernel_counts(cfg, ex, pol) -> tuple:
    """Launches of each kernel of the serving path (KERNELS' order) in one
    decode step over executor `ex`'s cache, counted as the kernel nodes of
    a CUDA graph that captured it, by their functions' names (libcuda's
    cuGraphKernelNodeGetParams_v2 and cuFuncGetName). Capture runs
    nothing, so the cache is not written."""
    from repro_torch.launch.serve import KERNELS
    from repro_torch.models import model as M
    tokens = torch.zeros((ex.max_slots, 1), dtype=torch.long,
                         device=ex.device)
    n_valid = torch.ones((ex.max_slots,), dtype=torch.int32,
                         device=ex.device)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        M.decode_step(cfg, ex.params, ex.cache, tokens, policy=pol,
                      n_valid=n_valid, last_only=True)
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    nodes = None
    for _ in range(2):
        if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
            fail("cuGraphGetNodes failed on a captured decode step")
        nodes = nodes or (ctypes.c_void_p * n.value)()
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:                       # not a kernel node
            continue
        p = _KernelNodeParams()
        name = ctypes.c_char_p()
        if (cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                             ctypes.byref(p)) != 0
                or (cu.cuFuncGetName(ctypes.byref(name),
                                     ctypes.c_void_p(p.func)) if p.func else
                    cu.cuKernelGetName(ctypes.byref(name),
                                       ctypes.c_void_p(p.kern))) != 0):
            fail("could not name a kernel node of a captured decode step")
        names.append(name.value.decode())
    del graph
    counts = []
    for k in KERNELS:
        rec = RECORDS[k]
        rec = (rec,) if isinstance(rec, str) else rec
        counts.append(sum(any(r in nm for r in rec) for nm in names))
    return tuple(counts)


def serve_phase(dev, arch, policy_name, after=None):
    """Serve the full-width path; `after(cfg, engine)` runs once its own
    checks have passed, while the engine and its weights are alive."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (KERNELS, gemm_mode_counts,
                                          launch_counts, make_requests,
                                          reset_launch_counts)
    cfg = get_config(arch)
    label = f"{arch} {policy_name}"
    gen_tokens, prompt_len = 16, 64
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, replicas = build_path(dev, cfg, policy_name, max_slots=SLOTS,
                                  max_len=prompt_len + gen_tokens,
                                  prefill_chunk=16, kv_block_size=16,
                                  overlap=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    gib = 2 ** 30
    setup_peak = torch.cuda.max_memory_allocated() / gib
    weights = ""
    if policy_name == "fleet":
        per_tier = engine.tiered_weights.bytes_by_tier()
        weights = "; weight banks " + ", ".join(
            f"{t} {per_tier[t] / gib:.2f} GiB" for t in FLEET)
    print(f"serve setup: full-width {label}, {cfg.n_layers} layers, random "
          f"weights quantized to "
          f"{', '.join(p.matmul for _, _, p in replicas)} in {setup_s:.1f} "
          f"s, {torch.cuda.memory_allocated() / gib:.2f} GiB on the card, "
          f"peak {setup_peak:.2f} GiB while building{weights}", flush=True)
    expect = {name: launches_per_decode_step(cfg, pol)
              for name, _, pol in replicas}
    modes = {name: modes_per_decode_step(cfg, pol)
             for name, _, pol in replicas}
    for e in expect.values():
        if set(e) != set(KERNELS):
            fail(f"expected launches {sorted(e)} do not name every kernel "
                 f"of the serving path {sorted(KERNELS)}")
    path = list(KERNELS)
    mode_names = list(next(iter(modes.values())))

    def counts():
        c, m = launch_counts(), gemm_mode_counts()
        return (tuple(c[name] for name in path)
                + tuple(m[name] for name in mode_names))

    def want(name):
        return (tuple(expect[name][k] for k in path)
                + tuple(modes[name][k] for k in mode_names))

    # each replica's decode steps: the span on the device stream (events,
    # no sync), the host time to enqueue it, and the launches it made
    spans = {name: [] for name, _, _ in replicas}
    decodes = {name: ex.decode_and_sample for name, ex, _ in replicas}

    def timed_decode(name):
        decode = decodes[name]

        def run(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            c0 = counts()
            h0 = time.perf_counter()
            s.record()
            out = decode(*a, **kw)
            e.record()
            c1 = counts()
            spans[name].append((s, e, time.perf_counter() - h0,
                                tuple(b - a for a, b in zip(c0, c1))))
            return out
        return run
    for name, ex, _ in replicas:
        ex.decode_and_sample = timed_decode(name)

    reqs = make_requests(cfg, 8, prompt_len, gen_tokens, mixed=True, seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    toks, finished, dt = serve_tokens(engine, reqs)
    launches = dict(launch_counts())
    launches.update({f"fxp_gemm_fused:{m}": n
                     for m, n in gemm_mode_counts().items()})
    serve_peak = torch.cuda.max_memory_allocated() / gib

    if len(finished) != len(reqs):
        fail(f"serve {label}: {len(finished)} of {len(reqs)} requests "
             "finished")
    for o in finished:
        if len(o.tokens) != gen_tokens or not all(
                0 <= t < cfg.vocab for t in o.tokens):
            fail(f"serve {label}: request {o.id} returned {o.tokens}")
    ran = {}
    for name, _, _ in replicas:
        for k, n in zip(path + [f"fxp_gemm_fused:{m}" for m in mode_names],
                        want(name)):
            ran[k] = ran.get(k, 0) + n
    for k, n in ran.items():
        if n and launches[k] == 0:
            fail(f"serve {label}: kernel {k} was never launched")
    per_step = {}
    for name, _, _ in replicas:
        steps = sorted({c for _, _, _, c in spans[name]})
        if steps != [want(name)]:
            fail(f"serve {label} {name}: launches per decode step {steps} of "
                 f"{path + mode_names}, the model needs {want(name)}")
        per_step[name] = dict(zip(path + mode_names, steps[0]))
    st = engine.stats()
    total = st["prompt_tokens"] + st["generated_tokens"]
    step_ms = {name: (statistics.median(s.elapsed_time(e)
                                        for s, e, _, _ in spans[name]),
                      1e3 * statistics.median(h for _, _, h, _ in
                                              spans[name]),
                      len(spans[name]))
               for name, _, _ in replicas}
    print(f"serve {label}: {len(finished)} requests, {st['prompt_tokens']} "
          f"prompt + {st['generated_tokens']} generated tokens in {dt:.3f} "
          f"s = {total / dt:.1f} tok/s ({st['generated_tokens'] / dt:.1f} "
          "generated tok/s); " + "; ".join(
              f"{name + ': ' if name else ''}{n} decode steps, median "
              f"{d:.2f} ms on the device stream, {h:.2f} ms to enqueue"
              for name, (d, h, n) in step_ms.items())
          + f"; launches {launches}, per decode step {per_step}; peak "
          f"{serve_peak:.2f} GiB on the card while serving", flush=True)
    tiers = None
    if policy_name == "fleet":
        tiers = dict(placed=st["tier_placed"], degraded=st["tier_degraded"],
                     per_replica=[dict(
                         tier=pe["tier"], requests=pe["dispatched"],
                         generated_tok_s=pe["generated_tokens"] / dt)
                         for pe in st["per_engine"]])
        stamped = {}
        for o in finished:
            stamped[o.tier] = stamped.get(o.tier, 0) + 1
        if stamped != st["tier_placed"] or set(stamped) != set(FLEET):
            fail(f"serve {label}: tiers stamped {stamped}, placed "
                 f"{st['tier_placed']}")
        print(f"serve {label} tiers: placed {st['tier_placed']} "
              f"({st['tier_degraded']} degraded under pressure); " + "; ".join(
                  f"{r['tier']} replica {r['requests']} requests, "
                  f"{r['generated_tok_s']:.1f} generated tok/s"
                  for r in tiers["per_replica"]), flush=True)

    # rerun: the same tokens; a middle decode step of each replica synced
    # on both sides and traced, so each trace holds that step's kernels and
    # nothing else. The profiler now and then loses a kernel record: a
    # trace whose records disagree with the counters is reported and the
    # next step traced, up to TRACE_TRIES steps
    traces = {}

    def traced_decode(name, target):
        decode, calls = decodes[name], []

        def run(*a, **kw):
            calls.append(None)
            done = traces.setdefault(name, [])
            if (len(calls) - 1 < target or len(done) >= TRACE_TRIES
                    or (done and done[-1]["ok"])):
                return decode(*a, **kw)
            torch.cuda.synchronize()
            act = [torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=act) as prof:
                c0 = counts()
                h0 = time.perf_counter()
                out = decode(*a, **kw)
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - h0)
                c1 = counts()
            rec = device_records(prof)
            counted = tuple(b - a for a, b in zip(c0, c1))[:len(path)]
            kern = {k: matching(rec, RECORDS[k]) for k in path}
            done.append(dict(wall_ms=wall_ms, counted=counted, records=rec,
                             kern=kern, step=(len(calls) - 1,
                                              len(spans[name])),
                             gemm_us=[round(e.time_range.elapsed_us(), 1)
                                      for e in prof.events()
                                      if "fxp_gemm" in e.name],
                             ok=tuple(c for c, _ in kern.values())
                             == counted))
            return out
        return run
    for name, ex, _ in replicas:
        ex.decode_and_sample = traced_decode(name, len(spans[name]) // 2)
    again, _, dt2 = serve_tokens(engine, make_requests(
        cfg, 8, prompt_len, gen_tokens, mixed=True, seed=0))
    for name, ex, _ in replicas:
        ex.decode_and_sample = decodes[name]
    if again != toks:
        fail(f"serve {label}: rerun of the same workload gave other tokens")
    print(f"serve {label} rerun: identical tokens ({dt2:.3f} s); first "
          f"request {toks[0]}", flush=True)

    traced = {}
    for name, tries in traces.items():
        for t in tries:
            if not t["ok"]:
                print(f"traced decode step of {label} {name} (rerun step "
                      f"{t['step'][0]}): the profiler holds kernel records "
                      f"{ {k: c for k, (c, _) in t['kern'].items()} } (the "
                      f"GEMM's device us in order {t['gemm_us']}), the "
                      f"counters say {t['counted']}; tracing the next step",
                      flush=True)
        trace = tries[-1] if tries else None
        if trace is None:
            fail(f"serve {label} {name}: no decode step traced")
        graph = None
        if not trace["ok"]:
            # the profiler lost records of every traced step: count the
            # step's launches as kernel nodes of a captured CUDA graph
            ex, pol = next((e, p) for n, e, p in replicas if n == name)
            graph = graph_kernel_counts(cfg, ex, pol)
            want_step = tuple(expect[name][k] for k in path)
            if graph != trace["counted"] or graph != want_step:
                fail(f"traced decode step of {label} {name}: the profiler's "
                     f"records disagree with the counters {trace['counted']} "
                     f"in {TRACE_TRIES} steps, and a captured step holds "
                     f"kernel nodes {graph}, the model needs {want_step}")
            lost = {k: trace["counted"][i] - trace["kern"][k][0]
                    for i, k in enumerate(path)
                    if trace["counted"][i] != trace["kern"][k][0]}
            print(f"traced decode step of {label} {name}: the profiler lost "
                  f"records {lost} of every traced step; a decode step "
                  f"captured in a CUDA graph holds kernel nodes "
                  f"{dict(zip(path, graph))}, the counters' and the model's "
                  "count; the device ms below miss the lost records",
                  flush=True)
        rec, kern = trace["records"], trace["kern"]
        n_all, all_ms = matching(rec, None)
        kern_ms = sum(ms for _, ms in kern.values())
        idle = 1.0 - all_ms / trace["wall_ms"]
        target, n_decode = trace["step"]
        print(f"traced decode step of {label}{' ' + name if name else ''} "
              f"(rerun step {target} of {n_decode}, synced, under the "
              f"profiler): {trace['wall_ms']:.3f} ms wall; device time "
              f"{all_ms:.3f} ms in {n_all} records = " + " + ".join(
                  f"{c} {k} {ms:.3f} ms" for k, (c, ms) in kern.items())
              + f" + {n_all - sum(c for c, _ in kern.values())} other "
              f"{all_ms - kern_ms:.3f} ms; device idle {100 * idle:.1f}% of "
              "the step", flush=True)
        top = sorted(rec.items(), key=lambda kv: -kv[1][1])[:8]
        print(f"traced decode step of {label}{' ' + name if name else ''}, "
              "largest device records: " + "; ".join(
                  f"{k[:60]} x{c} {ms:.3f} ms" for k, (c, ms) in top),
              flush=True)
        traced[name or "engine"] = dict(
            wall_ms=trace["wall_ms"], device_ms=all_ms, idle_share=idle,
            records=n_all, graph_kernel_nodes=graph, kernels={k: dict(launches=c, ms=ms)
                                    for k, (c, ms) in kern.items()})
    if len(traces) != len(replicas):
        fail(f"serve {label}: traced {sorted(traces)} of the replicas")
    extra = after(cfg, engine) if after is not None else None
    return launches, extra, dict(
        arch=arch, policy=policy_name, layers=cfg.n_layers, setup_s=setup_s,
        gib_on_card=torch.cuda.memory_allocated() / gib,
        setup_peak_gib=setup_peak, serve_peak_gib=serve_peak,
        tok_s=total / dt, generated_tok_s=st["generated_tokens"] / dt,
        seconds=dt, tiers=tiers,
        decode_ms={name or "engine": d for name, (d, _, _) in
                   step_ms.items()},
        enqueue_ms={name or "engine": h for name, (_, h, _) in
                    step_ms.items()},
        launches_per_decode_step={name or "engine": v
                                  for name, v in per_step.items()},
        traced_step=traced)


def spec_phase(dev):
    """The full-width speculative path: one `TieredWeights` bank {fxp4,
    bf16} of Qwen2.5-14B from seed 0 and two fleets over it, 4 slots per
    engine, paged KV of block 16 (int8 for fxp4, bf16 for bf16), prefill
    chunk 16: a plain fxp4+bf16 fleet, then the speculative fleet
    (`spec_decode="fxp4:bf16"`, k 4: the bf16 replica a coordinator whose
    draft is the bank's fxp4 view), each serving the serve workload pinned
    half to each tier, audited after every round (gate c). Gates: every
    request equal between the fleets (b, `spec_against_plain`), the
    launches of every dispatch of each kind (d), both kernels of the path
    launched in the speculative run, its tokens equal on a rerun. The
    rerun traces one speculative round, then one verify dispatch and one
    draft decode. -> (launches of the speculative run, summary)."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import tier_policy
    from repro_torch.core.qtensor import TieredWeights
    from repro_torch.launch.serve import (KERNELS, gemm_mode_counts,
                                          launch_counts, reset_launch_counts)
    from repro_torch.models import model as M
    from repro_torch.serving import EngineRouter
    cfg = get_config("qwen2_5_14b")
    label = "qwen2_5_14b spec"
    gib = 2 ** 30
    prompt_len, gen_tokens = 64, 16
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bank = TieredWeights(M.init_params(cfg, 0, device=dev), SPEC_TIERS,
                         consume=True)
    kw = dict(max_slots=SLOTS, max_len=prompt_len + gen_tokens,
              prefill_chunk=16, kv_block_size=16, seed=0, device=dev,
              routing="tiered", backend="kernels")
    spec = EngineRouter(cfg, bank, tiers=list(SPEC_TIERS), spec_decode=SPEC,
                        spec_k=SPEC_K, **kw)
    plain = EngineRouter(cfg, bank, tiers=list(SPEC_TIERS), **kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    on_card = torch.cuda.memory_allocated() / gib
    setup_peak = torch.cuda.max_memory_allocated() / gib
    per_tier = bank.bytes_by_tier()
    print(f"serve setup: full-width {label}, {cfg.n_layers} layers, one bank "
          f"{', '.join(f'{t} {per_tier[t] / gib:.2f} GiB' for t in SPEC_TIERS)}"
          f" (the bf16 source kept whole), a speculative fleet {SPEC} k="
          f"{SPEC_K} and a plain fleet over it in {setup_s:.1f} s, "
          f"{on_card:.2f} GiB on the card, peak {setup_peak:.2f} GiB while "
          "building", flush=True)

    path = list(KERNELS)
    mode_names = list(gemm_mode_counts())
    pols = {t: tier_policy(t, "kernels") for t in SPEC_TIERS}

    def counts():
        c, m = launch_counts(), gemm_mode_counts()
        return (tuple(c[k] for k in path) + tuple(m[k] for k in mode_names))

    def want(tier, chunk):
        # a [B, k+1] dispatch attends over the gathered view in plain
        # PyTorch, as chunked prefill does: no attention kernel
        d = launches_per_decode_step(cfg, pols[tier])
        if chunk:
            d["paged_attention_float"] = 0
        m = modes_per_decode_step(cfg, pols[tier])
        return tuple(d[k] for k in path) + tuple(m[k] for k in mode_names)

    co = spec.engines[SPEC_TIERS.index("bf16")]
    sites = {"fxp4 replica decode": (spec.engines[0].ex, "decode_and_sample",
                                     want("fxp4", False)),
             "draft decode": (co.draft.ex, "decode_and_sample",
                              want("fxp4", False)),
             "draft ingest": (co.draft.ex, "verify", want("fxp4", True)),
             "bf16 verify": (co.verify.ex, "verify", want("bf16", True)),
             "plain fxp4 decode": (plain.engines[0].ex, "decode_and_sample",
                                   want("fxp4", False)),
             "plain bf16 decode": (plain.engines[1].ex, "decode_and_sample",
                                   want("bf16", False))}
    spans = {name: [] for name in sites}
    originals = {name: getattr(ex, meth)
                 for name, (ex, meth, _) in sites.items()}

    def spanned(name):
        fn = originals[name]

        def run(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            c0 = counts()
            h0 = time.perf_counter()
            s.record()
            out = fn(*a, **k)
            e.record()
            spans[name].append((s, e, time.perf_counter() - h0,
                                tuple(b - a for a, b in zip(c0, counts()))))
            return out
        return run
    for name, (ex, meth, _) in sites.items():
        setattr(ex, meth, spanned(name))

    plain_outs, plain_dt = drive_audited(plain, spec_requests(cfg,
                                                              prompt_len))
    reset_launch_counts()
    spec_outs, spec_dt = drive_audited(spec, spec_requests(cfg, prompt_len))
    launches = dict(launch_counts())
    launches.update({f"fxp_gemm_fused:{m}": n
                     for m, n in gemm_mode_counts().items()})
    serve_peak = torch.cuda.max_memory_allocated() / gib
    for outs in (plain_outs, spec_outs):
        if len(outs) != 8 or any(len(o.tokens) != gen_tokens or not all(
                0 <= t < cfg.vocab for t in o.tokens) for o in outs):
            fail(f"serve {label}: {[(o.id, o.tokens) for o in outs]}")
    for k in ("fxp_gemm_fused", "fxp_gemm_fused:packed",
              "paged_attention_float"):
        if launches[k] == 0:
            fail(f"serve {label}: kernel {k} was never launched")
    per_dispatch = {}
    for name, (_, _, w) in sites.items():
        seen = sorted({c for _, _, _, c in spans[name]})
        if seen != [w]:
            fail(f"serve {label}: launches per {name} {seen} of "
                 f"{path + mode_names}, the model needs {w}")
        per_dispatch[name] = dict(zip(path + mode_names, w))
    diverged = spec_against_plain(f"serve {label}", cfg, bank, spec_outs,
                                  plain_outs, dev)
    st = spec.stats()
    pst = plain.stats()
    timing = {name: dict(
        n=len(v), device_stream_ms=statistics.median(
            s.elapsed_time(e) for s, e, _, _ in v),
        enqueue_ms=1e3 * statistics.median(h for _, _, h, _ in v))
        for name, v in spans.items()}
    tok_s = {"spec": st["generated_tokens"] / spec_dt,
             "plain": pst["generated_tokens"] / plain_dt}
    per_verify = co.generated_tokens / max(co.spec_verify_steps, 1)
    print(f"serve {label}: plain fleet {plain_dt:.3f} s = {tok_s['plain']:.2f}"
          f" generated tok/s, speculative fleet {spec_dt:.3f} s = "
          f"{tok_s['spec']:.2f} generated tok/s (plain first, one call); "
          f"acceptance {st['spec_accepted']}/{st['spec_proposed']} = "
          f"{st['spec_acceptance_rate']:.3f}, {st['spec_verify_steps']} "
          f"verify steps, {per_verify:.3f} tokens per verify step on the "
          "bf16 replica, "
          f"{st['spec_rolled_back']} tokens rolled back; dispatches "
          + "; ".join(f"{n}: {t['n']}, median {t['device_stream_ms']:.2f} ms "
                      f"on the device stream, {t['enqueue_ms']:.2f} ms to "
                      "enqueue" for n, t in timing.items())
          + f"; launches {launches}; per dispatch {per_dispatch}; peak "
          f"{serve_peak:.2f} GiB while serving", flush=True)

    # rerun of the speculative fleet: the same tokens; one middle round
    # traced (synced, under the profiler), then one verify dispatch and one
    # draft decode, each alone
    target = co.spec_verify_steps * 3 // 2    # a middle round of the rerun
    traced = {}
    round_fn = co._spec_round

    def profiled(key, fn, *a, **k):
        torch.cuda.synchronize()
        act = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=act) as prof:
            h0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - h0)
        rec = device_records(prof)
        n_all, dev_ms = matching(rec, None)
        traced[key] = dict(wall_ms=wall, records=n_all, device_ms=dev_ms,
                           idle_share=1.0 - dev_ms / wall,
                           kernels={k: matching(rec, RECORDS[k])
                                    for k in path},
                           top=sorted(rec.items(),
                                      key=lambda kv: -kv[1][1])[:6])
        return out

    def traced_round(events):
        if "round" in traced or co.spec_verify_steps < target:
            return round_fn(events)
        before = co.spec_verify_steps
        out = profiled("round", round_fn, events)
        if co.spec_verify_steps == before:       # no slot was ready
            del traced["round"]
        return out
    co._spec_round = traced_round
    for key, name in (("verify dispatch", "bf16 verify"),
                      ("draft decode", "draft decode")):
        ex, meth, _ = sites[name]

        def one(*a, _key=key, _fn=getattr(ex, meth), **k):
            if "round" not in traced or _key in traced:
                return _fn(*a, **k)
            return profiled(_key, _fn, *a, **k)
        setattr(ex, meth, one)
    again, _ = drive_audited(spec, spec_requests(cfg, prompt_len))
    co._spec_round = round_fn
    for name, (ex, meth, _) in sites.items():
        setattr(ex, meth, originals[name])
    if [o.tokens for o in again] != [o.tokens for o in spec_outs]:
        fail(f"serve {label}: rerun of the same workload gave other tokens")
    counted = {"verify dispatch": per_dispatch["bf16 verify"],
               "draft decode": per_dispatch["draft decode"]}
    for key in ("round", "verify dispatch", "draft decode"):
        if key not in traced:
            fail(f"serve {label}: no {key} traced")
        t = traced[key]
        kern = " + ".join(f"{c} {k} {ms:.3f} ms"
                          for k, (c, ms) in t["kernels"].items() if c)
        # the profiler now and then loses a record (serve_phase); the
        # counters hold each dispatch's launches
        held = ("" if key not in counted else "; the counters: " + (
            ", ".join(f"{counted[key][k]} {k}" for k in path
                      if counted[key][k]) or "none"))
        print(f"traced {key} of {label} (rerun, synced, under the profiler): "
              f"{t['wall_ms']:.3f} ms wall; device time {t['device_ms']:.3f} "
              f"ms in {t['records']} records, of the port's kernels "
              f"{kern or 'none'}{held}; device idle "
              f"{100 * t['idle_share']:.1f}%; largest records: " + "; ".join(
                  f"{k[:50]} x{c} {ms:.3f} ms" for k, (c, ms) in t["top"]),
              flush=True)
    summary = dict(
        arch=cfg.name, policy="spec", layers=cfg.n_layers, setup_s=setup_s,
        gib_on_card=on_card, setup_peak_gib=setup_peak,
        serve_peak_gib=serve_peak,
        bank_gib={t: per_tier[t] / gib for t in SPEC_TIERS},
        generated_tok_s=tok_s, seconds={"spec": spec_dt, "plain": plain_dt},
        spec={c: st[c] for c in SPEC_COUNTERS + ("spec_acceptance_rate",)},
        tokens_per_verify_step=per_verify,
        diverged=diverged, dispatch_timing=timing,
        launches_per_dispatch=per_dispatch,
        traced={k: {x: v for x, v in t.items() if x != "top"}
                for k, t in traced.items()})
    return launches, summary


PREFIX_TOKENS = 48             # the prefix phase's system prompt: 3 blocks
PREFIX_WAVES = (24, 24, 24, 24, 8, 13, 19, 24)   # tails, in admission order


def prefix_phase(dev, cfg, engine):
    """Prefix caching on the full-width path `engine` serves (its weights
    and policy reused): 8 greedy requests of 16 tokens sharing a 48-token
    system prompt (three blocks of 16), with tails of 8-24 tokens of their
    own, paged int8 KV (block 16), 4 slots, prefill chunk 16. Run cold
    (paged, no prefix cache, overlap loop), then with the prefix cache
    under the sync and the overlap loops: the same tokens in all three,
    prompt tokens reused, fewer prompt tokens computed than admitted.

    Under FxP8 the activation scale of a decode step is one per tensor
    over every slot, so a request's tokens depend on which requests share
    its decode steps, and prefix caching moves when a request starts to
    decode (it skips the matched prefill chunks). The gated traffic is
    two waves that keep each decode step's rows the same with and without
    the cache: four requests with equal tails (they prefill, decode and
    finish together, and fill the cache), then four with mixed tails,
    admitted together once the first wave has left. The same 8 requests
    in one mixed stream (tails drawn from 8-24) are also run cold and
    warm; how many requests' tokens differ there is reported, not gated.
    -> the figures of every run."""
    from repro_torch.launch.serve import serve
    from repro_torch.serving import Request, ServingEngine
    gen_tokens = 16

    def requests(tails, seed):
        g = torch.Generator().manual_seed(seed)
        system = torch.randint(0, cfg.vocab, (PREFIX_TOKENS,),
                               generator=g).tolist()
        return [Request(prompt=system + torch.randint(
            0, cfg.vocab, (n,), generator=g).tolist(),
            max_new_tokens=gen_tokens, id=i) for i, n in enumerate(tails)]

    def run(reqs, prefix_cache, overlap):
        eng = ServingEngine(cfg, engine.params, policy=engine.policy, seed=0,
                            device=dev, max_slots=SLOTS,
                            max_len=PREFIX_TOKENS + 24 + gen_tokens,
                            prefill_chunk=16, kv_block_size=16,
                            prefix_cache=prefix_cache, overlap=overlap)
        calls = {"prefill": 0, "decode_and_sample": 0}
        for attr in calls:
            def counted(*a, _fn=getattr(eng.ex, attr), _attr=attr, **kw):
                calls[_attr] += 1
                return _fn(*a, **kw)
            setattr(eng.ex, attr, counted)
        finished, dt = serve(eng, reqs)
        eng.check_invariants()
        st = eng.stats()
        if len(finished) != len(reqs) or any(
                len(o.tokens) != gen_tokens for o in finished):
            fail(f"prefix phase: {len(finished)} of {len(reqs)} requests "
                 "finished with their tokens")
        late = [o.ttft_s for o in finished if o.id >= SLOTS]
        return [o.tokens for o in finished], dict(
            seconds=dt, ticks=st["ticks"], prefill_chunks=calls["prefill"],
            decode_steps=calls["decode_and_sample"],
            prompt_tokens=st["prompt_tokens"],
            prefill_tokens_computed=st["prefill_tokens_computed"],
            prefix_tokens_reused=st["prefix_tokens_reused"],
            block_hits=st.get("prefix_cache", {}).get("hits", 0),
            cow_copies=st.get("cow_copies", 0),
            generated_tok_s=st["generated_tokens"] / dt,
            second_wave_ttft_s=statistics.mean(late))

    waves = {}
    toks = {}
    for name, cache, overlap in (("cold", False, True),
                                 ("warm sync", True, False),
                                 ("warm overlap", True, True)):
        toks[name], waves[name] = run(requests(PREFIX_WAVES, 1), cache,
                                      overlap)
        print(f"prefix phase, two waves, {name}: {waves[name]}", flush=True)
    if not toks["cold"] == toks["warm sync"] == toks["warm overlap"]:
        fail("prefix phase: the prefix-cached runs' tokens differ from the "
             "cold run's")
    for name in ("warm sync", "warm overlap"):
        w = waves[name]
        if not (w["prefix_tokens_reused"] > 0
                and w["prefill_tokens_computed"] < w["prompt_tokens"]):
            fail(f"prefix phase {name}: reused {w['prefix_tokens_reused']} "
                 f"prompt tokens, computed {w['prefill_tokens_computed']} of "
                 f"{w['prompt_tokens']}")
    g = torch.Generator().manual_seed(2)
    tails = torch.randint(8, 25, (8,), generator=g).tolist()
    mixed, mixed_toks = {}, {}
    for name, cache in (("cold", False), ("warm overlap", True)):
        mixed_toks[name], mixed[name] = run(requests(tails, 3), cache, True)
    differ = sum(a != b for a, b in zip(mixed_toks["cold"],
                                        mixed_toks["warm overlap"]))
    if mixed["warm overlap"]["prefix_tokens_reused"] == 0:
        fail("prefix phase, one mixed stream: no prompt tokens reused")
    print(f"prefix phase, two waves: cold == warm sync == warm overlap, "
          f"{sum(map(len, toks['cold']))} greedy tokens; reused "
          f"{waves['warm overlap']['prefix_tokens_reused']} of "
          f"{waves['warm overlap']['prompt_tokens']} prompt tokens, "
          f"{waves['warm overlap']['block_hits']} block hits, "
          f"{waves['warm overlap']['cow_copies']} CoW forks, prefill chunks "
          f"{waves['cold']['prefill_chunks']} -> "
          f"{waves['warm overlap']['prefill_chunks']}; one mixed stream "
          f"(tails {tails}): {differ} of 8 requests' tokens differ cold vs "
          f"warm (not gated), reused "
          f"{mixed['warm overlap']['prefix_tokens_reused']}", flush=True)
    return dict(arch=cfg.name, system_prompt=PREFIX_TOKENS,
                wave_tails=list(PREFIX_WAVES), waves=waves, mixed_tails=tails,
                mixed=mixed, mixed_requests_differing=differ)


def kernel_entry(name, source, replaces, row, launches, path=None,
                 counter=None, **extra):
    """One kernel's line: `launches` counted over the serve run of `path`
    (architecture/policy) on the wrapper's counter `counter` (default:
    `name`); None for a kernel no serving path runs. `held` of `iters`:
    the kernel records the last profiler window of `ms` held (fewer than
    `iters`: `ms` is the CUDA-event time)."""
    counter = counter or name
    return dict({"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": launches[path].get(counter, 0) if path else 0,
                 "max_abs_err": row["max_abs_err"],
                 "ms": row["ms"], "plain_ms": row["plain_ms"],
                 "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                 "library_ms": row.get("library_ms"),
                 "timing": TIMING["source"], "held": row["held"],
                 "iters": row["iters"], "path": path,
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
    gemm_rows = gemm_phase(dev, gen)
    wide_rows = wide_gemm_phase(dev,
                                torch.Generator(device=dev).manual_seed(8))
    x32_rows = x32_gemm_phase(dev,
                              torch.Generator(device=dev).manual_seed(10))
    packed_bank = packed_batched_gemm_phase(
        dev, torch.Generator(device=dev).manual_seed(9))
    packed_rows = gemm_phase(dev, torch.Generator(device=dev).manual_seed(5),
                             packed=True)
    code_rows = code_gemm_phase(dev, torch.Generator(device=dev).manual_seed(6))
    bank = batched_gemm_phase(dev, torch.Generator(device=dev).manual_seed(2))
    attn, mha_rows = attention_phase(
        dev, torch.Generator(device=dev).manual_seed(1))
    attn_int = attention_int_phase(
        dev, torch.Generator(device=dev).manual_seed(7))
    ssm_gemm_rows = gemm_phase(
        dev, torch.Generator(device=dev).manual_seed(11),
        shapes=SSM_GEMM_SHAPES, label="fxp_gemm_fused (SSM/hybrid paths)")
    empty_ms = empty_launch_ms()
    af_rows = cordic_af_phase(dev, torch.Generator(device=dev).manual_seed(3))
    gate_rows = cordic_gate_phase(
        dev, torch.Generator(device=dev).manual_seed(12))
    sm_rows = cordic_softmax_phase(
        dev, torch.Generator(device=dev).manual_seed(4))
    check_quantize_phase(dev)
    for arch, policy_name in PATHS:
        if policy_name not in ("fleet", "spec"):
            check_phase(dev, arch, policy_name)
    check_fleet_phase(dev)
    check_spec_phase(dev)
    launches, summaries, prefix = {}, [], None
    for arch, policy_name in PATHS:
        key = f"{arch}/{policy_name}"
        if policy_name == "spec":
            launches[key], summary = spec_phase(dev)
        else:
            after = (functools.partial(prefix_phase, dev)
                     if (arch, policy_name) == ("qwen2_5_14b", "fxp8")
                     else None)
            launches[key], extra, summary = serve_phase(dev, arch,
                                                        policy_name, after)
            prefix = extra if extra is not None else prefix
        summaries.append(summary)
        gc.collect()                 # the engine and its weights go here
        torch.cuda.empty_cache()

    w1 = next(r for r in gemm_rows if r["af"] == "silu")
    pw1 = next(r for r in packed_rows if r["af"] == "silu")
    ww1 = next(r for r in wide_rows if r["af"] == "silu")
    xw1 = next(r for r in x32_rows if r["af"] == "silu" and r["bits"] == 32)
    gemm_src = "src/repro_torch/csrc/fxp_gemm.cu"
    gemm_ref = "src/repro/kernels/fxp_gemm/fxp_gemm.py"
    attn_src = "src/repro_torch/csrc/paged_attention.cu"
    attn_ref = "src/repro/kernels/paged_attention/paged_attention.py"
    kernels = [
        kernel_entry("fxp_gemm_fused", gemm_src, f"{gemm_ref}:158", w1,
                     launches, "qwen2_5_14b/fxp8",
                     counter="fxp_gemm_fused:int8", call_ms=w1["call_ms"],
                     shape=f"M={w1['m']} K={w1['k']} N={w1['n']} +silu "
                           "(Qwen2.5-14B w1), int8 codes",
                     ssm_hybrid_shapes=ssm_gemm_rows),
        kernel_entry("fxp_gemm_fused_batched", gemm_src, f"{gemm_ref}:158",
                     bank, launches, "deepseek_moe_16b/fxp8",
                     counter="fxp_gemm_fused:batched",
                     shape=bank["shape"] + ", int8 codes x int8 banks "
                           "(fxp_gemm_fused_pallas per expert, "
                           "src/repro/kernels/dispatch.py:309)"),
        kernel_entry("fxp_gemm_fused_packed", gemm_src, f"{gemm_ref}:158",
                     pw1, launches, "qwen2_5_14b/edge4",
                     counter="fxp_gemm_fused:packed", call_ms=pw1["call_ms"],
                     shape=f"M={pw1['m']} K={pw1['k']} N={pw1['n']} +silu "
                           "(Qwen2.5-14B w1), FxP4 codes x packed nibbles "
                           f"(fxp_gemm_fused_pallas packed=True; "
                           f"_unpack_nibbles {gemm_ref}:51)"),
        kernel_entry("fxp_gemm_fused_wide", gemm_src, f"{gemm_ref}:158",
                     ww1, launches, "qwen2_5_14b/fleet",
                     counter="fxp_gemm_fused:wide",
                     shape=f"M={ww1['m']} K={ww1['k']} N={ww1['n']} +silu "
                           "(Qwen2.5-14B w1), FxP16 codes in int16 (the "
                           "fxp16 replica; fxp_gemm_fused_pallas on >8-bit "
                           "codes)"),
        kernel_entry("fxp_gemm_fused_x32", gemm_src, f"{gemm_ref}:158",
                     xw1, launches, "qwen2_5_14b/fxp32",
                     counter="fxp_gemm_fused:x32", call_ms=xw1["call_ms"],
                     shape=f"M={xw1['m']} K={xw1['k']} N={xw1['n']} +silu "
                           "(Qwen2.5-14B w1), FxP32 codes in int32 (the "
                           "fxp32 path; fxp_gemm_fused_pallas on int32 "
                           f"codes, its f32 accumulator {gemm_ref}:193)"),
        kernel_entry("fxp_gemm_fused_batched_packed", gemm_src,
                     f"{gemm_ref}:158", packed_bank, launches,
                     "deepseek_moe_16b/edge4",
                     counter="fxp_gemm_fused:batched_packed",
                     shape=packed_bank["shape"] + ", FxP4 codes x packed "
                           "nibble banks (fxp_gemm_fused_pallas packed=True "
                           "per expert, src/repro/kernels/dispatch.py:309)"),
        kernel_entry("paged_attention_float", attn_src, f"{attn_ref}:172",
                     attn, launches, "deepseek_moe_16b/fxp8",
                     cluster=attn["cluster"],
                     shape="B=4 KV=8 g=5 hd=128 bs=16, 1024-2000 cached "
                           "tokens, int8 pool, CORDIC softmax",
                     zamba2_shapes=mha_rows),
        kernel_entry("paged_attention_int", attn_src, f"{attn_ref}:208",
                     attn_int, launches, "qwen2_5_14b/int-attention",
                     cluster=attn_int["cluster"],
                     shape="B=4 KV=8 g=5 hd=128 bs=16, 1024-2000 cached "
                           "tokens, int8 pool, exact softmax"),
        kernel_entry("cordic_af", "src/repro_torch/csrc/cordic_af.cu",
                     "src/repro/kernels/cordic_af/cordic_af.py:89",
                     af_rows[0], launches, "deepseek_moe_16b/fxp8",
                     op_ms=af_rows[0]["op_ms"],
                     shape="silu bf16 fxp8 [1, 64, 4, 1408] (expert "
                           "activations at decode), the whole op in one "
                           "launch",
                     gate_shapes=gate_rows),
        kernel_entry("cordic_softmax", "src/repro_torch/csrc/cordic_softmax.cu",
                     "src/repro/kernels/cordic_softmax/cordic_softmax.py:33",
                     sm_rows[0], launches, "deepseek_moe_16b/fxp8",
                     op_ms=sm_rows[0]["op_ms"], empty_launch_ms=empty_ms,
                     shape="f32 fxp8 [4, 64], lv 12 (router at decode), the "
                           "whole op in one launch"),
        kernel_entry("fxp_gemm_codes", gemm_src, f"{gemm_ref}:111",
                     code_rows["fxp_gemm_codes"], launches,
                     shape=code_rows["fxp_gemm_codes"]["shape"],
                     call_device_ms=code_rows["fxp_gemm_codes"][
                         "call_device_ms"], on_path=False),
        kernel_entry("fxp_gemm_codes_int16", gemm_src, f"{gemm_ref}:111",
                     code_rows["fxp_gemm_codes_int16"], launches,
                     shape=code_rows["fxp_gemm_codes_int16"]["shape"],
                     call_device_ms=code_rows["fxp_gemm_codes_int16"][
                         "call_device_ms"], on_path=False),
        kernel_entry("fxp_gemm_codes_int32", gemm_src, f"{gemm_ref}:111",
                     code_rows["fxp_gemm_codes_int32"], launches,
                     shape=code_rows["fxp_gemm_codes_int32"]["shape"],
                     call_device_ms=code_rows["fxp_gemm_codes_int32"][
                         "call_device_ms"], on_path=False),
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
    print(f"prefix summary: {json.dumps(prefix)}", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
