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
                FxP32 (and, at w1, FxP24) codes in int32 (the x32 mode on
                the CUDA cores, beside torch.matmul of the codes in f32,
                also at codes at the ends of int32), and,
                batched over 64 experts, at the MoE banks, int8 and packed
                FxP4; every GEMM window holds a record of its kernel for
                each call; the raw code GEMMs
                (bit-equal, all on the tensor cores: int8 beside
                torch._int_mm, int16, packed FxP4); both attentions (a
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
  4. check    — the FxP32 quantize on the card (it saturates to the
                reference's codes); reduced Qwen2.5-14B (under FxP8,
                edge4, integer attention and FxP32) and reduced
                DeepSeekMoE-16B (FxP8 and edge4),
                each served through the kernels and through the plain path
                on the card: the same greedy tokens; the reduced fleet of
                an fxp8 and an fxp16 replica over one TieredWeights bank:
                the same tiers and tokens on both paths, and with every
                request pinned to one tier, the tokens of a single engine
                of that tier over the same bank;
  5. serve    — seven paths, each at full width from seed 0: Qwen2.5-14B
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
                reference's are); each with paged int8 KV (block
                16), 4 slots (per replica), 8 mixed requests (prompts
                40-64), 16 greedy tokens each, prefill chunk 16, overlap
                loop; the launches of every kernel, and of each GEMM mode,
                counted over each serve run (set to 0 just before it) and
                per decode step (of each replica) against the model's
                count, tokens identical on a rerun, one decode step of
                each replica of the rerun traced with the profiler (kernel
                device time and the device's idle share), memory on the
                card and its peak.
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
FLEET = ("fxp8", "fxp16")      # the tiered fleet's replicas
TRACE_TRIES = 3                # decode steps traced at most per replica


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


def device_ms(fn, iters: int, match: str | None = None, tries: int = 3):
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


def gemm_phase(dev, gen, packed=False):
    """The fused GEMM at the full-width models' shapes, on int8 codes or
    (`packed`) on FxP4 codes with nibble-packed weights [K, N/2] bytes,
    whose bytes bound counts half the int8 weight bytes: bit-equal to the
    plain version, with the AF too. Each time counts the tensor-core
    core's records, and each window must hold one per call."""
    from repro_torch.kernels.fxp_gemm.fxp_gemm import (
        fxp_gemm_fused, fxp_gemm_fused_plain)
    # (M, K, N, af): Qwen2.5-14B's, then DeepSeekMoE-16B's dense GEMMs
    shapes = [(SLOTS, 5120, 5120, None),       # wq, wo
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
    qa = 7 if packed else 127
    label = "fxp_gemm_fused packed FxP4" if packed else "fxp_gemm_fused"
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
    FxP4 weights, and FxP12 codes in int16 at K 512 (inside the bound
    K * qmax^2 < 2^31 the caller owns); each bit-equal to its plain
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
              codes((512, n), 2047, torch.int16), "fxp_gemm_tc_kernel")]
    rows = {}
    for name, what, fn, plain, x, w, record in cases:
        got, ref = fn(x, w), plain(x, w)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"{name} ({what}): not bit-equal to plain")
        win = {}
        ms = timed(lambda: fn(x, w), 20, record, win)
        held_all(f"{name} ({what})", win)
        call_ms = timed(lambda: fn(x, w), 20)
        pms = timed(lambda: plain(x, w), 3)
        kk = x.shape[1]
        nbytes = x.numel() * x.element_size() + w.numel() * w.element_size()
        nbytes += 4 * m * n
        if x.dtype == torch.int8:
            bms, by = bound_ms(nbytes, 2.0 * m * kk * n, INT8_OPS_PER_S)
        else:           # no published int16 rate: the bytes bound alone
            bms, by = bound_ms(nbytes, 0.0, INT8_OPS_PER_S)
        lib_ms, lib_note = None, "none"
        if name == "fxp_gemm_codes":
            lib_ms, lib_note = library_int_mm(x, w, ref)
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


def x32_gemm_phase(dev, gen):
    """The fused GEMM's x32 mode (csrc/fxp_gemm.cu, x32: int32 codes on
    the CUDA cores, the exact sum in 128 bits rounded once to f32) at the
    full-width Qwen2.5-14B's shapes on FxP32 codes (the fxp32 path), and
    w1 + SiLU on FxP24 codes too, each bit-equal to its plain version,
    beside torch.matmul of the same codes already cast to f32 (TF32 off;
    it rounds every code past 2^24 and every partial sum: a yardstick, not
    the same function). The bound counts the int32 operand bytes and the
    2 M K N products at the f32 rate outside the tensor cores (the table
    has no int32 rate). Each window must hold one x32 record a call. Then
    codes at the ends of int32 at w2's shape (sums of K * 2^62, past
    2^64): bit-equal too."""
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
        ms = timed(run, 20, "fxp_gemm_x32_kernel", win)
        held_all(what, win, "fxp_gemm_x32_kernel")
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
    ms = timed(lambda: fxp_gemm_fused(x, w, scale), 20, "fxp_gemm_x32_kernel")
    print(f"kernel fxp_gemm_fused x32 at codes +-(2^31 - 1) and -2^31 M={m} "
          f"K={k} N={n}: {ms:.4f} ms on the device, sums up to "
          f"{float(k) * 2.0 ** 62:.3e}, bit-equal with and without silu",
          flush=True)
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
                           mb=None, holes=(), empty=()):
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
    hd, bs = 128, 16
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
    1024-2000 tokens; each line names the cluster size the wrapper
    picked. Also times scaled_dot_product_attention on the 1024-2000
    rows, gathered and dequantized beforehand, as a yardstick that does
    less work (no paged gather, no dequant, no mask)."""
    from repro_torch.core.activation import softmax_lv_stages
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.paged_attention import (
        gather_pool_view, paged_attention_float, paged_attention_float_plain)
    result = None
    runs = [(True, name, 8, 5) for name in ATTN_CASES]
    runs.insert(1, (False, "1024-2000 tokens", 8, 5))
    runs.insert(2, (True, "1024-2000 tokens", 16, 1))
    for quant, case, kvh, g in runs:
        t = paged_attention_inputs(dev, gen, quant, kvh=kvh, g=g,
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
    window (taken again, up to three times, while it holds fewer than
    `iters` kernel records; then both times are the CUDA-event time)."""
    fn()
    for _ in range(3):
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


#: the served paths: (architecture, policy, or "fleet" for the tiered
#: fleet of FLEET's replicas)
PATHS = (("qwen2_5_14b", "fxp8"), ("deepseek_moe_16b", "fxp8"),
         ("qwen2_5_14b", "edge4"), ("qwen2_5_14b", "int-attention"),
         ("deepseek_moe_16b", "edge4"), ("qwen2_5_14b", "fleet"),
         ("qwen2_5_14b", "fxp32"))


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


def check_fleet_phase(dev):
    """The reduced fleet (an fxp8 and an fxp16 replica, tiered routing)
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
    for backend in ("kernels", "reference"):
        router = build_fleet(cfg, list(FLEET), backend=backend, seed=0,
                             device=dev, routing="tiered", **kw)
        finished = serve_tokens(router, make_requests(cfg, 8, 32, 16,
                                                      mixed=True, seed=0))[1]
        got[backend] = [(o.tier, o.tokens) for o in finished]
    if got["kernels"] != got["reference"]:
        fail(f"reduced fleet {FLEET}: kernels {got['kernels']} != plain "
             f"{got['reference']}")
    placed = sorted({t for t, _ in got["kernels"]})
    if placed != sorted(FLEET):
        fail(f"reduced fleet: requests placed on {placed} only")
    bank = TieredWeights(M.init_params(cfg, 0, device=dev), FLEET,
                         consume=True)
    for tier in FLEET:
        router = EngineRouter(cfg, bank, tiers=list(FLEET), routing="tiered",
                              backend="kernels", seed=0, device=dev, **kw)
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
    print(f"check reduced fleet {','.join(FLEET)}: kernels == plain path on "
          f"the card ({sum(len(t) for _, t in got['kernels'])} greedy "
          "tokens, the same tiers); pinned to each tier == a single engine "
          "of that tier over the same bank", flush=True)


#: each kernel wrapper's name and the names of its device records
RECORDS = {"fxp_gemm_fused": ("fxp_gemm_tc_kernel",
                              "fxp_gemm_x32_kernel"),
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


def modes_per_decode_step(cfg, pol) -> dict:
    """The fused GEMM's launches per decode step by kernel mode: every
    GEMM on the x32 mode past 16 bits and on the wide mode past 8 bits;
    the three routed expert banks of a MoE layer on a batched mode;
    packed modes under FxP4."""
    from repro_torch.core.fxp import FORMATS
    from repro_torch.kernels.fxp_gemm.fxp_gemm import GEMM_MODES
    n = launches_per_decode_step(cfg, pol)["fxp_gemm_fused"]
    out = dict.fromkeys(GEMM_MODES, 0)
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


def serve_phase(dev, arch, policy_name):
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
                      f"{ {k: c for k, (c, _) in t['kern'].items()} }, the "
                      f"counters say {t['counted']}; tracing the next step",
                      flush=True)
        if not tries or not tries[-1]["ok"]:
            fail(f"traced decode step of {label} {name}: no traced step's "
                 f"kernel records match the counters in {TRACE_TRIES} steps")
        trace = tries[-1]
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
            records=n_all, kernels={k: dict(launches=c, ms=ms)
                                    for k, (c, ms) in kern.items()})
    if len(traces) != len(replicas):
        fail(f"serve {label}: traced {sorted(traces)} of the replicas")
    return launches, dict(
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
    attn = attention_phase(dev, torch.Generator(device=dev).manual_seed(1))
    attn_int = attention_int_phase(
        dev, torch.Generator(device=dev).manual_seed(7))
    empty_ms = empty_launch_ms()
    af_rows = cordic_af_phase(dev, torch.Generator(device=dev).manual_seed(3))
    sm_rows = cordic_softmax_phase(
        dev, torch.Generator(device=dev).manual_seed(4))
    check_quantize_phase(dev)
    for arch, policy_name in PATHS:
        if policy_name != "fleet":
            check_phase(dev, arch, policy_name)
    check_fleet_phase(dev)
    launches, summaries = {}, []
    for arch, policy_name in PATHS:
        key = f"{arch}/{policy_name}"
        launches[key], summary = serve_phase(dev, arch, policy_name)
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
                           "(Qwen2.5-14B w1), int8 codes"),
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
                           "tokens, int8 pool, CORDIC softmax"),
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
                           "launch"),
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
