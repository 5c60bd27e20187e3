"""On-card smoke test of the PyTorch/CUDA port (repro_torch) on one H100.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero before the last line:
  1. card     — `nvidia-smi` name and power limit;
  2. build    — nvcc builds every kernel under src/repro_torch/csrc, all
                at once;
  3. kernels  — each kernel against its plain PyTorch version on the card
                at the main paths' shapes, with its time, the plain
                version's time and its bound: the GEMM (bit-equal) at the
                dense projections, on int8 (the __dp4a walk), on packed
                FxP4 weights and on FxP16 codes in int16 (both on the
                tensor cores; the wide mode beside torch.matmul of the
                codes in f32, also at codes at the ends of int16), and,
                batched over 64 experts, at the MoE banks, int8 (the walk)
                and packed FxP4 (the tensor cores); the raw code GEMMs
                (bit-equal, all on the tensor cores: int8 beside
                torch._int_mm, int16, packed FxP4); the float attention
                (within 1%) at g 5 and g 1, and at long rows whose score
                row lives in a global scratch row; the integer attention
                (within 1%) at g 5, short and long rows; the CORDIC AF
                (bit-equal) at the MoE expert activations; the CORDIC
                softmax (bit-equal) at the router's rows and a wide row;
  4. check    — reduced Qwen2.5-14B (under FxP8, edge4 and integer
                attention) and reduced DeepSeekMoE-16B (FxP8 and edge4),
                each served through the kernels and through the plain path
                on the card: the same greedy tokens; the reduced fleet of
                an fxp8 and an fxp16 replica over one TieredWeights bank:
                the same tiers and tokens on both paths, and with every
                request pinned to one tier, the tokens of a single engine
                of that tier over the same bank;
  5. serve    — six paths, each at full width from seed 0: Qwen2.5-14B
                (48 layers) with FxP8 weights, DeepSeekMoE-16B (28 layers)
                with FxP8 weights, Qwen2.5-14B under edge4 (packed FxP4
                weights and activations), Qwen2.5-14B under integer
                attention (FxP8, exact AF, `int_attention`),
                DeepSeekMoE-16B under edge4 (packed FxP4 expert banks) and
                the precision-tiered fleet of Qwen2.5-14B (an fxp8 and an
                fxp16 replica over one TieredWeights bank, tiered routing,
                threshold 1.0, priority 0); each with paged int8 KV (block
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

def gemm_phase(dev, gen, packed=False):
    """The fused GEMM at the full-width model's shapes, on int8 codes or
    (`packed`) on FxP4 codes with nibble-packed weights [K, N/2] bytes,
    whose bytes bound counts half the int8 weight bytes. Packed weights
    must be bit-equal to the plain version, with the AF too. Each mode's
    time counts its own kernel's records: the __dp4a walk's for int8
    codes, the tensor-core core's for packed weights."""
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
    record = "fxp_gemm_tc_kernel" if packed else "fxp_gemm_fused_kernel"
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
        win = {}
        ms = timed(run, 20, record, win)
        call_ms = cuda_ms(run, 20)
        pms = timed(plain, 3)
        nbytes = m * k + w.numel() + 4 * n + 4 * m * n
        bms, by = bound_ms(nbytes, 2.0 * m * k * n, INT8_OPS_PER_S)
        rows.append(dict(m=m, k=k, n=n, af=af, ms=ms, plain_ms=pms,
                         bound_ms=bms, bound_by=by, max_abs_err=err,
                         call_ms=call_ms, **win))
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
        pms = timed(plain, 2)
        active = int((x.reshape(e, -1) != 0).any(-1).sum())
        filled = int((x != 0).any(-1).sum())
        nbytes = e * m * k + active * k * n // 2 + 4 * e * n + 4 * e * m * n
        bms, by = bound_ms(nbytes, 2.0 * filled * k * n, INT8_OPS_PER_S)
        occupancy = ("all queues full" if tokens is None else
                     f"{tokens} tokens x top-{top_k}: {filled} filled rows "
                     f"in {active} experts")
        print(f"kernel fxp_gemm_fused batched packed FxP4 E={e} M={m} K={k} "
              f"N={n} ({occupancy}): {ms:.4f} ms on the device (plain loop "
              f"{pms:.4f} ms, bound {bms:.4f} ms by {by}, "
              f"{100 * bms / ms:.1f}% of bound), bit-equal", flush=True)
        if first is None:
            first = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                         max_abs_err=0.0, **win,
                         shape=f"E={e} M={m} K={k} N={n} ({occupancy})")
    return first


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
        win = {}
        ms = timed(lambda: paged_attention_float(q, k, v, tables, meta,
                                                 **kw), 20,
                   "paged_attention_kernel", win)
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
                          max_abs_err=err, **win)
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
        win = {}
        ms = timed(lambda: paged_attention_int(*args, **kw), 20,
                   "paged_attention_int_kernel", win)
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
                          max_abs_err=err, **win)
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
        win = {}
        ms = timed(lambda: cordic_af(x, "silu"), 20, "cordic_af_kernel", win)
        pms = timed(lambda: cordic_af_plain(x, "silu", 4, 5), 3)
        bms, by = bound_ms(8.0 * n, CORDIC_SILU_OPS * n, F32_OPS_PER_S)
        rows.append(dict(shape=shape, ms=ms, plain_ms=pms, bound_ms=bms,
                         bound_by=by, max_abs_err=0.0, **win))
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
        win = {}
        ms = timed(lambda: cordic_softmax(x, hr_stages=4, lv_stages=lv), 20,
                   "cordic_softmax_kernel", win)
        pms = timed(lambda: cordic_softmax_plain(x, 4, lv), 3)
        bms, by = bound_ms(8.0 * m * n, CORDIC_SOFTMAX_OPS * m * n,
                           F32_OPS_PER_S)
        rows.append(dict(shape=(m, n), ms=ms, plain_ms=pms, bound_ms=bms,
                         bound_by=by, max_abs_err=0.0, **win))
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
    int8_attn serving variant). The fleet's replicas take the ladder's
    `tier_policy`."""
    from repro_torch.core.precision import PrecisionPolicy
    if name == "edge4":
        return PrecisionPolicy.edge4(backend=backend)
    if name == "int-attention":
        return dataclasses.replace(
            PrecisionPolicy.flexpe(8, af_impl="exact", backend=backend),
            int_attention=True)
    return PrecisionPolicy.flexpe(8, backend=backend)


#: the served paths: (architecture, policy, or "fleet" for the tiered
#: fleet of FLEET's replicas)
PATHS = (("qwen2_5_14b", "fxp8"), ("deepseek_moe_16b", "fxp8"),
         ("qwen2_5_14b", "edge4"), ("qwen2_5_14b", "int-attention"),
         ("deepseek_moe_16b", "edge4"), ("qwen2_5_14b", "fleet"))


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
RECORDS = {"fxp_gemm_fused": ("fxp_gemm_fused_kernel",
                              "fxp_gemm_tc_kernel"),
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
    GEMM on the wide mode past 8 bits; the three routed expert banks of a
    MoE layer on a batched mode; packed modes under FxP4."""
    from repro_torch.core.fxp import FORMATS
    from repro_torch.kernels.fxp_gemm.fxp_gemm import GEMM_MODES
    n = launches_per_decode_step(cfg, pol)["fxp_gemm_fused"]
    out = dict.fromkeys(GEMM_MODES, 0)
    if FORMATS[pol.matmul].bits > 8:
        out["wide"] = n
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
    # the int8-code kernels: the dense entry and the expert banks
    launches["fxp_gemm_fused:int8 codes"] = (launches["fxp_gemm_fused:int8"]
                                             + launches[
                                                 "fxp_gemm_fused:batched"])
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
    gemm_rows, gemm_err = gemm_phase(dev, gen)
    wide_rows = wide_gemm_phase(dev,
                                torch.Generator(device=dev).manual_seed(8))
    packed_bank = packed_batched_gemm_phase(
        dev, torch.Generator(device=dev).manual_seed(9))
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
    w1["max_abs_err"] = gemm_err
    pw1 = next(r for r in packed_rows if r["af"] == "silu")
    ww1 = next(r for r in wide_rows if r["af"] == "silu")
    gemm_src = "src/repro_torch/csrc/fxp_gemm.cu"
    gemm_ref = "src/repro/kernels/fxp_gemm/fxp_gemm.py"
    attn_src = "src/repro_torch/csrc/paged_attention.cu"
    attn_ref = "src/repro/kernels/paged_attention/paged_attention.py"
    kernels = [
        kernel_entry("fxp_gemm_fused", gemm_src, f"{gemm_ref}:158", w1,
                     launches, "deepseek_moe_16b/fxp8",
                     counter="fxp_gemm_fused:int8 codes",
                     call_ms=w1["call_ms"],
                     shape=f"M={w1['m']} K={w1['k']} N={w1['n']} +silu "
                           "(Qwen2.5-14B w1), int8 codes"),
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
        kernel_entry("fxp_gemm_fused_batched_packed", gemm_src,
                     f"{gemm_ref}:158", packed_bank, launches,
                     "deepseek_moe_16b/edge4",
                     counter="fxp_gemm_fused:batched_packed",
                     shape=packed_bank["shape"] + ", FxP4 codes x packed "
                           "nibble banks (fxp_gemm_fused_pallas packed=True "
                           "per expert, src/repro/kernels/dispatch.py:309)"),
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
