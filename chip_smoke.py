"""On-card smoke test of the PyTorch/CUDA port (repro_torch) on one H100.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero before the last line:
  1. card     — `nvidia-smi` name and power limit;
  2. build    — nvcc builds every kernel under src/repro_torch/csrc;
  3. kernels  — each kernel against its plain PyTorch version on the card
                at the main path's shapes (GEMM bit-equal without an AF),
                with its time, the plain version's time and its bound;
                the attention also at long rows, whose score row lives
                in a global scratch row instead of shared memory;
  4. check    — the reduced model served through the kernels and through
                the plain path on the card: same greedy tokens;
  5. serve    — full-width Qwen2.5-14B, FxP8 quantize-once weights, paged
                int8 KV (block 16), 4 slots, 8 mixed requests (prompts
                32-64), 16 greedy tokens each, overlap loop, all 48
                layers; launch counts from this run, tokens identical on
                a rerun, one decode step of the rerun traced with the
                profiler (kernel device time and the device's idle share).
The second-to-last lines are the card line and the kernels JSON; the last
line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

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


def paged_attention_inputs(dev, gen, quant: bool, lengths):
    """Pools, tables and metadata for SLOTS rows holding `lengths` cached
    tokens each, in blocks shuffled over the pool, tables ending in
    sentinel entries."""
    kvh, g, hd, bs = 8, 5, 128, 16
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
    # (int8 pool + CORDIC softmax, cached tokens per row); the long rows'
    # score row does not fit in shared memory
    for quant, lengths in ((True, short), (False, short), (True, long_)):
        cordic_sm = quant
        (q, k, v, ks, vs, tables, meta, alloc_blocks,
         valid) = paged_attention_inputs(dev, gen, quant, lengths)
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


# ---------------------------------------------------------------------------
# phases 4-5: serving
# ---------------------------------------------------------------------------

def serve_tokens(engine, reqs):
    from repro_torch.launch.serve import serve
    finished, dt = serve(engine, reqs)
    return [o.tokens for o in finished], finished, dt


def check_phase(dev):
    """The reduced model through the kernels and through the plain path,
    both on the card: the same greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.launch.serve import build_engine, make_requests
    cfg = get_config("qwen2_5_14b").reduced()
    toks = {}
    for backend in ("kernels", "reference"):
        eng = build_engine(cfg, PrecisionPolicy.flexpe(8, backend=backend),
                           seed=0, device=dev, max_slots=SLOTS, max_len=48,
                           prefill_chunk=16, kv_block_size=16, overlap=True)
        reqs = make_requests(cfg, 6, 32, 16, mixed=True, seed=0)
        toks[backend] = serve_tokens(eng, reqs)[0]
    if toks["kernels"] != toks["reference"]:
        fail(f"reduced model: kernels {toks['kernels']} != plain "
             f"{toks['reference']}")
    print(f"check reduced qwen2_5_14b: kernels == plain path on the card, "
          f"{sum(map(len, toks['kernels']))} greedy tokens", flush=True)


def serve_phase(dev):
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.kernels.fxp_gemm.fxp_gemm import fxp_gemm_fused
    from repro_torch.kernels.paged_attention.paged_attention import (
        paged_attention_float)
    from repro_torch.launch.serve import build_engine, make_requests
    cfg = get_config("qwen2_5_14b")
    gen_tokens, prompt_len = 16, 64
    t0 = time.perf_counter()
    engine = build_engine(cfg, PrecisionPolicy.flexpe(8, backend="kernels"),
                          seed=0, device=dev, max_slots=SLOTS,
                          max_len=prompt_len + gen_tokens, prefill_chunk=16,
                          kv_block_size=16, overlap=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"serve setup: full-width qwen2_5_14b, {cfg.n_layers} layers, "
          f"random weights quantized to FxP8 in {setup_s:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card",
          flush=True)

    def counts():
        return fxp_gemm_fused.launches, paged_attention_float.launches

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
                      (c1[0] - c0[0], c1[1] - c0[1])))
        return out
    ex.decode_and_sample = timed_decode

    reqs = make_requests(cfg, 8, prompt_len, gen_tokens, mixed=True, seed=0)
    fxp_gemm_fused.launches = 0
    paged_attention_float.launches = 0
    toks, finished, dt = serve_tokens(engine, reqs)
    launches = dict(zip(("fxp_gemm_fused", "paged_attention_float"),
                        counts()))
    n_decode = len(spans)
    dev_ms = statistics.median(s.elapsed_time(e) for s, e, _, _ in spans)
    host_ms = 1e3 * statistics.median(h for _, _, h, _ in spans)
    per_step = sorted({c for _, _, _, c in spans})

    if len(finished) != len(reqs):
        fail(f"serve: {len(finished)} of {len(reqs)} requests finished")
    for o in finished:
        if len(o.tokens) != gen_tokens or not all(
                0 <= t < cfg.vocab for t in o.tokens):
            fail(f"serve: request {o.id} returned {o.tokens}")
    for name, n in launches.items():
        if n == 0:
            fail(f"serve: kernel {name} was never launched")
    st = engine.stats()
    total = st["prompt_tokens"] + st["generated_tokens"]
    print(f"serve: {len(finished)} requests, {st['prompt_tokens']} prompt + "
          f"{st['generated_tokens']} generated tokens in {dt:.3f} s = "
          f"{total / dt:.1f} tok/s ({st['generated_tokens'] / dt:.1f} "
          f"generated tok/s); {n_decode} decode steps, median "
          f"{dev_ms:.2f} ms on the device stream, {host_ms:.2f} ms to "
          f"enqueue; launches {launches}, per decode step (GEMM, "
          f"attention) {per_step}", flush=True)

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
        trace["counted"] = (c1[0] - c0[0], c1[1] - c0[1])
        trace["records"] = device_records(prof)
        return out
    ex.decode_and_sample = traced_decode
    again, _, dt2 = serve_tokens(engine, make_requests(
        cfg, 8, prompt_len, gen_tokens, mixed=True, seed=0))
    ex.decode_and_sample = decode
    if again != toks:
        fail("serve: rerun of the same workload gave other tokens")
    print(f"serve rerun: identical tokens ({dt2:.3f} s); first request "
          f"{toks[0]}", flush=True)

    rec = trace["records"]
    n_gemm, gemm_ms = matching(rec, "fxp_gemm_fused_kernel")
    n_attn, attn_ms = matching(rec, "paged_attention_kernel")
    n_all, all_ms = matching(rec, None)
    if (n_gemm, n_attn) != trace["counted"]:
        fail(f"traced decode step: {n_gemm} GEMM and {n_attn} attention "
             f"kernel records, the counters say {trace['counted']}")
    idle = 1.0 - all_ms / trace["wall_ms"]
    print(f"traced decode step (rerun step {target} of {n_decode}, synced, "
          f"under the profiler): {trace['wall_ms']:.3f} ms wall; device "
          f"time {all_ms:.3f} ms in {n_all} records = {n_gemm} GEMM "
          f"kernels {gemm_ms:.3f} ms + {n_attn} attention kernels "
          f"{attn_ms:.3f} ms + {n_all - n_gemm - n_attn} other "
          f"{all_ms - gemm_ms - attn_ms:.3f} ms; device idle "
          f"{100 * idle:.1f}% of the step", flush=True)
    top = sorted(rec.items(), key=lambda kv: -kv[1][1])[:8]
    print("traced decode step, largest device records: " + "; ".join(
        f"{k[:60]} x{c} {ms:.3f} ms" for k, (c, ms) in top), flush=True)
    return launches, dict(
        tok_s=total / dt, generated_tok_s=st["generated_tokens"] / dt,
        decode_ms=dev_ms, enqueue_ms=host_ms, seconds=dt,
        launches_per_decode_step=per_step,
        traced_step=dict(wall_ms=trace["wall_ms"], device_ms=all_ms,
                         gemm_ms=gemm_ms, gemm_launches=n_gemm,
                         attention_ms=attn_ms, attention_launches=n_attn,
                         idle_share=idle))


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
    attn = attention_phase(dev, torch.Generator(device=dev).manual_seed(1))
    check_phase(dev)
    launches, serve_stats = serve_phase(dev)

    w1 = next(r for r in gemm_rows if r["af"] == "silu")
    kernels = [
        {"name": "fxp_gemm_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/fxp_gemm.cu",
         "replaces": "src/repro/kernels/fxp_gemm/fxp_gemm.py:158",
         "launches": launches["fxp_gemm_fused"],
         "max_abs_err": gemm_err, "ms": w1["ms"],
         "plain_ms": w1["plain_ms"], "bound_ms": w1["bound_ms"],
         "bound_by": w1["bound_by"], "library_ms": None,
         "timing": TIMING["source"], "call_ms": w1["call_ms"],
         "shape": f"M={w1['m']} K={w1['k']} N={w1['n']} +silu (w1)"},
        {"name": "paged_attention_float", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/paged_attention.py"
                     ":172",
         "launches": launches["paged_attention_float"],
         "max_abs_err": attn["max_abs_err"], "ms": attn["ms"],
         "plain_ms": attn["plain_ms"], "bound_ms": attn["bound_ms"],
         "bound_by": attn["bound_by"], "library_ms": None,
         "timing": TIMING["source"],
         "shape": "B=4 KV=8 g=5 hd=128 bs=16, 1024-2000 cached tokens, "
                  "int8 pool, CORDIC softmax"},
    ]
    print("kernels: " + ", ".join(f"{k['name']} launched {k['launches']}x"
                                  for k in kernels), flush=True)
    print(f"serve summary: {json.dumps(serve_stats)}; total "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
