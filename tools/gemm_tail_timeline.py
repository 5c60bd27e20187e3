"""Where the time of the tensor-core GEMM core goes, work item by item.

    PYTHONPATH=src python tools/gemm_tail_timeline.py

Needs an NVIDIA GPU and nvcc. Builds a copy of csrc/fxp_gemm.cu with a
probe at each phase boundary of the core's work item, a (column tile, K
slice, row tile or expert's row tile) of `fxp_gemm_tc_kernel` (thread 0
writes %globaltimer, in ns: start, k loop done, warps' tiles summed,
split-K adds issued, semaphore passed, last item of the tile done), one
copy that returns right after the k loop, and one that runs int8 banks
on the grid (one item a block) instead of handing their items out. It
then prints, for the raw int8 and the raw packed FxP4 GEMM at M 32 x K
5120 x N 5120, the wide mode at decode shapes, the int8 and packed modes
at Qwen2.5-14B's w1 (fused SiLU) and DeepSeekMoE-16B's expert banks (64
experts; int8 at decode, 4 tokens routed top-6, for 2048 -> 1408 and
1408 -> 2048, at a 16-row prefill chunk and with every queue full;
packed at decode), the percentiles of each phase's end over the items
(µs from the first item's start; an unsplit grid ends its items after
"tiles summed"), the k loop's own length per item (and, for a bank, over
the items that streamed weights), and the profiler's kernel time of the
shipped kernel, of the k loop alone and, for int8 banks, of the grid.
The probes and the early return change nothing else; the copies' results
are not used. The copies are made by inserting text at anchors of the
source (`variants` raises when an anchor is not found exactly once;
tests/test_torch_gemm_tc.py checks that on the CPU), and the runs swap
the package's loaded library and workspace helper for the probed ones.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from repro_torch.kernels import build as kb
from repro_torch.kernels.fxp_gemm import fxp_gemm as fx

PHASES = ("start", "k loop", "tiles summed", "adds issued", "semaphore",
          "last block done")
_GAP = 4096          # int32 words from the semaphores to the probes
_PROBE = ("  if (threadIdx.x == 0) {{ unsigned long long t_; asm volatile("
          "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); reinterpret_cast<"
          "unsigned long long*>(counters + " + str(_GAP) + ")[((it.z * it.gy "
          "+ it.y) * it.gx + it.x) * 8 + {}] = t_; }}\n")
_ACC = "  int acc[kPlanes<T>][4][NT][4];\n"
_RING = "  __syncthreads();                         // the ring is free\n"
_SUMMED = "  if (it.gy == 1) {\n"
_HANDOUT = "constexpr bool kHandOut = kBank && !kPacked;"
_ADDS = "  // the block's adds, ordered by the barrier"
_LAST = "  if (!is_last) return;\n  // every load"
_END = ("  for (int j = 0; j < kRows; ++j) store(j, total[j]);\n"
        "  finish();\n}\n")
_LOOP_ONLY = ("  { int s_ = 0;\n    for (int p = 0; p < kPlanes<T>; ++p)\n"
              "    for (int i = 0; i < 4; ++i)\n"
              "    for (int nt = 0; nt < NT; ++nt)\n"
              "    for (int e = 0; e < 4; ++e) s_ += acc[p][i][nt][e];\n"
              "    if (s_ == 0x7fffffff) static_cast<int*>(out_)[0] = s_;\n"
              "    return; }\n")


def _replace(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"csrc/fxp_gemm.cu changed: {old!r} is not found "
                           "once")
    return src.replace(old, new)


def variants() -> dict:
    """{name: source}: the kernel with its phase probes, the kernel that
    returns after its k loop, and the kernel that runs int8 banks on the
    grid (one item a block) instead of handing their items out."""
    src = (kb.CSRC / "fxp_gemm.cu").read_text()
    probe = _PROBE.format
    probed = src
    for old, new in ((_ACC, probe(0) + _ACC), (_RING, _RING + probe(1)),
                     (_SUMMED, probe(2) + _SUMMED), (_ADDS, probe(3) + _ADDS),
                     (_LAST, probe(4) + _LAST),
                     (_END, _END[:-2] + "  __syncthreads();\n" + probe(5)
                      + "}\n")):
        probed = _replace(probed, old, new)
    return {"probed": probed,
            "loop_only": _replace(src, _RING, _RING + _LOOP_ONLY),
            "grid": _replace(src, _HANDOUT,
                             "constexpr bool kHandOut = false;")}


def build(name: str, src: str):
    out = kb.BUILD_DIR / "timeline"
    out.mkdir(parents=True, exist_ok=True)
    (out / "cordic.cuh").write_text((kb.CSRC / "cordic.cuh").read_text())
    (out / f"{name}.cu").write_text(src)
    subprocess.run([kb._nvcc(), *kb.NVCC_FLAGS, "-I", str(out), "-o",
                    str(out / f"{name}.so"), str(out / f"{name}.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out / f"{name}.so"))
    for fn, (argtypes, restype) in fx._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def _probe_workspace(x_codes, e, m, k, n, packed, core=None,
                     handout=False):
    """`_workspace` with room for the probes (8 words of 64 bits a work
    item) `_GAP` int32 words past the semaphores' start (the hand-out's
    counter lies before them)."""
    kps = fx.k_split(m, k, n, e, packed, core)
    block_n, m_tiles = fx._tiles(m, packed, core)
    items = -(-n // block_n) * m_tiles * e * -(-k // kps)
    words = (2 if core == torch.int16 else 1) * e * m * n
    ws = torch.zeros(words + _GAP + 16 * items, dtype=torch.int32,
                     device=x_codes.device)
    _probe_workspace.last = (ws, words, items)
    return kps, ws, ws[words:].data_ptr()


def kernel_ms(fn, iters=20, tries=3):
    """Mean profiler time of the tensor-core kernel over `iters` calls: a
    throwaway session first takes records delivered late, and a window
    that holds fewer than `iters` records is measured again, up to
    `tries` windows (nan when none holds them all)."""
    fn()
    act = [torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=act):
            torch.cuda.synchronize()
        with torch.profiler.profile(activities=act) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        sel = [(e.count, e.self_device_time_total)
               for e in prof.key_averages() if "fxp_gemm_tc_kernel" in e.key]
        if sum(c for c, _ in sel) == iters:
            return sum(t for _, t in sel) / iters / 1e3
        print(f"profiler: {sum(c for c, _ in sel)} records for {iters} "
              "launches; measuring again", flush=True)
    return float("nan")


def cases(dev, gen):
    """(label, call) of each GEMM the timeline takes apart."""
    def codes(shape, q, dtype=torch.int8):
        return torch.randint(-q, q + 1, shape, generator=gen, device=dev,
                             dtype=dtype)
    x, w = codes((32, 5120), 127), codes((5120, 5120), 127)
    yield "M 32 K 5120 N 5120 int8 raw", lambda: fx.fxp_gemm_codes(x, w)
    xp, wp = codes((32, 5120), 7), codes((5120, 2560), 127)
    yield ("M 32 K 5120 N 5120 packed FxP4 raw",
           lambda: fx.fxp4_gemm_packed(xp, wp))
    for n in (5120, 13824):
        xw, ww = codes((4, 5120), 32767, torch.int16), codes(
            (5120, n), 32767, torch.int16)
        sw = torch.rand((n,), generator=gen, device=dev) * 1e-9
        yield (f"M 4 K 5120 N {n} int16",
               lambda xw=xw, ww=ww, sw=sw: fx.fxp_gemm_fused(xw, ww, sw))
    s1 = torch.rand((13824,), generator=gen, device=dev) * 1e-4
    x8, w8 = codes((4, 5120), 127), codes((5120, 13824), 127)
    yield ("M 4 K 5120 N 13824 int8 + silu",
           lambda: fx.fxp_gemm_fused(x8, w8, s1, af="silu"))
    x1, w1 = codes((4, 5120), 7), codes((5120, 6912), 127)
    yield ("M 4 K 5120 N 13824 packed FxP4 + silu",
           lambda: fx.fxp_gemm_fused(x1, w1, s1, af="silu", packed=True))
    for e, m, k, n, tokens, packed in (
            (64, 4, 2048, 1408, 4, False), (64, 4, 1408, 2048, 4, False),
            (64, 16, 2048, 1408, 16, False), (64, 4, 2048, 1408, None, False),
            (64, 4, 2048, 1408, 4, True)):
        q = 7 if packed else 127
        sb = torch.rand((e, 1, n), generator=gen, device=dev) * 1e-2
        xb = torch.zeros((e, m, k), dtype=torch.int8, device=dev)
        if tokens is None:               # every expert's queue full
            xb = codes((e, m, k), q)
        for _ in range(tokens or 0):     # each token to 6 experts
            for ex in torch.randperm(e, generator=gen,
                                     device=dev)[:6].tolist():
                slot = int((xb[ex].abs().sum(-1) > 0).sum())
                if slot < m:
                    xb[ex, slot] = codes((k,), q)
                    xb[ex, slot, 0] = 1
        wb = codes((e, k, n // 2 if packed else n), 127)
        live = int((xb.reshape(e, -1) != 0).any(-1).sum())
        yield (f"bank E {e} M {m} K {k} N {n} "
               f"{'packed FxP4' if packed else 'int8'}, {live} experts "
               "routed", lambda xb=xb, wb=wb, sb=sb, packed=packed:
               fx.fxp_gemm_fused_batched(xb, wb, sb, packed=packed))


def main():
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    libs = {name: build(name, src) for name, src in variants().items()}
    shipped = kb.library("fxp_gemm", fx._SIGNATURES)
    workspace = fx._workspace
    for label, run in cases(dev, torch.Generator(device=dev).manual_seed(0)):
        times = {}
        runs = [("shipped", shipped), ("k loop alone", libs["loop_only"])]
        if label.startswith("bank") and "int8" in label:
            runs.append(("grid", libs["grid"]))
        for name, lib in runs:
            kb._LIBS["fxp_gemm"] = lib
            times[name] = kernel_ms(run)
        kb._LIBS["fxp_gemm"] = libs["probed"]
        fx._workspace = _probe_workspace
        try:
            for _ in range(3):
                run()
            torch.cuda.synchronize()
        finally:
            fx._workspace = workspace
            kb._LIBS["fxp_gemm"] = shipped
        ws, words, items = _probe_workspace.last
        t = ws[words + _GAP:words + _GAP + 16 * items].view(torch.int64)
        t = t.view(items, 8).double().cpu()
        t0 = t[:, 0].min()
        grid = (f", on the grid {1e3 * times['grid']:.2f} us"
                if "grid" in times else "")
        print(f"{label}: {items} work items; kernel "
              f"{1e3 * times['shipped']:.2f} us, its k loop alone "
              f"{1e3 * times['k loop alone']:.2f} us{grid}", flush=True)
        for i, phase in enumerate(PHASES):
            col = t[:, i][t[:, i] > 0]
            if len(col):
                us = (col - t0) / 1e3
                print(f"  {phase:>15}: {len(col):4d} items, end at "
                      f"{us.min():7.2f} / {us.median():7.2f} / "
                      f"{us.max():7.2f} us (min / median / max)", flush=True)
        loop = (t[:, 1] - t[:, 0]) / 1e3
        print(f"  k loop per item: {loop.min():.2f} / {loop.median():.2f} "
              f"/ {loop.max():.2f} us", flush=True)
        long_ = loop > 1.0           # a bank's items that streamed weights
        if 0 < int(long_.sum()) < items:
            ends = (t[long_, 2] - t0) / 1e3
            print(f"  {int(long_.sum())} items with a k loop over 1 us: "
                  f"loops {loop[long_].min():.2f} / "
                  f"{loop[long_].median():.2f} / {loop[long_].max():.2f} us,"
                  f" tiles summed at {ends.min():.2f} / {ends.median():.2f}"
                  f" / {ends.max():.2f} us", flush=True)


if __name__ == "__main__":
    main()
