"""Where the time of the tensor-core GEMM core goes, block by block.

    PYTHONPATH=src python tools/gemm_tail_timeline.py

Needs an NVIDIA GPU and nvcc. Builds a copy of csrc/fxp_gemm.cu with a
probe at each phase boundary of `fxp_gemm_tc_kernel` (thread 0 of each
block writes %globaltimer, in ns: start, k loop done, warps' tiles
summed, split-K adds issued, semaphore passed, last block done) and one
copy that returns right after the k loop, then prints, for the raw int8
GEMM at M 32 x K 5120 x N 5120 and the wide mode at decode shapes, the
percentiles of each phase's end over the blocks (µs from the first
block's start), the k loop's own length per block, and the profiler's
kernel time of the shipped kernel and of the k loop alone. The probes
and the early return change nothing else; the copies' results are not
used. The copies are made by inserting text at anchors of the source
(`variants` raises when an anchor is not found exactly once;
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
          "unsigned long long*>(counters + " + str(_GAP) + ")[(blockIdx.z * "
          "gridDim.y * gridDim.x + blockIdx.y * gridDim.x + blockIdx.x) * 8 "
          "+ {}] = t_; }}\n")
_ACC = "  int acc[kPlanes<T>][4][NT][4];\n"
_RING = "  __syncthreads();                         // the ring is free\n"
_SUMMED = "  if (gridDim.y == 1) {\n"
_ADDS = "  // the block's adds, ordered by the barrier"
_LAST = "  if (!is_last) return;\n  // every load"
_END = "  for (int j = 0; j < kRows; ++j) store(j, total[j]);\n}\n"
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
    """{name: source}: the kernel with its phase probes, and the kernel
    that returns after its k loop."""
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
            "loop_only": _replace(src, _RING, _RING + _LOOP_ONLY)}


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


def _probe_workspace(x_codes, e, m, k, n, packed, core=None):
    """`_workspace` with room for the probes (8 words of 64 bits a block)
    `_GAP` int32 words past the semaphores' start."""
    kps = fx.k_split(m, k, n, e, packed, core)
    block_n, m_tiles = fx._tiles(m, packed, core)
    blocks = -(-n // block_n) * m_tiles * e * -(-k // kps)
    words = (2 if core == torch.int16 else 1) * e * m * n
    ws = torch.zeros(words + _GAP + 16 * blocks, dtype=torch.int32,
                     device=x_codes.device)
    _probe_workspace.last = (ws, words, blocks)
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


def main():
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    libs = {name: build(name, src) for name, src in variants().items()}
    shipped = kb.library("fxp_gemm", fx._SIGNATURES)
    gen = torch.Generator(device=dev).manual_seed(0)
    workspace = fx._workspace
    for m, k, n, dtype in ((32, 5120, 5120, torch.int8),
                           (4, 5120, 5120, torch.int16),
                           (4, 5120, 13824, torch.int16)):
        q = 127 if dtype == torch.int8 else 32767
        x = torch.randint(-q, q + 1, (m, k), generator=gen, device=dev,
                          dtype=dtype)
        w = torch.randint(-q, q + 1, (k, n), generator=gen, device=dev,
                          dtype=dtype)
        scale = torch.rand((n,), generator=gen, device=dev) * 1e-9

        def run():
            if dtype == torch.int8:
                return fx.fxp_gemm_codes(x, w)
            return fx.fxp_gemm_fused(x, w, scale)
        label = f"M {m} K {k} N {n} {str(dtype)[6:]}"
        times = {}
        for name, lib in (("shipped", shipped),
                          ("k loop alone", libs["loop_only"])):
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
        ws, words, blocks = _probe_workspace.last
        t = ws[words + _GAP:words + _GAP + 16 * blocks].view(torch.int64)
        t = t.view(blocks, 8).double().cpu()
        t0 = t[:, 0].min()
        print(f"{label}: {blocks} blocks; kernel {1e3 * times['shipped']:.2f}"
              f" us, its k loop alone {1e3 * times['k loop alone']:.2f} us",
              flush=True)
        for i, phase in enumerate(PHASES):
            col = t[:, i][t[:, i] > 0]
            if len(col):
                us = (col - t0) / 1e3
                print(f"  {phase:>15}: {len(col):4d} blocks, end at "
                      f"{us.min():7.2f} / {us.median():7.2f} / "
                      f"{us.max():7.2f} us (min / median / max)", flush=True)
        loop = (t[:, 1] - t[:, 0]) / 1e3
        print(f"  k loop per block: {loop.min():.2f} / {loop.median():.2f} "
              f"/ {loop.max():.2f} us", flush=True)


if __name__ == "__main__":
    main()
