"""K splits of the tensor-core GEMM core, timed.

    PYTHONPATH=src python tools/gemm_split_sweep.py [--x32]

Needs an NVIDIA GPU and nvcc. For each int8 dense shape of the serving
paths (Qwen2.5-14B's and DeepSeekMoE-16B's projections at 4 decode rows,
Qwen's 16-row prefill chunk), and for Qwen2.5-14B's shapes on FxP32 codes
in int32 (the x32 mode), it times the fused GEMM (the profiler's device
time of `fxp_gemm_tc_kernel` over 20 calls) at the K split that `k_split`
picks and at other splits (slices of whole 128-row stages), and prints
the blocks and the time of each. For the expert banks (int8 and
packed FxP4, DeepSeekMoE-16B's decode and prefill shapes, 4 or 16 tokens
routed top-6 of 64 experts) it times the K split `k_split` picks (one
slice) against two and four slices. `--x32` sweeps the x32 mode's shapes
alone. Each call is checked bit-equal to the plain version first.
"""
from __future__ import annotations

import argparse
import sys

import torch

from gemm_tail_timeline import kernel_ms
from repro_torch.kernels.fxp_gemm import fxp_gemm as fx

# (M, K, N, AF) of the int8 dense GEMMs the paths run
DENSE = [(4, 5120, 5120, None), (4, 5120, 1024, None),
         (4, 5120, 13824, "silu"), (4, 13824, 5120, None),
         (4, 5120, 152064, None), (16, 5120, 5120, None),
         (4, 2048, 2048, None), (4, 2048, 2816, None),
         (4, 2816, 2048, None), (4, 2048, 102400, None)]
# (M, K, N, AF) of the x32 mode's GEMMs on the qwen fxp32 path
X32 = [(4, 5120, 5120, None), (4, 5120, 1024, None),
       (4, 5120, 13824, "silu"), (4, 13824, 5120, None),
       (4, 5120, 152064, None), (16, 5120, 5120, None)]
# (E, M, K, N, routed tokens, packed) of the banks
BANKS = [(64, 4, 2048, 1408, 4, False), (64, 4, 1408, 2048, 4, False),
         (64, 16, 2048, 1408, 16, False), (64, 4, 2048, 1408, 4, True)]
SPLITS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32, 40)


def forced(kps):
    """A stand-in for `k_split` that returns `kps`."""
    return lambda *a, **kw: kps


def slices(k):
    """{kps: splits} of the candidate splits of K."""
    out = {}
    for s in SPLITS:
        kps = -(-(-(-k // s)) // 128) * 128
        out.setdefault(kps, -(-k // kps))
    return out


def time_at(kps, run, check):
    rule = fx.k_split
    fx.k_split = forced(kps)
    try:
        check()
        return kernel_ms(run)
    finally:
        fx.k_split = rule


def queues(dev, gen, e, m, k, tokens, q):
    x = torch.zeros((e, m, k), dtype=torch.int8, device=dev)
    for _ in range(tokens):
        for ex in torch.randperm(e, generator=gen, device=dev)[:6].tolist():
            slot = int((x[ex].abs().sum(-1) > 0).sum())
            x[ex, slot].random_(-q, q + 1, generator=gen)
            x[ex, slot, 0] = 1
    return x


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--x32", action="store_true",
                    help="sweep the x32 mode's shapes alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    dense = ([] if args.x32 else
             [(m, k, n, af, torch.int8) for m, k, n, af in DENSE])
    dense += [(m, k, n, af, torch.int32) for m, k, n, af in X32]
    for m, k, n, af, core in dense:
        q = 127 if core == torch.int8 else (1 << 31) - 1
        x = torch.randint(-q, q, (m, k), generator=gen, device=dev,
                          dtype=core)
        w = torch.randint(-q, q, (k, n), generator=gen, device=dev,
                          dtype=core)
        s = torch.rand((n,), generator=gen, device=dev) * 1e-4
        ref = fx.fxp_gemm_fused_plain(x, w, s, af=af)

        def run():
            return fx.fxp_gemm_fused(x, w, s, af=af)

        def check():
            if not torch.equal(run(), ref):
                raise RuntimeError(f"M {m} K {k} N {n}: not bit-equal")
        block_n, m_tiles = fx._tiles(m, core=core)
        tiles = -(-n // block_n) * m_tiles
        rule = fx.k_split(m, k, n, core=core)
        cells = []
        for kps, splits in slices(k).items():
            if tiles * splits > 4096 and kps != rule:
                continue
            ms = time_at(kps, run, check)
            cells.append((ms, kps, splits))
        best = min(cells)
        print(f"{'int8' if core == torch.int8 else 'int32'} M {m} K {k} "
              f"N {n} af {af}: " + "; ".join(
            f"{splits}x{kps} ({tiles * splits} blocks) {1e3 * ms:.2f} us"
            + (" [rule]" if kps == rule else "")
            for ms, kps, splits in cells)
              + f"; fastest {best[2]} slices of {best[1]}", flush=True)

    for e, m, k, n, tokens, packed in [] if args.x32 else BANKS:
        x = queues(dev, gen, e, m, k, tokens, 7 if packed else 127)
        w = torch.randint(-128 if packed else -127, 128,
                          (e, k, n // 2 if packed else n), generator=gen,
                          device=dev, dtype=torch.int8)
        s = torch.rand((e, 1, n), generator=gen, device=dev) * 1e-2
        ref = fx.fxp_gemm_fused_batched_plain(x, w, s, packed=packed)
        live = int((x.reshape(e, -1) != 0).any(-1).sum())

        def run():
            return fx.fxp_gemm_fused_batched(x, w, s, packed=packed)

        def check():
            if not torch.equal(run(), ref):
                raise RuntimeError(f"bank E {e} M {m} K {k} N {n}: not "
                                   "bit-equal")
        rule = fx.k_split(m, k, n, e, packed)
        cells = []
        for splits in (1, 2, 4):
            kps = -(-(-(-k // splits)) // 128) * 128
            ms = time_at(kps, run, check)
            cells.append(f"{splits}x{kps} {1e3 * ms:.2f} us"
                         + (" [rule]" if kps == rule else ""))
        print(f"bank {'packed FxP4' if packed else 'int8'} E {e} M {m} K {k}"
              f" N {n}, {live} experts routed: " + "; ".join(cells),
              flush=True)


if __name__ == "__main__":
    main()
