"""Time the one-launch CORDIC AF op on the card over its grid shape: the
threads a block and the fewest elements a thread holds.

    python3 tools/cordic_grid_sweep.py

`csrc/cordic_af.cu` launches 512 threads a block and picks the least J of
1, 2, 4, 8, 16 elements a thread whose resident grid covers the tensor,
so the grid is as wide as the card holds. A wider grid spreads the AF's work but
makes each grid barrier (and each block's read of the slots) longer. This
sweep builds copies of the source with the block size set to 256, 512 or
1024 threads and J starting at 1, 2, 4 or 8 (one nvcc each, in parallel),
and times each copy's kernel record (20 calls under the profiler) on
bf16 FxP8 silu at the MoE path's shapes, each call held bit for bit
against the plain op. Prints one line a measurement and writes them to
chiprun_out/cordic_grid_sweep.json. Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402  (puts this tree's src on the path)

SHAPES = {"decode": (1, 64, 4, 1408), "prefill": (1, 64, 16, 1408),
          "shared": (1, 4, 2816)}
VARIANTS = [(t, j) for t in (256, 512, 1024) for j in (1, 2, 4, 8)]


def variant_source(src: str, threads: int, min_j: int) -> str:
    for old, new in ((r"constexpr int kThreads = \d+;",
                      f"constexpr int kThreads = {threads};"),
                     (r"held_per_thread<T, 1>\(n\)",
                      f"held_per_thread<T, {min_j}>(n)")):
        src, count = re.subn(old, new, src)
        if count != 1:
            smoke.fail(f"cordic_af.cu has no `{old}` to vary")
    return src


def main():
    if not torch.cuda.is_available():
        smoke.fail("no CUDA card: this sweep times kernels on a GPU")
    from repro_torch.kernels import build
    from repro_torch.kernels.cordic_af import cordic_af as af_mod
    print(f"card: {smoke.card_line()}", flush=True)
    src = (build.CSRC / "cordic_af.cu").read_text()
    tmp = Path(tempfile.mkdtemp(prefix="cordic_grid_"))
    procs = {}
    for threads, min_j in VARIANTS:
        cu = tmp / f"af_{threads}_{min_j}.cu"
        cu.write_text(variant_source(src, threads, min_j))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(cu.with_suffix(".so")), str(cu)]
        procs[(threads, min_j)] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            smoke.fail(f"nvcc failed for variant {key}:\n{log}")
        lib = ctypes.CDLL(str(tmp / f"af_{key[0]}_{key[1]}.so"))
        fn = lib.cordic_af_op
        fn.argtypes, fn.restype = af_mod._SIGNATURES["cordic_af_op"]
        libs[key] = fn

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build.cordic_params(4)
    slots = build.op_slots(dev)
    rows = []
    for name, shape in SHAPES.items():
        x = (torch.randn(shape, generator=gen, device=dev) * 3).to(
            torch.bfloat16)
        want = af_mod.cordic_af_reference(x, "silu", precision="fxp8")
        for (threads, min_j), fn in libs.items():
            out = torch.empty_like(x)

            def call(fn=fn, out=out):
                err = fn(x.data_ptr(), out.data_ptr(), slots.data_ptr(),
                         slots.numel(), x.numel(), 1, af_mod.AF_CODE["silu"],
                         5, 1, -128.0, 127.0, ctypes.byref(params),
                         torch.cuda.current_stream(dev).cuda_stream)
                if err != 0:
                    smoke.fail(f"variant {threads}/{min_j}: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            ok = torch.equal(out, want)
            win = {}
            ms = smoke.timed(call, 20, "cordic_af_kernel", win)
            rows.append(dict(shape=name, threads=threads, min_j=min_j, ms=ms,
                             held=win["held"], ok=ok))
            print(f"cordic_af silu bf16 fxp8 {name} {list(shape)}, "
                  f"{threads} threads a block, J from {min_j}: {ms:.4f} ms "
                  f"({win['held']} of {win['iters']} records)"
                  f"{'' if ok else ' NOT bit-equal'}", flush=True)
    out = ROOT / "chiprun_out" / "cordic_grid_sweep.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    if not all(r["ok"] for r in rows):
        smoke.fail("a variant disagreed with the plain op")


if __name__ == "__main__":
    main()
