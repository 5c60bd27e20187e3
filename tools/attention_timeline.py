"""Where the time of the paged decode attentions goes, CTA by CTA.

    python3 tools/attention_timeline.py

Needs an NVIDIA GPU and nvcc. Builds csrc/paged_attention.cu with
-DPA_TIMELINE, which has thread 0 of every CTA write %globaltimer (ns) at
each phase boundary of its kernel (the PA_PROBE marks; the shipped build
compiles them away), swaps that library in for the package's, and runs
each kernel once at the shapes of tools/attention_sweep.py at the C the
wrapper picks. It prints, for each phase, when the CTAs reach its end
(µs from the first CTA's start: median and max over the CTAs), the
probed kernel's span beside the profiler's time of the shipped and of the
probed kernel, and how many clusters of C CTAs the card holds at once
(cudaOccupancyMaxActiveClusters) against the clusters the launch asks
for. The probes change nothing else; their outputs are not used.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402  (puts this tree's src on the path)
from attention_sweep import SHAPES, calls  # noqa: E402

PHASES = {
    "float": ("start", "q, table loaded", "K tiles scored", "row max",
              "exp, local sum", "V tiles summed", "partials summed",
              "merged", "end"),
    "int": ("start", "q, table loaded", "K tiles scored", "row max",
            "exp, row sum", "pv, requantize scale", "codes",
            "V tiles summed", "partials summed", "end"),
}
_WORDS = 16          # probe words a CTA


def build_probed():
    """The kernels' library built with their phase probes."""
    from repro_torch.kernels import build as kb
    from repro_torch.kernels.paged_attention import paged_attention as pa
    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = kb.BUILD_DIR / "paged_attention-timeline.so"
    cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-DPA_TIMELINE", "-I", str(kb.CSRC),
           "-o", str(path), str(kb.CSRC / "paged_attention.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in pa._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    lib.paged_attention_probes.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.paged_attention_probes.restype = ctypes.c_int
    return lib


def main():
    if not torch.cuda.is_available():
        smoke.fail("no CUDA card: this timeline runs on a GPU")
    from repro_torch.kernels import build as kb
    from repro_torch.kernels.paged_attention import paged_attention as pa
    print(f"card: {smoke.card_line()}", flush=True)
    shipped = kb.library("paged_attention", pa._SIGNATURES)
    probed = build_probed()
    dev = torch.device("cuda", 0)
    for body, case, kvh, g in SHAPES:
        t = smoke.paged_attention_inputs(
            dev, torch.Generator(device=dev).manual_seed(1), True, kvh=kvh,
            g=g, **smoke.ATTN_CASES[case])
        b, mb, bs = t["q"].shape[0], t["tables"].shape[1], t["k"].shape[1]
        hd = t["q"].shape[3]
        kernel, _, record = calls(pa, body, t)
        code = 0 if body == "int" else 1
        c, scratch = pa.cluster_plan(b, kvh, g, hd, mb, bs,
                                     integer=body == "int")
        smem = shipped.paged_attention_smem_bytes(code, g, hd, bs,
                                                  -(-mb // c), int(not scratch))
        ms = smoke.timed(kernel, 20, record)
        kb._LIBS["paged_attention"] = probed
        try:
            pms = smoke.timed(kernel, 20, record)
            kernel()
            torch.cuda.synchronize()
            n = b * kvh * c
            buf = torch.zeros(n * _WORDS, dtype=torch.int64)
            err = probed.paged_attention_probes(buf.data_ptr(),
                                                buf.numel() * 8)
            if err:
                smoke.fail(f"reading the probes: CUDA error {err}")
            fit = probed.paged_attention_max_clusters(code, c, smem)
        finally:
            kb._LIBS["paged_attention"] = shipped
        names = PHASES[body]
        ts = buf.view(n, _WORDS)[:, :len(names)].double()
        t0 = ts[:, 0].min()
        rel = (ts - t0) / 1e3                       # µs from the first start
        print(f"{body} {case} B={b} KV={kvh} g={g} MB={mb} C={c}: {n} CTAs "
              f"in {n // c} clusters, {smem} bytes of shared memory a CTA, "
              f"the card holds {fit} such clusters at once; shipped "
              f"{ms:.4f} ms, probed {pms:.4f} ms, probed span "
              f"{(ts[:, -1].max() - t0).item() / 1e3:.2f} µs", flush=True)
        for i, name in enumerate(names):
            col = rel[:, i]
            step = (rel[:, i] - rel[:, i - 1]) if i else col
            print(f"  {name:>22}: reached at median {col.median():8.2f} µs, "
                  f"max {col.max():8.2f}; the phase takes median "
                  f"{step.median():7.2f}, max {step.max():7.2f}", flush=True)
        del t


if __name__ == "__main__":
    main()
