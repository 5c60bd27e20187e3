"""Time both paged decode attentions on the card at the smoke's shapes,
at every cluster size C the kernels can launch with.

    python3 tools/attention_sweep.py [--src DIR] [--label NAME]

For each shape of `chip_smoke.ATTN_CASES` that the serving paths reach
(1024-2000 and 4000-12000 cached tokens and the serve paths' width at
Qwen2.5-14B's 4 rows x 8 KV heads x g 5, and 1024-2000 tokens at
DeepSeekMoE-16B's 16 KV heads x g 1 for the float body), each kernel is
held against its plain version (within 1% of the output range) and timed
from the profiler's kernel records, 20 calls, once at the C the wrapper
picks and once at every other C of `CLUSTER_SIZES` (the wrapper's
`cluster_size` replaced for the call). `--src DIR` imports `repro_torch`
from DIR instead, for example an older checkout's `src` unpacked beside
this one, whose wrappers may not take a cluster size: they are timed at
their own launch only. Prints one line a measurement and writes them to
chiprun_out/attention_sweep-<label>.json. Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402  (puts this tree's src on the path)

# (body, case, KV heads, g)
SHAPES = [("float", "1024-2000 tokens", 8, 5),
          ("float", "4000-12000 tokens", 8, 5),
          ("float", "1024-2000 tokens", 16, 1),
          ("float", "serve width", 8, 5),
          ("int", "1024-2000 tokens", 8, 5),
          ("int", "4000-12000 tokens", 8, 5),
          ("int", "serve width", 8, 5)]


def forced(c):
    """A stand-in for the wrapper's `cluster_size` that picks c."""
    def pick(*_):
        return c
    return pick


def calls(pa, body, t):
    """(kernel call, plain call, profiler record) of `body` on inputs t."""
    from repro_torch.core.activation import softmax_lv_stages
    from repro_torch.core.fxp import FORMATS, quantize
    q, k, v, tables, meta = (t[n] for n in ("q", "k", "v", "tables",
                                            "meta"))
    if body == "float":
        width = tables.shape[1] * k.shape[1]
        kw = dict(k_scale=t["ks"], v_scale=t["vs"], cordic_softmax=True,
                  hr_stages=4, lv_stages=softmax_lv_stages(width, "fxp8"),
                  out_dtype=torch.bfloat16)
        return (lambda: pa.paged_attention_float(q, k, v, tables, meta, **kw),
                lambda: pa.paged_attention_float_plain(q, k, v, tables, meta,
                                                       **kw),
                "paged_attention_kernel")
    fmt = FORMATS["fxp8"]
    qc, sq = quantize(q.float() / math.sqrt(q.shape[-1]), fmt, axis=3)
    args = (qc, sq, k, v, t["ks"], t["vs"], tables, meta)
    kw = dict(fmt=fmt, out_dtype=torch.bfloat16)
    return (lambda: pa.paged_attention_int(*args, **kw),
            lambda: pa.paged_attention_int_plain(*args, **kw),
            "paged_attention_int_kernel")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None,
                    help="import repro_torch from this directory")
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        smoke.fail("no CUDA card: this sweep times kernels on a GPU")
    if args.src:
        sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import paged_attention as pa
    print(f"card: {smoke.card_line()}; repro_torch from "
          f"{Path(pa.__file__).resolve().parents[3]}", flush=True)
    build.build(["paged_attention"])
    dev = torch.device("cuda", 0)
    picker = getattr(pa, "cluster_size", None)
    rows = []
    for body, case, kvh, g in SHAPES:
        t = smoke.paged_attention_inputs(
            dev, torch.Generator(device=dev).manual_seed(1), True, kvh=kvh,
            g=g, **smoke.ATTN_CASES[case])
        b, mb, bs = t["q"].shape[0], t["tables"].shape[1], t["k"].shape[1]
        kernel, plain, record = calls(pa, body, t)
        ref = plain().float()
        tol = 1e-2 * ref.abs().max().item()
        sizes = [None]
        if picker is not None:
            pick = pa.cluster_plan(b, kvh, g, t["q"].shape[3], mb, bs,
                                   integer=body == "int")[0]
            sizes = [pick] + [c for c in pa.CLUSTER_SIZES if c != pick]
        for c in sizes:
            if c is not None:
                pa.cluster_size = forced(c)
                pa._plan.cache_clear()
            try:
                got = kernel()
                torch.cuda.synchronize()
                err = (got.float() - ref).abs().max().item()
                win = {}
                ms = smoke.timed(kernel, 20, record, win)
            finally:
                if picker is not None:
                    pa.cluster_size = picker
                    pa._plan.cache_clear()
            ok = bool(torch.isfinite(got.float()).all()) and err <= tol
            row = dict(label=args.label, body=body, case=case, kv=kvh, g=g,
                       cluster=c, picked=c == sizes[0], ms=ms, held=win["held"],
                       iters=win["iters"], max_abs_err=err, tol=tol, ok=ok)
            rows.append(row)
            print(f"{args.label}: paged_attention_{body} {case} KV={kvh} "
                  f"g={g} MB={mb}, C={c if c is not None else 'own launch'}"
                  f"{' (picked)' if row['picked'] and c else ''}: {ms:.4f} "
                  f"ms ({win['held']} of {win['iters']} records), max|err| "
                  f"{err:.3g} (tol {tol:.3g}){'' if ok else ' FAILED'}",
                  flush=True)
        del t
    out = ROOT / "chiprun_out" / f"attention_sweep-{args.label}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    if not all(r["ok"] for r in rows):
        smoke.fail("a kernel disagreed with its plain version")


if __name__ == "__main__":
    main()
