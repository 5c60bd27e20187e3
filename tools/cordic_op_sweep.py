"""Time the CORDIC ops per call on the card at the MoE path's shapes, by
all of the device records one call leaves.

    python3 tools/cordic_op_sweep.py [--src DIR] [--label NAME]

Cases: `cordic_af` silu on bf16 at the routed experts' activations at
decode ([1, 64, 4, 1408]) and per prefill chunk ([1, 64, 16, 1408]) and
the shared experts' ([1, 4, 2816]); `cordic_softmax` on the router's f32
logits at decode ([4, 64]) and per prefill chunk ([16, 64]); each under
FxP8 (the moe fxp8 path), FxP4 (moe edge4) and no precision. Each call is
held bit for bit against the plain op (`cordic_*_reference`) and timed
over 20 calls under the profiler: the sum of every device record (the op's
device time), the records per call, and the op's kernel record alone.
Also the device time of an empty launch (`torch.cuda._sleep(0)`), the
floor of any one-launch op. The script imports only the public ops, so
`--src DIR` times an older checkout's `src` (unpacked beside this one) the
same way. Prints one line a measurement and writes them to
chiprun_out/cordic_op_sweep-<label>.json. Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402  (puts this tree's src on the path)

ITERS = 20
AF_SHAPES = {"decode": (1, 64, 4, 1408), "prefill": (1, 64, 16, 1408),
             "shared": (1, 4, 2816)}
ROUTER_SHAPES = {"decode": (4, 64), "prefill": (16, 64)}
PRECISIONS = ("fxp8", "fxp4", None)


def per_call(fn, record):
    """(device ms of every record, records, device ms of `record`) per
    call of `fn()`, from one profiler window of ITERS calls."""
    fn()
    rec = smoke.profile_window(fn, ITERS)
    n_all, ms_all = smoke.matching(rec, None)
    _, ms_kernel = smoke.matching(rec, record)
    return ms_all / ITERS, n_all / ITERS, ms_kernel / ITERS


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
    from repro_torch.kernels.cordic_af.cordic_af import (cordic_af,
                                                         cordic_af_reference)
    from repro_torch.kernels.cordic_softmax.cordic_softmax import (
        cordic_softmax, cordic_softmax_reference)
    print(f"card: {smoke.card_line()}; repro_torch from "
          f"{Path(sys.modules[cordic_af.__module__].__file__).parents[3]}",
          flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for name, shape in AF_SHAPES.items():
        x = (torch.randn(shape, generator=gen, device=dev) * 3).to(
            torch.bfloat16)
        for p in PRECISIONS:
            cases.append((f"cordic_af silu bf16 {name} {list(shape)}", p,
                          lambda x=x, p=p: cordic_af(x, "silu", precision=p),
                          lambda x=x, p=p: cordic_af_reference(
                              x, "silu", precision=p), "cordic_af_kernel"))
    for name, shape in ROUTER_SHAPES.items():
        x = torch.randn(shape, generator=gen, device=dev) * 2
        for p in PRECISIONS:
            cases.append((f"cordic_softmax f32 {name} {list(shape)}", p,
                          lambda x=x, p=p: cordic_softmax(x, precision=p),
                          lambda x=x, p=p: cordic_softmax_reference(
                              x, precision=p), "cordic_softmax_kernel"))
    rows = []
    empty_ms, empty_n, _ = per_call(lambda: torch.cuda._sleep(0), None)
    print(f"{args.label}: empty launch (torch.cuda._sleep(0)): "
          f"{empty_ms:.4f} ms in {empty_n:g} record a call", flush=True)
    rows.append(dict(label=args.label, case="empty launch", precision=None,
                     op_ms=empty_ms, records=empty_n, kernel_ms=empty_ms,
                     ok=True))
    for case, p, op, plain, record in cases:
        got, want = op(), plain()
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        op_ms, n, kernel_ms = per_call(op, record)
        plain_ms, plain_n, _ = per_call(plain, None)
        rows.append(dict(label=args.label, case=case, precision=p,
                         op_ms=op_ms, records=n, kernel_ms=kernel_ms,
                         plain_ms=plain_ms, plain_records=plain_n, ok=ok))
        print(f"{args.label}: {case} precision {p}: op {op_ms:.4f} ms in "
              f"{n:g} records a call, kernel record {kernel_ms:.4f} ms; "
              f"plain op {plain_ms:.4f} ms in {plain_n:g} records; "
              f"{'bit-equal' if ok else 'NOT bit-equal'} to the plain op",
              flush=True)
    out = ROOT / "chiprun_out" / f"cordic_op_sweep-{args.label}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    if not all(r["ok"] for r in rows):
        smoke.fail("an op disagreed with its plain version")


if __name__ == "__main__":
    main()
