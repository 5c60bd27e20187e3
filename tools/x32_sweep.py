"""Time the fused GEMM's x32 mode (FxP24/32 codes in int32) on the card at
the shapes `chip_smoke.py` holds it to, in any checkout.

    python3 tools/x32_sweep.py [--src DIR] [--record NAME] [--label NAME]

Runs `chip_smoke.x32_gemm_phase`: Qwen2.5-14B's decode GEMMs, a 16-row
prefill chunk and w1 + SiLU on FxP32 codes, w1 + SiLU on FxP24 codes and
codes at the ends of int32 at w2's shape, each bit-equal to its plain
version and timed by the profiler records of the x32 kernel (`--record`,
`fxp_gemm_tc_kernel` by default), beside torch.matmul on the codes cast
to f32. `--src DIR` imports `repro_torch` from DIR instead, for example an
older checkout's `src` unpacked beside this one, so that two kernels are
timed in one call on one card (then `--record` names its kernel's record,
`fxp_gemm_x32_kernel` for the CUDA-core kernel that ran the mode before
the tensor cores did). Prints one line a shape and writes the rows to
chiprun_out/x32_sweep-<label>.json. Needs one CUDA card and nvcc.
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None,
                    help="import repro_torch from this directory")
    ap.add_argument("--record", default="fxp_gemm_tc_kernel",
                    help="the x32 kernel's profiler record")
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        smoke.fail("no CUDA card: this sweep times kernels on a GPU")
    if args.src:
        sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import build as kbuild
    built = kbuild.build(("fxp_gemm",))
    print(f"card: {smoke.card_line()}; repro_torch from "
          f"{Path(kbuild.__file__).parents[2]}; "
          + " | ".join(ln.strip() for ln in built["fxp_gemm"][2].splitlines()
                       if "registers" in ln), flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(10)
    rows = smoke.x32_gemm_phase(dev, gen, record=args.record)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"x32_sweep-{args.label}.json").write_text(json.dumps(
        {"card": smoke.card_line(), "label": args.label, "src": args.src,
         "record": args.record, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
