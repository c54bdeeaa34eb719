#!/usr/bin/env python3
"""MLA serving on the card: ``chip_smoke.py``'s phase 17 alone.

    timeout 600 python3 tools/mla_check.py

Builds the flash-attention kernels (printing ``nvcc``'s register and
spill lines), then runs phase 17: (a) the kernel at ``d_v != d_q``
against its plain version at minicpm3-4b's smoke and full widths, timed
at its layer; (b) its full widths at 2 layers, card vs CPU; (c) one
``full_config()`` prefill (62 launches of the ``mla`` variant); (d) the
serve loop at full config; (e) the smoke config card vs CPU.  Each fails
the run as it does there; the results go to ``build/mla_check.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mla_check: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build, flash_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.log(f"card: {smi}; torch {torch.__version__}")
    (_, text), = _build.build_all([flash_attention.SOURCE]).values()
    for line in text.strip().splitlines():
        if "mla" in line or "spill" in line or "registers" in line:
            cs.log(f"  nvcc: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = dict(card=smi, **cs.mla_serving(0, gen))
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "mla_check.json").write_text(
        json.dumps(out, indent=1, default=str))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
