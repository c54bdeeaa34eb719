#!/usr/bin/env python3
"""Training on the card: ``chip_smoke.py``'s phase 16 alone.

    timeout 900 python3 tools/train_check.py

Builds the CSR kernel, runs ``chip_smoke.py``'s phase 7 (one
graphsage-reddit request on the Reddit-sized graph, whose padded batch
phase 16 trains on), then phase 16: (a) the CSR backward against plain
autograd, (b) SASRec ``full_config()`` training and serving, (c)
GraphSAGE ``full_config()`` training, (d) ``launch.train`` and its
restarts.  Each fails the run as it does there; the results go to
``build/train_check.json``.
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
        print("train_check: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.kernels import _build, csr_segment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    chip_smoke.log(f"card: {smi}; torch {torch.__version__}")
    _build.build_all([csr_segment.SOURCE])
    gen = torch.Generator(device="cuda").manual_seed(0)
    sage, batch = chip_smoke.graphsage_request(0)
    out = dict(card=smi, graphsage=sage)
    out["csr_backward"] = chip_smoke.csr_backward_vs_plain(batch, gen)
    out["sasrec_training"] = chip_smoke.sasrec_training(0)
    torch.cuda.empty_cache()
    out["graphsage_training"] = chip_smoke.graphsage_training(batch, 0)
    del batch
    out["train_launcher"] = chip_smoke.train_launcher()
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "train_check.json").write_text(
        json.dumps(out, indent=1, default=str))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
