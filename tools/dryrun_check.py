#!/usr/bin/env python3
"""The dry-run against the card: ``chip_smoke.py``'s phase 18 alone.

    timeout 900 python3 tools/dryrun_check.py [--nodes N]

Builds the kernels, runs the phases whose tensors phase 18(a) holds the
dry-run to: phase 3's ``BatchedSummarizer(full_config())`` over a BA
stream of ``--nodes`` nodes (default 100: the state's bytes do not depend
on the stream), phase 7 (one graphsage-reddit request, whose padded batch
16(c) trains on), 16(b) (SASRec ``full_config()`` training) and 16(c)
(GraphSAGE), then phase 18: (a) the dry-run at a 1-rank mesh against
those phases' bytes and FLOPs, (b) ``compressed_psum`` over NCCL, (c) the
full-width ``train_4k`` cells at 16 x 16 in a subprocess.  Each fails the
run as it does there; the results go to ``build/dryrun_check.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("dryrun_check: no CUDA device is visible", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=100)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.kernels import _build, csr_segment, ht_probe
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    chip_smoke.log(f"card: {smi}; torch {torch.__version__}")
    _build.build_all([ht_probe.SOURCE, csr_segment.SOURCE])
    path_res, bs, *_ = chip_smoke.main_path(args.nodes, 4, 0)
    del bs
    torch.cuda.empty_cache()
    _, batch = chip_smoke.graphsage_request(0)
    sasrec = chip_smoke.sasrec_training(0)
    torch.cuda.empty_cache()
    sage = chip_smoke.graphsage_training(batch, 0)
    del batch
    torch.cuda.empty_cache()
    out = dict(card=smi, dryrun=chip_smoke.dryrun_vs_card(
        chip_smoke.dryrun_card(path_res, sage, sasrec), 0))
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "dryrun_check.json").write_text(
        json.dumps(out, indent=1, default=str))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
