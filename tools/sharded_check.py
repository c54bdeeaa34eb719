#!/usr/bin/env python3
"""The sharded summarizer on the card, beside the batched one: a short run.

    timeout 900 python3 tools/sharded_check.py

Builds the probe kernel, then runs ``chip_smoke.py``'s phase 3 (the
batched summarizer at ``full_config()``), its phase 11
(``ShardedSummarizer(full_config(), n_shards=4)``) over the same stream
of ``chip_smoke.NODES`` BA nodes, and its phase 12 (the router's paths
card vs CPU and ``serve_summary``), so that the two paths' us per change come from
one card in one call.  Each phase fails the run as it does there.
Writes the results to ``build/sharded_check.json``.
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
        print("sharded_check: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.kernels import _build, ht_probe
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    chip_smoke.log(f"card: {smi}; torch {torch.__version__}")
    _build.build_all([ht_probe.SOURCE])
    out = dict(card=smi,
               batched=chip_smoke.main_path(chip_smoke.NODES, 4, 0)[0])
    torch.cuda.empty_cache()
    out["sharded"] = chip_smoke.sharded_path(chip_smoke.NODES, 4, 0)[0]
    torch.cuda.empty_cache()
    out["router_paths"] = chip_smoke.sharded_router_paths(0)
    sh, ba = out["sharded"], out["batched"]
    chip_smoke.log(
        f"sharded / batched us per change: "
        f"{sh['us_per_change'] / ba['us_per_change']:.3f} (later: "
        f"{sh['later_us_per_change'] / ba['later_us_per_change']:.3f})")
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "sharded_check.json").write_text(
        json.dumps(out, indent=1, default=str))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
