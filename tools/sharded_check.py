#!/usr/bin/env python3
"""The sharded summarizer on the card, beside the batched one: a short run.

    timeout 900 python3 tools/sharded_check.py [--no-batched] [--no-modes]

Builds the probe kernel, then runs ``chip_smoke.py``'s stacked probe
check of phase 2 (a ``[4, 2^20]`` table as row jobs and as one stacked
job), its phase 3 (the batched summarizer at ``full_config()``; skipped
with ``--no-batched``), its phase 11 (``ShardedSummarizer(full_config(),
n_shards=4)``, the card's default ``replica_exec="vmap"``) over the same
stream of ``chip_smoke.NODES`` BA nodes, its phase 19 (``"map"`` and
``"vmap"`` side by side, leaf-bitwise; skipped with ``--no-modes``) and
its phase 12 (the router's paths card vs CPU and ``serve_summary``), so
that the paths' us per change come from one card in one call.  Each
phase fails the run as it does there.  Writes the results to
``build/sharded_check.json``.
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
    chip_smoke.load_rates()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = dict(card=smi, stacked=chip_smoke.stacked_vs_plain(gen))
    torch.cuda.empty_cache()
    if "--no-batched" not in sys.argv:
        out["batched"] = chip_smoke.main_path(chip_smoke.NODES, 4, 0)[0]
        torch.cuda.empty_cache()
    out["sharded"], ss, stream = chip_smoke.sharded_path(chip_smoke.NODES,
                                                         4, 0)
    del ss
    torch.cuda.empty_cache()
    if "--no-modes" not in sys.argv:
        out["modes"] = chip_smoke.replica_exec_modes(stream)
    out["router_paths"] = chip_smoke.sharded_router_paths(0)
    sh, ba = out["sharded"], out.get("batched")
    if ba:
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
