#!/usr/bin/env python3
"""Crash consistency on the card: ``chip_smoke.py``'s phases 13-14 alone.

    timeout 1100 python3 tools/recovery_check.py

Builds the probe and intern kernels, then runs ``chip_smoke.py``'s phase
3 (the batched summarizer at ``full_config()`` over the stream of
``chip_smoke.NODES`` BA nodes: phase 13's stream and its baseline us
per change), phase 13 (batched kill, recover and fallback at full width,
each chunk of the journaled run also timed beside an unjournaled twin),
phase 11 (``ShardedSummarizer(full_config(), n_shards=4)``) with phase
14(a) on its live state (one save of ~5.6 GiB and a restore), phase
14(b) (the smoke kill-at-every-boundary bar, card and CPU) and phase
14(c) (``launch.summarize_stream``).  Each phase fails the run as it does
there.  Checkpoints go under ``build/chip_smoke_ckpt/`` (about 6 GiB of
free disk at the peak, phase 14(a)) and are removed; the results go to
``build/recovery_check.json``.
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
        print("recovery_check: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.kernels import _build, ht_probe, intern
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    chip_smoke.log(f"card: {smi}; torch {torch.__version__}")
    _build.build_all([ht_probe.SOURCE, intern.SOURCE])
    path_res, bs, _, _, stream = chip_smoke.main_path(chip_smoke.NODES, 4, 0)
    del bs
    torch.cuda.empty_cache()
    out = dict(card=smi, batched_us_per_change=path_res["us_per_change"])
    out["batched_recovery"] = chip_smoke.batched_recovery(
        stream, path_res["step_s"], 0, twin=True)
    sharded, ss, sharded_stream = chip_smoke.sharded_path(
        chip_smoke.NODES, 4, 0)
    out["sharded_us_per_change"] = sharded["us_per_change"]
    out["sharded_checkpoint"] = chip_smoke.sharded_checkpoint(
        ss, sharded_stream, 0)
    del ss
    torch.cuda.empty_cache()
    out["sharded_kill_bar"] = chip_smoke.sharded_kill_bar(0)
    out["summarize_stream"] = chip_smoke.summarize_stream_driver()
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "recovery_check.json").write_text(
        json.dumps(out, indent=1, default=str))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
