#!/usr/bin/env python3
"""The sharded summarizer on the card, beside the batched one: a short run.

    timeout 900 python3 tools/sharded_check.py [--no-batched] [--no-modes]
        [--mesh-only]

Builds the probe and intern kernels, then runs ``chip_smoke.py``'s
stacked probe check of phase 2 (a ``[4, 2^20]`` table as row jobs and
as one stacked job), its phase 3 (the batched summarizer at
``full_config()``; skipped with ``--no-batched``), its phase 11 (``ShardedSummarizer(full_config(),
n_shards=4)``, the card's default ``replica_exec="vmap"``) over the same
stream of ``chip_smoke.NODES`` BA nodes, its phase 19 (``"map"`` and
``"vmap"`` side by side, leaf-bitwise) and phase 20 (the same changes
over a mesh of positions: the first 4 cards, or ``["cuda:0"] * 4`` on a
host of one; leaf-bitwise to phase 19's run; both skipped with
``--no-modes``) and its phase 12 (the router's paths card vs CPU and
``serve_summary``), so that the paths' us per change come from one card
in one call.  ``--mesh-only`` runs phases 19 and 20 alone, on phase 11's
stream built without running phase 11 (on a four-card host, the mesh's
four cards).  Each phase fails the run as it does there.  Writes the
results to ``build/sharded_check.json``.
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
    from repro_torch.kernels import _build, ht_probe, intern
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    chip_smoke.log(f"card: {smi}; torch {torch.__version__}")
    _build.build_all([ht_probe.SOURCE, intern.SOURCE])
    chip_smoke.load_rates()
    out = dict(card=smi, device_count=torch.cuda.device_count())
    if "--mesh-only" in sys.argv:
        from repro_torch.graph.streams import (barabasi_albert_edges,
                                               edges_to_fully_dynamic_stream)
        stream = edges_to_fully_dynamic_stream(
            barabasi_albert_edges(chip_smoke.NODES, 4, 0), delete_prob=0.1,
            seed=0)[:chip_smoke.SHARDED_CHANGES]
        out["modes"], snapshots = chip_smoke.replica_exec_modes(stream)
        out["mesh"] = chip_smoke.mesh_path(stream, snapshots, out["modes"])
        return finish(out, smi)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out["stacked"] = chip_smoke.stacked_vs_plain(gen)
    torch.cuda.empty_cache()
    if "--no-batched" not in sys.argv:
        out["batched"] = chip_smoke.main_path(chip_smoke.NODES, 4, 0)[0]
        torch.cuda.empty_cache()
    out["sharded"], ss, stream = chip_smoke.sharded_path(chip_smoke.NODES,
                                                         4, 0)
    del ss
    torch.cuda.empty_cache()
    if "--no-modes" not in sys.argv:
        out["modes"], snapshots = chip_smoke.replica_exec_modes(stream)
        out["mesh"] = chip_smoke.mesh_path(stream, snapshots, out["modes"])
        del snapshots
        torch.cuda.empty_cache()
    out["router_paths"] = chip_smoke.sharded_router_paths(0)
    sh, ba = out["sharded"], out.get("batched")
    if ba:
        chip_smoke.log(
            f"sharded / batched us per change: "
            f"{sh['us_per_change'] / ba['us_per_change']:.3f} (later: "
            f"{sh['later_us_per_change'] / ba['later_us_per_change']:.3f})")
    return finish(out, smi)


def finish(out: dict, smi: str) -> int:
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "sharded_check.json").write_text(
        json.dumps(out, indent=1, default=str))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
