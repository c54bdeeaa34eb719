#!/usr/bin/env python3
"""The engine's dense step on the card beside its branching step: a short
run.

    timeout 900 python3 tools/dense_check.py [--changes 8,16]

Builds the probe kernel, then runs ``chip_smoke.py``'s phase 21 (the
dense step, ``trial.step_fn(..., dense=True)``, and the branching step at
``full_config()``, each from the state after phase 3's first batch, over
the next N changes of its stream as one batch, leaf-bitwise on the card)
once for each N of ``--changes`` (default ``chip_smoke.DENSE_CHANGES``),
and phase 18(a)'s one-trip dense step (the mosso dry-run cell's trip
setting: its peak memory, ms and FLOPs).  Each phase fails the run as it does there.
Writes the results to ``build/dense_check.json``.
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
        print("dense_check: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.graph.streams import (barabasi_albert_edges,
                                           edges_to_fully_dynamic_stream)
    from repro_torch.kernels import _build, ht_probe

    counts = [chip_smoke.DENSE_CHANGES]
    if "--changes" in sys.argv:
        counts = [int(x) for x in
                  sys.argv[sys.argv.index("--changes") + 1].split(",")]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    chip_smoke.log(f"card: {smi}; torch {torch.__version__}")
    _build.build_all([ht_probe.SOURCE])
    stream = edges_to_fully_dynamic_stream(
        barabasi_albert_edges(chip_smoke.NODES, 4, 0), delete_prob=0.1,
        seed=0)
    out = dict(card=smi, forms={})
    for n in counts:
        chip_smoke.DENSE_CHANGES = n
        out["forms"][n] = chip_smoke.dense_step_forms(stream)
    out["one_trip"] = chip_smoke.dense_one_trip(stream)
    chip_smoke.log(f"one-trip dense step (the dry-run's setting): "
                   f"{out['one_trip']}")
    path = ROOT / "build" / "dense_check.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
