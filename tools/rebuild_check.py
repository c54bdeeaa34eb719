#!/usr/bin/env python3
"""The rebuild kernel on the card: a short run of its checks and times.

    timeout 900 python3 tools/rebuild_check.py [--no-big]

Builds the probe and rebuild kernels (printing ``nvcc``'s register and
spill lines for ``csrc/ht_rebuild.cu``), runs
``tests/test_torch_rebuild_card.py`` (the kernel against the sequential
fold on clustered, random and full tables), then ``chip_smoke.py``'s
phase 15(a) (the kernel against the fold on every table of that phase,
the clustered 2^20 table timed) and, unless ``--no-big``, phase 15(b)
on phase 2's two 2^25-slot tables at 70% and a 2^24-slot one (device
times of the kernel and of the whole call beside the byte bound).  Each
phase fails the run as it does there.  Writes the results to
``build/rebuild_check.json``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("rebuild_check: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build, ht_probe, ht_rebuild

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.log(f"card: {smi}; torch {torch.__version__}")
    cs.load_rates()
    built = _build.build_all([ht_probe.SOURCE, ht_rebuild.SOURCE])
    for line in built[ht_rebuild.SOURCE][1].strip().splitlines():
        cs.log(f"  nvcc: {line.strip()}")
    rc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         str(ROOT / "tests" / "test_torch_rebuild_card.py")],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    ).returncode
    if rc != 0:
        return rc
    out = dict(card=smi, a=cs.rebuild_kernel_vs_plain(0))
    if "--no-big" not in sys.argv:
        gen = torch.Generator(device="cuda").manual_seed(0)
        big = {}
        for pre in (False, True):
            big["2^25", pre], _ = cs.bulk_table(
                cs.CAP, *cs.rebuild_counts(cs.CAP, "70%"), pre, gen)
        out["b"] = cs.rebuild_full_size(big, gen)
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "rebuild_check.json").write_text(
        json.dumps(out, indent=1, default=str))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
