#!/usr/bin/env python3
"""Quick check of the hash-probe kernel on one GPU.

    timeout 600 python3 tools/probe_check.py [--time] [--tiles 1,16,32]
        [--baseline DIR]
    timeout 1500 python3 tools/probe_check.py --engine --baseline DIR
        [--pairs 10] [--changes 768] [--device cpu --config smoke]
        [--profile]

Builds ``src/repro_torch/csrc/ht_probe.cu`` (printing ``nvcc``'s register
and spill lines), then holds it to its plain torch version, bitwise:
tables of caps 8, 16 and 32 (half live with tombstones, full with and
without tombstones, random words), 2^20-slot tables at 53% and 70%
occupancy at 1 to 16384 lanes, sentinel query keys among the garbage
lanes, ``ht_probe_many`` over jobs of mixed caps and modes in one launch
and in two, and a stacked ``[4, 2^20]`` table.

``--time`` also checks it the same way on 2^25-slot tables at 53% and
70% occupancy, prints its device time (CUDA-graph replay) and call time
from Python at 1, 160, 16384, 2^16, 2^18 and 2^20 lanes in both modes,
beside the word and sector bounds, and splits the host's cost of a
one-lane call into its parts.  ``--tiles 1,16,32`` adds builds with
other tile widths, each from a copy of the source in ``build/`` with its
``kTile`` constant rewritten, to the checks and the times.  ``--baseline
DIR`` adds another checkout's probe kernel and wrapper
(``DIR/src/repro_torch/kernels/ht_probe.py`` and its
``csrc/ht_probe.cu``; for instance the parent commit unpacked with ``git
archive`` into ``build/``) the same way, so that versions are compared
in one process on one card.

It takes a few minutes, so it is the first thing to run on the card after
an edit of the kernel; ``chip_smoke.py`` phase 2 is the full check.
Exits non-zero on a mismatch and without a CUDA device.

``--engine --baseline DIR [--pairs 10] [--changes 768]`` instead holds
the batched engine above the kernel against the baseline's:
``BatchedSummarizer(full_config(), device="cuda")`` (``--device cpu
--config smoke`` rehearse it on the CPU) over the first ``--changes``
changes of ``chip_smoke.py``'s phase-3 stream (BA 600 nodes, m 4, fully
dynamic, seed 0), one fresh process per run, the two trees in
alternating pairs (baseline, this; this, baseline; ...), each building
its own probe kernel.  Per run: us per change (host clock around each
``process`` call of one batch, ended by a device sync), probe launches
and host syncs per change, and a checksum of the state's leaves, which
must be equal across the runs.  It prints one JSON line per run, each
pair's this / baseline ratio, their median and how many pairs this tree
lost, and writes ``build/engine_ab.json``; ``--profile`` runs each tree
once more under ``cProfile`` and prints its 40 costliest functions by
own time.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIME_LANES = (1, 160, 16384, 1 << 16, 1 << 18, 1 << 20)
CHECK_CAP = 1 << 20
CAP = 1 << 25
TILE_LINE = "constexpr int kTile = 8;"


def wrapper(module: Path, source: Path, name: str):
    """``ht_probe_cuda`` of the wrapper at ``module``, loaded under
    another module name, with its kernel built from ``source``."""
    spec = importlib.util.spec_from_file_location(name, module)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SOURCE = source
    return mod.ht_probe_cuda


def tile_source(width: int) -> Path:
    """A copy of ``csrc/ht_probe.cu`` in ``build/`` with ``kTile`` set to
    ``width``."""
    from repro_torch.kernels import _build, ht_probe
    text = ht_probe.SOURCE.read_text()
    if text.count(TILE_LINE) != 1:
        raise RuntimeError(f"{ht_probe.SOURCE.name} lost {TILE_LINE!r}")
    out = _build.BUILD_DIR / "probe_tiles" / f"ht_probe_tile{width}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text.replace(TILE_LINE,
                                f"constexpr int kTile = {width};"))
    return out


def variants(tiles, base) -> dict:
    """``{name: probe(tables, q1, q2, prehashed, mode)}``: the shipped
    kernel, then each other tile width's build through this wrapper
    (one ``nvcc`` for each, started together), then the baseline's."""
    from repro_torch.kernels import _build, ht_probe
    fns = {"tile 8": ht_probe.ht_probe_cuda}
    sources = {w: tile_source(w) for w in tiles}
    built = _build.build_all(list(sources.values()))
    for w, src in sources.items():
        print(f"built the tile {w} variant")
        for line in built[src][1].strip().splitlines():
            print(f"  nvcc: {line.strip()}")
        fns[f"tile {w}"] = wrapper(Path(ht_probe.__file__), src,
                                   f"ht_probe_tile{w}")
    if base is not None:
        fns["baseline"] = wrapper(
            base / "src" / "repro_torch" / "kernels" / "ht_probe.py",
            base / "src" / "repro_torch" / "csrc" / "ht_probe.cu",
            "baseline_ht_probe")
    return {name: (lambda tables, q1, q2, pre, mode, fn=fn: fn(
        *tables, q1, q2, prehashed=pre, mode=mode))
        for name, fn in fns.items()}


def check_tables(probes, tables_by_key, lane_counts, gen) -> None:
    """Each variant against the plain version at every (load, mode,
    lanes) of the given tables, bitwise."""
    from chip_smoke import check_equal, queries
    from repro_torch.kernels.ht_probe import ht_probe_plain
    for (load, pre), tables in tables_by_key.items():
        for mode in ("find", "insert"):
            for lanes in lane_counts:
                q1, q2 = queries(tables, lanes, gen)
                want = ht_probe_plain(*tables, q1, q2, prehashed=pre,
                                      mode=mode)
                for name, probe in probes.items():
                    check_equal(probe(tables, q1, q2, pre, mode), want,
                                f"{name} load={load} mode={mode} "
                                f"prehashed={pre} lanes={lanes}")
    print(f"ok   {', '.join(probes)} == plain on {len(tables_by_key)} "
          f"table(s) at lanes {list(lane_counts)}", flush=True)


def time_variants(probes, tables_by_key, gen) -> None:
    from chip_smoke import bound_ms, cuda_ms, graph_ms, queries, sector_ms
    for (load, pre), tables in tables_by_key.items():
        for mode in ("find", "insert"):
            for lanes in TIME_LANES:
                q1, q2 = queries(tables, lanes, gen)
                reps = 200 if lanes <= 16384 else 20
                line = []
                for name, probe in probes.items():
                    def launch(probe=probe):
                        return probe(tables, q1, q2, pre, mode)
                    dev_us = 1e3 * graph_ms(launch, reps)
                    call_us = 1e3 * cuda_ms(launch, reps)
                    line.append(f"{name} {dev_us:8.2f} us (call "
                                f"{call_us:6.2f})")
                bound_us = 1e3 * bound_ms(tables, q1, q2, pre)
                sector_us = 1e3 * sector_ms(tables, q1, q2, pre)
                print(f"load {load} {mode:6s} lanes={lanes:8d}: "
                      + "; ".join(line) + f"; bound {bound_us:.3f} us, "
                      f"sectors {sector_us:.3f} us", flush=True)


def host_split(tables, gen, n: int = 2000) -> None:
    """Host microseconds per call of each part of a one-lane probe (the
    main path's commonest job), by the host clock over ``n`` calls: the
    checks, the output allocation (as shipped, and as views of one
    buffer), the descriptor, the current device and stream, the bare
    launch, then the whole wrapper, ``ops.ht_probe`` and
    ``hashtable.ht_lookup``."""
    import torch
    from chip_smoke import queries
    from repro_torch.core.engine import hashtable
    from repro_torch.kernels import _build, ht_probe, ops
    lib = _build.load(ht_probe.SOURCE, ht_probe._bind)
    q1, q2 = queries(tables, 1, gen)
    job = ht_probe.ProbeJob(*tables, q1, q2, False, "find")
    dev = q1.device
    slot, found, val = ht_probe.ht_probe_cuda(*job[:5])
    blob = ht_probe._JOB.pack(*(t.data_ptr() for t in job[:5]),
                              slot.data_ptr(), found.data_ptr(),
                              val.data_ptr(), tables[0].shape[0], 1, 0, 0)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    table = hashtable.HashTable(*tables)

    def one_buffer(m=1):
        buf = torch.empty(2 * m + (m + 3) // 4, dtype=torch.int32,
                          device=dev)
        return (buf[:m], buf[2 * m:].view(torch.uint8)[:m].view(torch.bool),
                buf[m:2 * m])

    parts = (
        ("checks", lambda: ht_probe._check_job(job, dev)),
        ("outputs: three torch.empty (shipped)", lambda: (
            torch.empty(1, dtype=torch.int32, device=dev),
            torch.empty(1, dtype=torch.bool, device=dev),
            torch.empty(1, dtype=torch.int32, device=dev))),
        ("outputs: one buffer and views", one_buffer),
        ("descriptor: data_ptr + struct.pack", lambda: ht_probe._JOB.pack(
            *(t.data_ptr() for t in job[:5]), slot.data_ptr(),
            found.data_ptr(), val.data_ptr(), tables[0].shape[0], 1, 0, 0)),
        ("current device and stream", lambda: (
            torch.cuda.current_device(),
            torch._C._cuda_getCurrentRawStream(dev.index))),
        ("bare launch (ctypes + cudaLaunchKernel)",
         lambda: lib.ht_probe_launch(blob, 1, 1, stream)),
        ("ht_probe_cuda", lambda: ht_probe.ht_probe_cuda(*job[:5])),
        ("ops.ht_probe", lambda: ops.ht_probe(*job[:5])),
        ("hashtable.ht_lookup (1 lane)",
         lambda: hashtable.ht_lookup(table, q1, q2)),
    )
    for name, fn in parts:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        print(f"host split: {name:42s} {1e6 * dt / n:7.2f} us/call",
              flush=True)


ENGINE_RUN = r"""
import cProfile, io, json, pstats, sys, time, zlib
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.configs import mosso_stream
from repro_torch.core.engine import BatchedSummarizer
from repro_torch.core.engine.ops import host_read
from repro_torch.core.engine.state import state_to_numpy
from repro_torch.graph.streams import (barabasi_albert_edges,
                                       edges_to_fully_dynamic_stream)
from repro_torch.kernels import ops
stream = edges_to_fully_dynamic_stream(
    barabasi_albert_edges(600, 4, 0), delete_prob=0.1,
    seed=0)[:int(sys.argv[2])]
cfg = getattr(mosso_stream, sys.argv[4] + "_config")()
dev = sys.argv[3]
sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
bs = BatchedSummarizer(cfg, device=dev)
bs.process(stream[:cfg.batch])           # builds the kernel, warms up
sync()
ops.reset_counts()
host_read.count = 0
prof = cProfile.Profile() if sys.argv[5] == "profile" else None
t = time.perf_counter()
if prof:
    prof.enable()
for off in range(cfg.batch, len(stream), cfg.batch):
    bs.process(stream[off:off + cfg.batch])
sync()
dt = time.perf_counter() - t
if prof:
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(40)
    print(text.getvalue())
n = len(stream) - cfg.batch
crc = 0
for k, v in sorted(state_to_numpy(bs.state).items()):
    for w in (v.values() if isinstance(v, dict) else (v,)):
        crc = zlib.crc32(w.tobytes(), crc)
print(json.dumps(dict(changes=n, us_per_change=1e6 * dt / n,
                      launches_per_change=ops.ht_probe.launches / n,
                      syncs_per_change=host_read.count / n,
                      phi=bs.phi, crc=crc)))
"""


def engine_ab(args) -> int:
    """``--engine``: this tree's batched engine against ``--baseline``'s,
    in alternating pairs of fresh processes (the module docstring)."""
    trees = {"baseline": args.baseline.resolve() / "src",
             "this": ROOT / "src"}
    card = args.device
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    order = []
    for i in range(args.pairs):
        order += [("baseline", "this"), ("this", "baseline")][i % 2]
    if args.profile:
        order += ["baseline", "this"]
    runs = []
    for i, name in enumerate(order):
        mode = "profile" if i >= 2 * args.pairs else "time"
        out = subprocess.run([sys.executable, "-c", ENGINE_RUN,
                              str(trees[name]), str(args.changes),
                              args.device, args.config, mode],
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            print(out.stdout, out.stderr, file=sys.stderr)
            return 1
        lines = out.stdout.strip().splitlines()
        res = dict(json.loads(lines[-1]), tree=name, pair=i // 2,
                   profiled=mode == "profile")
        if res["profiled"]:
            print(f"engine: {name} under cProfile\n" + "\n".join(lines[:-1]))
        print(json.dumps(res), flush=True)
        runs.append(res)
    if len({r["crc"] for r in runs}) != 1:
        print("engine: the trees' states differ", file=sys.stderr)
        return 1
    timed = [r for r in runs if not r["profiled"]]
    us = {(r["pair"], r["tree"]): r["us_per_change"] for r in timed}
    ratios = [us[p, "this"] / us[p, "baseline"] for p in range(args.pairs)]
    med = {name: statistics.median(r["us_per_change"] for r in timed
                                   if r["tree"] == name) for name in trees}
    print(f"engine: {args.pairs} pairs, this / baseline per pair "
          + ", ".join(f"{x:.3f}" for x in ratios)
          + f"; median ratio {statistics.median(ratios):.3f}, this slower "
          f"in {sum(x > 1 for x in ratios)} of {args.pairs}; median us per "
          f"change baseline {med['baseline']:.1f}, this {med['this']:.1f}; "
          f"states equal ({card})")
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "engine_ab.json").write_text(
        json.dumps(dict(card=card, runs=runs, ratios=ratios, median=med),
                   indent=1))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", action="store_true",
                    help="check on 2^25-slot tables and time every build")
    ap.add_argument("--tiles", default="",
                    help="other tile widths to build, check and time "
                         "beside the shipped 8, e.g. 1,16,32")
    ap.add_argument("--baseline", type=Path,
                    help="a checkout whose probe kernel (with --engine: "
                         "engine) to hold and time beside this one")
    ap.add_argument("--engine", action="store_true",
                    help="time the batched engine against --baseline's "
                         "instead")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--changes", type=int, default=768)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", choices=["full", "smoke"], default="full")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if args.engine:
        if args.baseline is None:
            ap.error("--engine needs --baseline")
        return engine_ab(args)
    import torch
    if not torch.cuda.is_available():
        print("probe_check: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import (LOADS, bulk_table, multi_job_vs_plain,
                            stacked_vs_plain, tiny_tables, tiny_vs_plain)
    from repro_torch.kernels import _build, ht_probe
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    t0 = time.perf_counter()
    (_, text), = _build.build_all([ht_probe.SOURCE]).values()
    print(f"built {ht_probe.SOURCE.name} (tile 8) in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in text.strip().splitlines():
        print(f"  nvcc: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)

    tiny = tiny_tables(gen)
    tiny_vs_plain(tiny, gen)
    print(f"ok   {len(tiny)} tiny tables (caps 8/16/32) == plain", flush=True)
    scale = CHECK_CAP / CAP
    tables = {(load, False): bulk_table(
        CHECK_CAP, int((live + tomb) * scale), int(tomb * scale), False,
        gen)[0] for load, (live, tomb) in LOADS.items()}
    probes = variants([int(w) for w in args.tiles.split(",") if w],
                      args.baseline)
    check_tables(probes, tables, (1, 7, 160, 16384), gen)
    multi_job_vs_plain(tables, tiny, gen)
    stacked_vs_plain(gen)
    if args.time:
        del tables
        big = {(load, False): bulk_table(CAP, live + tomb, tomb, False,
                                         gen)[0]
               for load, (live, tomb) in LOADS.items()}
        check_tables(probes, big, TIME_LANES, gen)
        host_split(big["53%", False], gen)
        time_variants(probes, big, gen)
    print(f"probe_check: every case matches its plain version ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
