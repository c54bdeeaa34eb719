#!/usr/bin/env python3
"""The CSR segment-reduce kernel on one GPU: ``chip_smoke.py``'s phase 6
and the GraphSAGE request's layer-1 and backward launches, beside the
kernel's first design (a warp per row and 128-column tile, commit
``a4482fb``) timed in the same process.

    python3 tools/csr_check.py            # once without a card: extracts
                                          # the first design, then stops
    timeout 900 python3 tools/csr_check.py [--variant NAME:CONST=VAL,...]
        [--shape NAME,N,E,F] [--e2e] [--train]

Without a card it only writes the first design's ``csr_segment.cu``
into ``build/csr_first/`` (from git history: run it once in a checkout
with its ``.git``, then on a machine with the card, which needs only
the file) and exits non-zero.
On the card it builds ``src/repro_torch/csrc/csr_segment.cu``, the first
design's source and each ``--variant`` (a copy of the shipped source in
``build/csr_variants/`` with the named ``constexpr`` constants rewritten,
e.g. ``w4:kWarps=4`` or ``d2:kDepth=2``), one ``nvcc`` each,
started together, and prints each kernel's registers and spills.  Then:

1. ``chip_smoke.py`` phase 6: the shipped kernel against its plain
   version at every ``CSR_SHAPES`` row (sum rtol = atol = 1e-5, min/max
   bitwise, the same ±inf pattern), timed beside the bounds;
2. phase 7 (one graphsage-reddit request, held to the CPU), whose padded
   batch gives the layer-1 layout (F 128) and, transposed, the backward's;
3. every build (the first design's and the variants) held to the plain
   version the same way at each ``CSR_SHAPES`` row and both request
   launches;
4. every build's device time (CUDA-graph replay) at each ``CSR_SHAPES``
   row's first reduce and the two request launches, in turns (first,
   shipped, variants, then the reverse order), each time the mean of its
   two turns, beside the bounds and the achieved rate over the gather
   scale's bytes;
5. with ``--shape``, more rows; with ``--e2e``, the GraphSAGE forward
   and training step with each of the two kernels swapped in; with
   ``--train``, phase 16(a) and (c).

Results go to ``build/csr_check.json``.  Exits non-zero on a mismatch,
a failed build, and without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FIRST_COMMIT = "a4482fb"           # the kernel's first design
FIRST_SOURCE = ROOT / "build" / "csr_first" / "csr_segment.cu"
VARIANT_DIR = ROOT / "build" / "csr_variants"
KERNEL_NAME = re.compile(r"(csr_[a-z]+_kernel)I((?:Li-?\d+E)+)")


def first_source() -> Path:
    """The first design's source, written from git history at first use."""
    if not FIRST_SOURCE.exists():
        text = subprocess.run(
            ["git", "show",
             f"{FIRST_COMMIT}:src/repro_torch/csrc/csr_segment.cu"],
            cwd=ROOT, capture_output=True, text=True, check=True).stdout
        FIRST_SOURCE.parent.mkdir(parents=True, exist_ok=True)
        FIRST_SOURCE.write_text(text)
    return FIRST_SOURCE


def variant_source(spec: str) -> tuple:
    """``(name, path)`` of a copy of the shipped source with the constants
    of ``NAME:CONST=VAL,...`` rewritten."""
    from repro_torch.kernels import csr_segment
    name, _, assigns = spec.partition(":")
    text = csr_segment.SOURCE.read_text()
    for assign in filter(None, assigns.split(",")):
        const, _, value = assign.partition("=")
        pat = re.compile(rf"(constexpr \w+ {re.escape(const)} = )[^;]+;")
        if len(pat.findall(text)) != 1:
            raise SystemExit(f"csr_check: no single constant {const!r}")
        text = pat.sub(rf"\g<1>{value};", text)
    out = VARIANT_DIR / f"csr_segment_{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return name, out


def kernel_lines(nvcc_out: str) -> list:
    """``name<template args>: N registers, spills`` per kernel."""
    lines, name = [], None
    for line in nvcc_out.splitlines():
        if "Compiling entry function" in line:
            m = KERNEL_NAME.search(line)
            name = (f"{m.group(1)}<"
                    + ",".join(re.findall(r"-?\d+", m.group(2))) + ">"
                    if m else line.split("'")[1])
        elif name and ("spill" in line or "Used" in line):
            lines.append(f"{name}: {line.split(':', 2)[-1].strip()}")
    return lines


def occupancy(source: Path, lines: list, f: int, x) -> dict:
    """The shipped kernel's residency at one width, from its source's
    constants and ptxas' registers: blocks an SM (by registers, shared
    memory and warps) and the gathered bytes a warp and an SM can hold in
    flight (the ring's slots; a narrow row's 32 lanes)."""
    from repro_torch.kernels.csr_segment import launch_plan
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", source.read_text())}
    plan = launch_plan(f, x.data_ptr())
    vec, warps = plan.vec, const["kWarps"]
    if plan.lanes < 32:
        kernel, slot, depth, smem = (f"csr_narrow_kernel<0,{vec},"
                                     f"{plan.lanes}>", 128 * vec, 1, 0)
    else:
        slot = plan.slots * 32 * 4 * vec
        depth = max(1, min(const["kRingBytes"] // slot, const["kDepth"]))
        smem = 0 if vec == 1 else warps * depth * slot
        kernel = f"csr_wide_kernel<0,{vec},{plan.slots}>"
    regs = next(int(m.group(1)) for line in lines
                if line.startswith(kernel + ":")
                for m in [re.search(r"Used (\d+) registers", line)] if m)
    per_block = -(-regs // 8) * 8 * 32 * warps
    blocks = min(65536 // per_block, 233472 // (smem + 1024), 64 // warps,
                 32)
    return dict(kernel=kernel, registers=regs, smem_bytes=smem,
                blocks_per_sm=blocks, warps_per_sm=blocks * warps,
                depth=depth, slot_bytes=slot,
                in_flight_per_sm=blocks * warps * depth * slot)


def first_launcher(lib):
    """The first design's entry point: no launch plan."""
    import torch
    from repro_torch.kernels.csr_segment import REDUCES
    lib.csr_segment_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.csr_segment_launch.restype = ctypes.c_int

    def run(senders, row_off, x, reduce):
        n_out = row_off.numel() - 1
        out = torch.empty((n_out, x.shape[1]), dtype=torch.float32,
                          device=x.device)
        err = lib.csr_segment_launch(
            senders.data_ptr(), row_off.data_ptr(), x.data_ptr(),
            out.data_ptr(), n_out, x.shape[0], senders.numel(), x.shape[1],
            REDUCES.index(reduce), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the first design: CUDA error {err}")
        return out
    return run


def shipped_launcher(lib):
    from repro_torch.kernels import csr_segment
    csr_segment._bind(lib)
    return lambda s, r, x, reduce: csr_segment.launch(lib, s, r, x, reduce)


def end_to_end(batch, fns) -> dict:
    """The graphsage-reddit ``full_config()`` forward (CUDA events over
    20) and AdamW training step (host clock with a synchronize, median of
    5) on the request's batch, with the graph ops' kernel swapped between
    the first design's and the shipped one, in turns (first, shipped,
    shipped, first)."""
    import numpy as np
    import torch
    from chip_smoke import cuda_ms, log
    from repro_torch.configs.graphsage_reddit import full_config
    from repro_torch.kernels import ops
    from repro_torch.models.gnn import gnn_forward, gnn_loss, init_gnn
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    cfg = full_config()
    n = batch.node_feat.shape[0]
    labels = np.random.default_rng(3).integers(0, cfg.n_classes, n)
    batch = batch._replace(labels=torch.from_numpy(
        labels.astype(np.int32)).cuda())
    params = init_gnn(cfg, 0, device="cuda")
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=1000)
    step = make_train_step(lambda p, g: gnn_loss(p, g, cfg), opt_cfg)
    keep = ops.csr_segment_cuda
    res = {"first": [], "shipped": []}
    try:
        for name in ("first", "shipped", "shipped", "first"):
            ops.csr_segment_cuda = fns[name]
            with torch.no_grad():
                fwd = cuda_ms(lambda: gnn_forward(params, batch, cfg), 20)
            p, opt, times = params, adamw.init(params, opt_cfg), []
            for _ in range(6):
                torch.cuda.synchronize()
                t = time.perf_counter()
                p, opt, _ = step(p, opt, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            res[name].append(dict(forward_ms=fwd, step_ms=1e3 * sorted(
                times[1:])[2]))
    finally:
        ops.csr_segment_cuda = keep
    for name, turns in res.items():
        log(f"end to end with {name}'s kernel: forward " + ", ".join(
            f"{t['forward_ms']:.3f}" for t in turns) + " ms; training step "
            + ", ".join(f"{t['step_ms']:.2f}" for t in turns) + " ms")
    return res


def cases(gen, batch, extra=()):
    """``(name, layout, x, reduce)``: each ``CSR_SHAPES`` row's first
    reduce and each ``extra`` ``(name, n, e, f)``'s sum on uniform random
    edges, then the request's layer 1 and its backward (random values on
    the request's layouts)."""
    import torch
    import chip_smoke
    from repro_torch.kernels import ops
    shapes = list(chip_smoke.CSR_SHAPES) + [(*x, ("sum",)) for x in extra]
    for name, n, e, f, reduces in shapes:
        s = torch.randint(0, n, (e,), generator=gen, device="cuda",
                          dtype=torch.int32)
        r = torch.randint(0, n, (e,), generator=gen, device="cuda",
                          dtype=torch.int32)
        x = torch.randn((n, f), generator=gen, device="cuda")
        yield f"{name} F {f}", ops.csr_layout(s, r, n), x, reduces[0]
        del s, r, x
    n = batch.node_feat.shape[0]
    layout = ops.csr_layout(batch.senders, batch.receivers, n,
                            batch.edge_mask)
    yield ("request layer 1 F 128", layout,
           torch.randn((n, 128), generator=gen, device="cuda"), "sum")
    yield ("backward layer 1 F 128", layout.transposed(n),
           torch.randn((n, 128), generator=gen, device="cuda"), "sum")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME:CONST=VAL,... (repeatable)")
    ap.add_argument("--train", action="store_true",
                    help="also phase 16(a) and (c)")
    ap.add_argument("--shape", action="append", default=[],
                    help="also NAME,N,E,F (sum, uniform random edges)")
    ap.add_argument("--e2e", action="store_true",
                    help="the GraphSAGE forward and training step with "
                         "each of the first design's and the shipped kernel")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    first = first_source()
    import torch
    if not torch.cuda.is_available():
        print(f"csr_check: wrote {first.relative_to(ROOT)}; no CUDA device "
              f"is visible", file=sys.stderr)
        return 2
    import chip_smoke
    from chip_smoke import close, csr_bound_ms, graph_ms, log
    from repro_torch.kernels import _build, csr_segment
    from repro_torch.kernels.csr_segment import csr_segment_plain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    sources = {"shipped": csr_segment.SOURCE, "first": first}
    sources.update(variant_source(v) for v in args.variant)
    for src in sources.values():         # built anew, for ptxas' report
        _build.library_path(src).unlink(missing_ok=True)
    t = time.perf_counter()
    built = _build.build_all(list(sources.values()))
    log(f"build: {len(built)} sources in {time.perf_counter() - t:.1f} s")
    fns, ptxas = {}, {}
    for name, src in sources.items():
        path, nvcc_out = built[src]
        lines = kernel_lines(nvcc_out)
        ptxas[name] = lines
        regs = [int(m) for m in re.findall(r"Used (\d+) registers",
                                           "\n".join(lines))]
        frames = [int(m) for m in re.findall(r"(\d+) bytes stack frame",
                                             "\n".join(lines))]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores",
                                             "\n".join(lines))]
        if regs:
            log(f"  {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
                f"registers, stack frames up to {max(frames)} bytes, "
                f"spill stores up to {max(spills)} bytes")
        lib = ctypes.CDLL(str(path))
        fns[name] = (first_launcher(lib) if name == "first" else
                     shipped_launcher(lib))
    out = dict(card=smi, torch=torch.__version__,
               build={k: str(built[v][0].name) for k, v in sources.items()},
               ptxas=ptxas)

    gen = torch.Generator(device="cuda").manual_seed(0)
    out["phase6"], _ = chip_smoke.csr_vs_plain(gen)
    sage, batch = chip_smoke.graphsage_request(0)
    out["graphsage"] = sage

    order = ["first", "shipped"] + [n for n in fns if n not in
                                   ("first", "shipped")]
    rows = []
    extra = [(name, int(n), int(e), int(f)) for name, n, e, f in
             (spec.split(",") for spec in args.shape)]
    for case, layout, x, reduce in cases(gen, batch, extra):
        xin = x
        for red in ("sum", "min", "max"):    # each build held to plain
            want = csr_segment_plain(*layout, xin, red)
            for name in order:
                close(fns[name](*layout, xin, red), want, red,
                      what=f"{name} at {case}")
            del want
        big = layout.senders.numel() > 10 ** 7
        reps = 3 if big else 20
        times = {name: [] for name in order}
        for name in order + order[::-1]:
            times[name].append(graph_ms(
                lambda: fns[name](*layout, xin, reduce), reps, 3))
        bound, gather = csr_bound_ms(layout, xin)
        shape = (layout.row_off.numel() - 1, xin.shape[1])
        zeros = graph_ms(lambda: torch.zeros(shape, device="cuda"), reps, 3)
        row = dict(case=case, reduce=reduce, bound_ms=bound,
                   gather_bound_ms=gather, zeros_ms=zeros,
                   ms={k: sum(v) / len(v) for k, v in times.items()},
                   turns=times)
        if "shipped" in ptxas:
            row["occupancy"] = occ = occupancy(
                sources["shipped"], ptxas["shipped"], xin.shape[1], xin)
            log(f"  {occ['kernel']}: {occ['registers']} registers, "
                f"{occ['smem_bytes']} B of ring a block, "
                f"{occ['warps_per_sm']} warps an SM, {occ['depth']} slots "
                f"of {occ['slot_bytes']} B a warp: up to "
                f"{occ['in_flight_per_sm'] / 1024:.0f} KB in flight an SM")
        rows.append(row)
        log(f"{case} {reduce}: bound {bound * 1e3:.1f} us, gather scale "
            f"{gather * 1e3:.1f} us, torch.zeros of out "
            f"{zeros * 1e3:.1f} us; " + "; ".join(
                f"{k} {v * 1e3:.1f} us ({100 * bound / v:.0f}% of the "
                f"bound, {100 * gather / v:.0f}% of the gather scale, "
                f"{gather / v * 3.35:.2f} TB/s)"
                for k, v in row["ms"].items()))
        del layout, x, xin
        torch.cuda.empty_cache()
    out["rows"] = rows
    if args.e2e:
        out["end_to_end"] = end_to_end(batch, fns)
    if args.train:
        out["csr_backward"] = chip_smoke.csr_backward_vs_plain(batch, gen)
        out["graphsage_training"] = chip_smoke.graphsage_training(batch, 0)
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "csr_check.json").write_text(
        json.dumps(out, indent=1, default=str))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
