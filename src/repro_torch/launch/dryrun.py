"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on the CPU
(port of ``repro/launch/dryrun.py``).

For each cell this shows, without a card:
  * the layout is coherent: the step runs under DTensor with every
    parameter, optimizer moment and input laid out by the sharding rules
    on the production mesh (16 x 16, or 2 x 16 x 16 with ``--multi-pod``),
    each rank's shards ``meta`` tensors in one process over a fake process
    group (``launch/mesh.py``);
  * what one rank holds: the exact bytes of its parameters, optimizer
    state and inputs, from the local shapes, and the peak of its live
    bytes while its local step runs (``launch/roofline.py``'s tracer: the
    port's counterpart of XLA's ``memory_analysis()``);
  * the roofline terms of that step: FLOPs by FlopCounterMode's formulas
    over the rank's local ops, bytes accessed, and the bytes of the
    collectives DTensor issues.

The step traced is the plain path that the CPU runs (as JAX's host
dry-run lowers the reference off a TPU): the hand-written kernels take
CUDA tensors only.  Attention takes the card's route, and the kernel
route's plain version visits the causal tiles the kernel visits, so the
cell's ``note`` says which.  The mosso cell's step reads the host (the
engine's trial loop), so it is not traced: its state bytes are exact and
its one ``phi`` all-reduce is counted, its FLOPs are reported as not
traced.

Results are written incrementally under ``build/dryrun/`` so the sweep is
resumable.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--force] [--jobs N]
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.configs import ASSIGNED, REGISTRY
from repro_torch.launch.mesh import chips, make_production_mesh
from repro_torch.launch.roofline import (LocalStepMode, no_collectives,
                                         roofline_terms)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

ATTENTION_NOTE = ("attention traced on the card's route: the reference "
                  "under autograd, with a bias or at T not a multiple of "
                  "128 (every score), else the kernel's plain version, "
                  "which visits the causal tiles the kernel visits")
MOSSO_NOTE = ("FLOPs not traced: the engine's step reads the host (its "
              "trial loop), so it cannot run on meta tensors; the state "
              "bytes are exact and the one phi all-reduce is counted")


def _tensors(tree) -> list:
    import torch.utils._pytree as pytree
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def local_bytes(tree) -> int:
    """Bytes of the shards one rank holds of a tree of DTensors (or of
    plain tensors)."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in _tensors(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        total += t.numel() * t.element_size()
    return total


def _bring_back(out, specs, mesh):
    """Redistribute the outputs to their layout (JAX's out_shardings)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.dist import sharding as shd
    if specs is None:
        return out
    if isinstance(out, dict):
        return {k: _bring_back(v, specs[k], mesh) for k, v in out.items()}
    if hasattr(out, "_fields"):
        return type(out)(*(_bring_back(v, s, mesh)
                           for v, s in zip(out, specs)))
    if isinstance(out, (list, tuple)):
        return type(out)(_bring_back(v, s, mesh) for v, s in zip(out, specs))
    if isinstance(out, DTensor):
        want = tuple(shd.placements(specs, mesh))
        if tuple(out.placements) != want:
            return out.redistribute(mesh, want)
    return out


def _memory(spec, cell, dargs, peak: int, out) -> dict:
    """Each rank's bytes: arguments by part, outputs, and the traced peak
    (``temp_size_in_bytes`` is the peak above the arguments)."""
    parts = {"params_bytes": dargs[0]}
    rest = list(dargs[1:])
    if cell.kind == "train":
        parts["opt_state_bytes"] = rest.pop(0)
    if cell.kind == "decode":
        parts["cache_bytes"] = rest.pop(0)
    if spec.family == "mosso":
        parts = {"state_bytes": dargs[0]}
    parts["inputs_bytes"] = tuple(rest)
    mem = {k: local_bytes(v) for k, v in parts.items()}
    args = sum(mem.values())
    mem["argument_size_in_bytes"] = args
    if peak is not None:
        mem["peak_bytes"] = peak
        mem["temp_size_in_bytes"] = peak - args
        mem["output_size_in_bytes"] = local_bytes(out)
    return mem


def _trace(spec, cell, mesh, smoke: bool, **kw):
    """Run one rank's step under the tracer; returns its counts and the
    memory record."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.dist import annotate
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.steps import build

    fn, args, in_specs, out_specs = build(spec, cell, mesh, smoke, **kw)
    dargs = tuple(shd.distribute(a, s, mesh) for a, s in zip(args, in_specs))
    mode = LocalStepMode()
    mode.track(dargs)
    grad = (contextlib.nullcontext() if cell.kind == "train"
            else torch.no_grad())
    # no collection while tracing: a tensor in a reference cycle stays live
    # until a collection, whose timing would move the peak
    gc.collect()
    gc.disable()
    try:
        with implicit_replication(), mode, grad:
            out = _bring_back(fn(*dargs), out_specs, mesh)
    finally:
        gc.enable()
        annotate.clear_mesh()
    c = mode.counts
    return c, _memory(spec, cell, dargs, c.peak, out)


def _extrapolate(one: dict, two: dict, n: int) -> dict:
    """``one + (n - 1) * (two - one)`` over matching numeric leaves: the
    counts of an ``n``-layer stack from its 1- and 2-layer traces."""
    if isinstance(one, dict):
        return {k: _extrapolate(one[k], two[k], n) for k in one}
    return one + (n - 1) * (two - one)


def _counted(c, mem) -> dict:
    return dict(flops=c.flops, bytes_accessed=c.bytes_accessed,
                collectives=dict(c.collectives), peak=mem["peak_bytes"],
                out=mem["output_size_in_bytes"])


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             allow_skipped: bool = False, verbose: bool = True,
             mesh=None, smoke: bool = False) -> dict:
    """Trace one cell on ``mesh`` (default the production mesh) and return
    its record.  An LM stack deeper than 2 layers is traced at 1 and 2
    layers and its counts extrapolated to its depth (its layers are
    identical, so FLOPs, bytes, collectives and the peak grow by the same
    amount each layer); its argument bytes come from the full depth."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.steps import build

    spec = REGISTRY[arch]
    cell = spec.cell(shape)
    tag = f"{arch}/{shape}/{'pod2' if multi_pod else 'pod1'}"
    if cell.skip and not allow_skipped:
        return dict(arch=arch, shape=shape, multi_pod=multi_pod,
                    status="skipped", note=cell.note)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    notes = [cell.note] if cell.note else []
    t0 = time.time()
    depth = None
    if spec.family == "lm" and not smoke:
        depth = spec.make_config().n_layers
    if spec.family == "mosso" or (depth is not None and depth > 2):
        _, args, in_specs, _ = build(spec, cell, mesh, smoke)
        dargs = tuple(shd.distribute(a, s, mesh)
                      for a, s in zip(args, in_specs))
        mem = _memory(spec, cell, dargs, None, None)
        del args, dargs
    fallback = {}
    if spec.family == "mosso":
        # the one phi all-reduce: an int32 scalar per rank
        coll = dict(no_collectives(), **{"all-reduce": 4})
        cost = dict(flops=None, bytes_accessed=None)
        terms = None
        notes.append(MOSSO_NOTE)
    else:
        if depth is not None and depth > 2:
            traced = []
            for n in (1, 2):
                c, m = _trace(spec, cell, mesh, smoke, n_layers=n)
                traced.append(_counted(c, m))
                for k, v in c.fallback_ops.items():
                    fallback[k] = fallback.get(k, 0) + v
            got = _extrapolate(traced[0], traced[1], depth)
            mem["peak_bytes"] = got["peak"]
            mem["temp_size_in_bytes"] = got["peak"] - \
                mem["argument_size_in_bytes"]
            mem["output_size_in_bytes"] = got["out"]
            notes.append(f"counts extrapolated to {depth} layers from "
                         f"traces at 1 and 2")
        else:
            c, mem = _trace(spec, cell, mesh, smoke)
            got = _counted(c, mem)
            fallback = dict(c.fallback_ops)
        coll = got["collectives"]
        cost = dict(flops=float(got["flops"]),
                    bytes_accessed=float(got["bytes_accessed"]))
        terms = roofline_terms({"flops": cost["flops"],
                                "bytes accessed": cost["bytes_accessed"]},
                               coll, chips(mesh))
        if spec.family in ("lm", "recsys"):
            notes.append(ATTENTION_NOTE)
    t_trace = time.time() - t0

    res = dict(arch=arch, shape=shape, multi_pod=multi_pod, status="ok",
               kind=cell.kind, chips=chips(mesh), t_trace_s=round(t_trace, 1),
               memory=mem, cost=cost, collectives=coll, roofline=terms,
               replicated_ops=fallback, note="; ".join(notes))
    if verbose:
        per_dev = mem.get("peak_bytes", mem["argument_size_in_bytes"]) / 1e9
        dom = terms["dominant"] if terms else "n/a"
        print(f"[{tag}] ok trace={t_trace:.0f}s mem/rank={per_dev:.2f}GB "
              f"dominant={dom}"
              + (f" t=({terms['t_compute']:.2e},{terms['t_memory']:.2e},"
                 f"{terms['t_collective']:.2e})s" if terms else ""),
              flush=True)
    return res


def _cache_path(arch, shape, multi_pod) -> Path:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    return RESULTS_DIR / f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}.json"


def _run_child(arch: str, shape: str, multi_pod: bool) -> None:
    """One cell in a process of its own (a process holds one group)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape] + (["--multi-pod"] if multi_pod else [])
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        if line.startswith("["):
            print(line, flush=True)
    if proc.returncode != 0:
        print(f"[{arch}/{shape}] ERROR exit {proc.returncode}", flush=True)
        _cache_path(arch, shape, multi_pod).write_text(json.dumps(dict(
            arch=arch, shape=shape, multi_pod=multi_pod, status="error",
            error=f"exit {proc.returncode}", tb=proc.stderr[-2000:]),
            indent=1))


def run_all(multi_pod: bool, force: bool = False, archs=None,
            jobs: int = 1) -> None:
    """Every cell of ``archs`` (default ``ASSIGNED``), skipping those with
    a record unless ``force``.  ``jobs`` > 1 runs that many cells at once,
    each in a process of its own: DTensor plans redistributions over the
    3-D multi-pod mesh slowly (a graph search per op), so an LM cell there
    takes 2-45 minutes to trace, and the sweep hours in one process."""
    archs = archs or ASSIGNED
    todo = []
    for arch in archs:
        for cell in REGISTRY[arch].cells:
            if _cache_path(arch, cell.name, multi_pod).exists() and not force:
                print(f"[{arch}/{cell.name}] cached")
            else:
                todo.append((arch, cell.name))
    if jobs > 1:
        with ThreadPoolExecutor(jobs) as pool:
            for _ in pool.map(lambda c: _run_child(*c, multi_pod), todo):
                pass
        return
    for arch, shape in todo:
        try:
            res = run_cell(arch, shape, multi_pod)
        except Exception as e:  # record failures, keep sweeping
            res = dict(arch=arch, shape=shape, multi_pod=multi_pod,
                       status="error", error=f"{type(e).__name__}: {e}",
                       tb=traceback.format_exc()[-2000:])
            print(f"[{arch}/{shape}] ERROR {e}", flush=True)
        _cache_path(arch, shape, multi_pod).write_text(
            json.dumps(res, indent=1))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--allow-full-attn-500k", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --all: cells traced at once, each in its "
                         "own process")
    args = ap.parse_args()
    if args.all:
        t0 = time.time()
        run_all(args.multi_pod, args.force, jobs=args.jobs)
        print(f"sweep: {time.time() - t0:.1f} s, {args.jobs} job(s)")
        return
    res = run_cell(args.arch, args.shape, args.multi_pod,
                   allow_skipped=args.allow_full_attn_500k)
    _cache_path(args.arch, args.shape, args.multi_pod).write_text(
        json.dumps(res, indent=1))
    print(json.dumps({k: v for k, v in res.items() if k != "tb"}, indent=1))


if __name__ == "__main__":
    main()
