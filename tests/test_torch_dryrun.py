"""PyTorch port: the dry-run's shape cells and ``launch/dryrun.py``.

* every arch's cells equal the JAX package's: names, kinds, ``skip``,
  ``note`` and the inputs' names, shapes and dtypes (``sds``), and
  ``ASSIGNED``;
* one full-width cell per family traced at the 16 x 16 production mesh in
  a subprocess (fake process group of 256 ranks): the record has JAX's
  fields, each rank's parameter bytes equal the shards of JAX's specs, the
  mosso cell's state bytes equal JAX's ``new_state`` (4 more: the port's
  ``step_no`` is an int64) and its dense step is traced: FLOPs 0, bytes,
  a peak, one 4-byte all-reduce;
* at a 1-rank mesh the traced FLOPs equal ``FlopCounterMode`` over the
  same step run on real CPU tensors (GraphSAGE, SASRec), and the
  predicted bytes equal the real tensors' (the CPU form of
  ``chip_smoke.py`` phase 18(a)); the mosso cell's traced bytes, peak
  and collectives equal the tracer's counts over its step on real CPU
  tensors.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.launch.roofline import no_collectives  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"
sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_dist import jax_params, jax_specs_by_path  # noqa: E402


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return jnp.dtype(dt).name


def _inputs(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        if hasattr(v, "shape"):
            out[k] = (tuple(v.shape), _dtype_name(v.dtype))
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("arch", sorted(JAX_REGISTRY))
def test_cells_equal_jax(arch):
    jspec, spec = JAX_REGISTRY[arch], REGISTRY[arch]
    assert [c.name for c in spec.cells] == [c.name for c in jspec.cells]
    jcfg, cfg = jspec.make_config(), spec.make_config()
    for jc, c in zip(jspec.cells, spec.cells):
        assert (c.kind, c.skip, c.note) == (jc.kind, jc.skip, jc.note)
        assert _inputs(c.inputs(cfg)) == _inputs(jc.inputs(jcfg))
        assert spec.cell(c.name) is c


def test_registry_and_assigned_equal_jax():
    assert port_configs.ASSIGNED == jax_configs.ASSIGNED
    assert sum(len(s.cells) for s in REGISTRY.values()) == 41
    with pytest.raises(KeyError):
        REGISTRY["sasrec"].cell("train_4k")


_FULL_WIDTH = r"""
import json, sys
from repro_torch.launch import dryrun
out = {}
for arch, shape in (("internlm2-20b", "prefill_32k"),
                    ("internlm2-20b", "long_500k"),
                    ("graphsage-reddit", "minibatch_lg"),
                    ("sasrec", "train_batch"),
                    ("mosso-stream", "stream_batch")):
    out[arch + "/" + shape] = dryrun.run_cell(arch, shape, verbose=False)
sys.argv = ["dryrun", "--arch", "sasrec", "--shape", "serve_p99"]
dryrun.main()
out["path"] = str(dryrun._cache_path("sasrec", "serve_p99", False))
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def full_width():
    proc = subprocess.run([sys.executable, "-c", _FULL_WIDTH],
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def _shard_bytes(arch, names=("data", "model"), sizes=(16, 16)):
    """Each rank's parameter bytes under JAX's specs."""
    size = dict(zip(names, sizes))
    total = 0
    dtypes = {}
    _, params = jax_params(arch)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        dtypes[key] = jnp.dtype(leaf.dtype).itemsize
    for key, (shape, spec) in jax_specs_by_path(arch, names, sizes).items():
        n = 1
        for d, dim in enumerate(shape):
            entry = spec[d] if d < len(spec) else None
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            for a in axes:
                dim //= size[a]
            n *= dim
        total += n * dtypes[key]
    return total


@pytest.mark.parametrize("cell", [
    "internlm2-20b/prefill_32k", "graphsage-reddit/minibatch_lg",
    "sasrec/train_batch", "mosso-stream/stream_batch"])
def test_full_width_cell_per_family(full_width, cell):
    r = full_width[cell]
    assert r["status"] == "ok" and r["chips"] == 256
    for key in ("kind", "memory", "cost", "collectives", "roofline",
                "note"):
        assert key in r
    arch = cell.split("/")[0]
    mem = r["memory"]
    if arch == "mosso-stream":
        from repro.core.engine.state import new_state
        cfg = JAX_REGISTRY[arch].make_config()
        st = jax.eval_shape(lambda: new_state(cfg))
        want = sum(int(np.prod(l.shape)) * jnp.dtype(l.dtype).itemsize
                   for l in jax.tree.leaves(st))
        # the port keeps step_no's uint32 in an int64 (torch has no uint32
        # arithmetic on the CPU): 4 bytes more
        assert st.step_no.dtype == jnp.uint32
        assert mem["state_bytes"] == want + 4
        # the dense step traced on each rank's replica: no matrix product,
        # bytes moved, the state updated in place (the peak at least the
        # arguments), and one all-reduce of the int32 phi
        assert r["cost"]["flops"] == 0.0
        assert r["cost"]["bytes_accessed"] > mem["argument_size_in_bytes"]
        assert mem["peak_bytes"] >= mem["argument_size_in_bytes"]
        assert r["collectives"] == dict(no_collectives(), **{"all-reduce": 4})
        assert r["roofline"]["dominant"] == "memory"
        assert "one trip" in r["note"] and "8-slot window" in r["note"]
        return
    assert mem["params_bytes"] == _shard_bytes(arch)
    assert mem["peak_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert r["cost"]["flops"] > 0 and r["cost"]["bytes_accessed"] > 0
    assert r["roofline"]["dominant"] in ("compute", "memory", "collective")
    if arch == "sasrec":
        # the AdamW moments are two float32 copies of the parameters
        assert mem["opt_state_bytes"] == 2 * mem["params_bytes"] + 4
        # seq, pos, neg: int32 [65536, 50] over the 16 data ranks
        assert mem["inputs_bytes"] == 3 * 65536 * 50 * 4 // 16


def test_skipped_cell_and_the_cli(full_width):
    r = full_width["internlm2-20b/long_500k"]
    assert r["status"] == "skipped" and "full-attention" in r["note"]
    path = Path(full_width["path"])
    assert path.parts[-3:] == ("build", "dryrun", "sasrec__serve_p99__pod1.json")
    assert json.loads(path.read_text())["status"] == "ok"


_ONE_RANK = r"""
import json, sys
import torch
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import REGISTRY
from repro_torch.launch import dryrun, mesh as M
from repro_torch.launch.steps import build
mesh = M.make_host_mesh()
arch, shape = sys.argv[1], sys.argv[2]
spec = REGISTRY[arch]
cell = spec.cell(shape)
rec = dryrun.run_cell(arch, shape, mesh=mesh, smoke=True, verbose=False)
fn, args, _, _ = build(spec, cell, mesh, smoke=True)
gen = torch.Generator().manual_seed(0)
def real(t):
    if t.dtype == torch.bool:
        return torch.rand(t.shape, generator=gen) < 0.9
    if t.dtype in (torch.int32, torch.int64):
        # ids below every class, item and node count
        return torch.randint(0, 4, t.shape, generator=gen, dtype=t.dtype)
    return torch.randn(t.shape, generator=gen).to(t.dtype)
import torch.utils._pytree as pytree
real_args = pytree.tree_map(lambda t: real(t) if isinstance(t, torch.Tensor)
                            else t, args)
nbytes = sum(t.numel() * t.element_size()
             for t in pytree.tree_leaves(real_args)
             if isinstance(t, torch.Tensor))
with FlopCounterMode(display=False) as fc:
    fn(*real_args)
print("RESULT " + json.dumps(dict(rec=rec, flops=fc.get_total_flops(),
                                  nbytes=nbytes)))
"""


@pytest.mark.parametrize("arch,shape", [("graphsage-reddit", "minibatch_lg"),
                                        ("sasrec", "train_batch")])
def test_one_rank_trace_equals_the_real_step(arch, shape):
    proc = subprocess.run([sys.executable, "-c", _ONE_RANK, arch, shape],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads([l for l in proc.stdout.splitlines()
                      if l.startswith("RESULT ")][-1][len("RESULT "):])
    rec = out["rec"]
    assert rec["chips"] == 1 and rec["status"] == "ok"
    assert rec["cost"]["flops"] == out["flops"] > 0
    assert rec["memory"]["argument_size_in_bytes"] == out["nbytes"]
    assert sum(rec["collectives"].values()) == 0


_MOSSO_ONE_RANK = r"""
import json
import torch
from repro_torch.configs import REGISTRY
from repro_torch.core.engine.state import new_state
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun, mesh as M
from repro_torch.launch.roofline import LocalStepMode
from repro_torch.launch.steps import build, state_leaves
mesh = M.make_host_mesh()
spec = REGISTRY["mosso-stream"]
cell = spec.cell("stream_batch")
rec = dryrun.run_cell("mosso-stream", "stream_batch", mesh=mesh, smoke=True,
                      verbose=False)
fn, args, in_specs, _ = build(spec, cell, mesh, smoke=True)
cfg = spec.make_smoke_config()
b = cfg.batch
u = torch.arange(b, dtype=torch.int32)[None]
state = {k: v[None].clone()
         for k, v in state_leaves(new_state(cfg, "cpu")).items()}
real = (state, u, u + b, torch.ones((1, b), dtype=torch.bool))
dargs = tuple(shd.distribute(a, s, mesh) for a, s in zip(real, in_specs))
mode = LocalStepMode()
mode.track(dargs)
with torch.no_grad(), mode:
    fn(*dargs)
c = mode.counts
print("RESULT " + json.dumps(dict(rec=rec, bytes=c.bytes_accessed,
                                  flops=c.flops, peak=c.peak,
                                  collectives=c.collectives,
                                  phi=int(state["phi"][0]),
                                  edges=int(state["num_edges"][0]))))
"""


def test_mosso_one_rank_trace_equals_the_dense_step_on_cpu_tensors():
    """At a 1-rank mesh the mosso cell's traced bytes, FLOPs, peak and
    collectives equal the same counter over the same step (the dense step
    at ``ONE_TRIP``, then the all-reduce) run on real CPU tensors, whose
    probe runs the plain version through the same op: the trace on meta
    tensors is the step's."""
    proc = subprocess.run([sys.executable, "-c", _MOSSO_ONE_RANK],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads([l for l in proc.stdout.splitlines()
                      if l.startswith("RESULT ")][-1][len("RESULT "):])
    rec = out["rec"]
    assert rec["chips"] == 1 and rec["status"] == "ok"
    assert rec["cost"]["bytes_accessed"] == out["bytes"] > 0
    assert rec["cost"]["flops"] == out["flops"] == 0
    assert rec["memory"]["peak_bytes"] == out["peak"]
    assert rec["collectives"] == out["collectives"]
    assert rec["collectives"]["all-reduce"] == 4
    # one trip of the change loop: the first insert went in, alone
    assert out["edges"] == 1 and out["phi"] == 1
