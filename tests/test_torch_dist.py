"""PyTorch port: the sharding rules, annotation, int8 collectives and the
roofline terms against the JAX package.

* placements: for every registered arch with parameters, at the two
  production meshes (16 x 16 and 2 x 16 x 16), each leaf's spec from
  ``repro_torch.dist.sharding.tree_specs`` equals ``repro.dist.
  sharding.tree_specs`` (JAX's side needs no devices: ``guard_spec`` reads
  only the mesh's axis names and sizes, so a stand-in mesh serves), and,
  on a real ``DeviceMesh`` over a fake process group in a subprocess, each
  leaf's DTensor local shape equals the global shape divided by the axis
  sizes of JAX's spec;
* ``int8_quantize`` bitwise JAX's (ties included), and the assertions of
  ``tests/test_dist.py::test_data_parallel_wrapper_and_cache`` and
  ``::test_compressed_psum_error_bounded`` over 8 gloo ranks;
* ``annotate`` the identity without a mesh; ``roofline_terms`` on
  hand-made counts.
"""
import functools
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.dist import collectives as jax_coll  # noqa: E402
from repro.dist import sharding as jax_shd  # noqa: E402
from repro.launch import roofline as jax_roofline  # noqa: E402
from repro.models import gnn as jax_gnn  # noqa: E402
from repro.models import sasrec as jax_sasrec  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.dist import annotate, collectives, sharding  # noqa: E402
from repro_torch.launch import mesh as port_mesh, roofline  # noqa: E402
from repro_torch.models import gnn, sasrec, transformer  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"
ARCHS = [a for a, s in sorted(REGISTRY.items()) if s.family != "mosso"]
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def jax_mesh(names, sizes):
    """What ``guard_spec`` reads of a ``jax.sharding.Mesh``."""
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, sizes)))


def port_stand_in(names, sizes):
    return types.SimpleNamespace(mesh_dim_names=names, shape=sizes)


def _rules(family):
    return {"lm": "LM_RULES", "gnn": "GNN_RULES",
            "recsys": "RECSYS_RULES"}[family]


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    spec = JAX_REGISTRY[arch]
    cfg = spec.make_config()
    init = {"lm": jax_tfm.init_transformer, "gnn": jax_gnn.init_gnn,
            "recsys": jax_sasrec.init_sasrec}[spec.family]
    return cfg, jax.eval_shape(lambda k: init(cfg, k), jax.random.key(0))


def port_params(arch):
    spec = REGISTRY[arch]
    cfg = spec.make_config()
    init = {"lm": transformer.init_transformer, "gnn": gnn.init_gnn,
            "recsys": sasrec.init_sasrec}[spec.family]
    return cfg, init(cfg, device="meta")


def jax_specs_by_path(arch, names, sizes):
    """{path: (global shape, spec entries)} of JAX's ``tree_specs``."""
    cfg, params = jax_params(arch)
    fam = JAX_REGISTRY[arch].family
    kw = dict(fsdp_axes=cfg.fsdp_axes, is_moe=cfg.moe) if fam == "lm" else {}
    specs = jax_shd.tree_specs(params, getattr(jax_shd, _rules(fam)),
                               jax_mesh(names, sizes), **kw)
    shapes = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        key = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        out[key] = (tuple(shapes[path].shape), tuple(spec))
    return out


def port_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from port_leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from port_leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_specs_equal_jax(arch, mesh_name):
    names, sizes = MESHES[mesh_name]
    want = jax_specs_by_path(arch, names, sizes)
    cfg, params = port_params(arch)
    fam = REGISTRY[arch].family
    kw = dict(fsdp_axes=cfg.fsdp_axes, is_moe=cfg.moe) if fam == "lm" else {}
    specs = sharding.tree_specs(params, getattr(sharding, _rules(fam)),
                                port_stand_in(names, sizes), **kw)
    got = {p: (tuple(t.shape), s) for (p, t), (_, s) in zip(
        port_leaves(params), _spec_leaves(specs))}
    assert got == want


def _spec_leaves(specs, path=()):
    """(path, spec) of a spec tree (a spec is a tuple of entries)."""
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from _spec_leaves(v, path + (k,))
    elif isinstance(specs, list):
        for i, v in enumerate(specs):
            yield from _spec_leaves(v, path + (i,))
    else:
        yield path, specs


def test_moe_and_fsdp_overrides_are_in_the_cases():
    """The parametrised cases cover the expert overrides (moonshot's 64
    experts shard over 'model', granite's 40 do not divide) and
    llama3-405b's ``fsdp_axes``."""
    names, sizes = MESHES["2x16x16"]
    stand_in = port_stand_in(names, sizes)
    cfg, p = port_params("moonshot-v1-16b-a3b")
    spec = sharding.tree_specs(p, sharding.LM_RULES, stand_in,
                               fsdp_axes=cfg.fsdp_axes, is_moe=cfg.moe)
    assert spec["layers"]["w_gate"][1] == "model"        # the [E] dim
    assert spec["layers"]["w_down"][1] == "model"
    cfg, p = port_params("granite-moe-3b-a800m")         # 40 experts
    spec = sharding.tree_specs(p, sharding.LM_RULES, stand_in,
                               fsdp_axes=cfg.fsdp_axes, is_moe=cfg.moe)
    assert spec["layers"]["w_gate"][1] is None           # 40 % 16
    cfg, p = port_params("llama3-405b")
    spec = sharding.tree_specs(p, sharding.LM_RULES, stand_in,
                               fsdp_axes=cfg.fsdp_axes, is_moe=cfg.moe)
    assert spec["layers"]["q_proj"] == (None, ("pod", "data"), "model")


@pytest.mark.parametrize("case", [
    ((("data", "model"), None), (64, 32), "absent axis dropped"),
    (("data", "data"), (64, 64), "axis used twice"),
    (("model", None), (10, 4), "does not divide"),
    ((("pod", "data"), "model"), (64, 32), "both data axes"),
    (("model", "pod"), (1, 4), "size 1 dim"),
    ((), (8, 8), "empty spec"),
], ids=lambda c: c[2] if isinstance(c, tuple) else str(c))
def test_guard_spec_equal_jax(case):
    spec, shape, _ = case
    for names, sizes in MESHES.values():
        want = tuple(jax_shd.guard_spec(jax.sharding.PartitionSpec(*spec),
                                        shape, jax_mesh(names, sizes)))
        got = sharding.guard_spec(spec, shape, port_stand_in(names, sizes))
        assert got == want


_LOCAL_SHAPES = r"""
import json, sys
from repro_torch.configs import REGISTRY
from repro_torch.dist import sharding
from repro_torch.launch import mesh as M
from repro_torch.models import gnn, sasrec, transformer
multi = sys.argv[1] == "2x16x16"
mesh = M.make_production_mesh(multi_pod=multi)
out = {}
for arch, spec in sorted(REGISTRY.items()):
    if spec.family == "mosso":
        continue
    cfg = spec.make_config()
    init = {"lm": transformer.init_transformer, "gnn": gnn.init_gnn,
            "recsys": sasrec.init_sasrec}[spec.family]
    params = init(cfg, device="meta")
    rules = {"lm": sharding.LM_RULES, "gnn": sharding.GNN_RULES,
             "recsys": sharding.RECSYS_RULES}[spec.family]
    kw = (dict(fsdp_axes=cfg.fsdp_axes, is_moe=cfg.moe)
          if spec.family == "lm" else {})
    specs = sharding.tree_specs(params, rules, mesh, **kw)
    dt = sharding.distribute(params, specs, mesh)
    leaves = []
    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items(): walk(v, path + [k])
        elif isinstance(t, list):
            for i, v in enumerate(t): walk(v, path + [i])
        else:
            leaves.append([path, list(t.to_local().shape)])
    walk(dt, [])
    out[arch] = leaves
print(json.dumps(out))
"""


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_local_shapes_are_the_shards_of_jax_specs(mesh_name):
    proc = subprocess.run([sys.executable, "-c", _LOCAL_SHAPES, mesh_name],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    names, sizes = MESHES[mesh_name]
    size = dict(zip(names, sizes))
    for arch in ARCHS:
        want = jax_specs_by_path(arch, names, sizes)
        assert len(got[arch]) == len(want)
        for path, local in got[arch]:
            shape, spec = want[tuple(path)]
            expect = list(shape)
            for d, entry in enumerate(spec):
                axes = () if entry is None else (
                    (entry,) if isinstance(entry, str) else entry)
                for a in axes:
                    expect[d] //= size[a]
            assert local == expect, (arch, path)


# --------------------------------------------------------- int8 collectives


def _quant_inputs():
    rng = np.random.default_rng(0)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -126.5,
                     3.5, 0.0], np.float32)      # scale 1: exact halves
    return {
        "normal": rng.normal(size=(8, 64)).astype(np.float32),
        "ties": ties,
        "ties_scaled": ties * np.float32(0.25),
        "wide": (rng.normal(size=(4096,)) * 1e3).astype(np.float32),
        "zeros": np.zeros((16,), np.float32),
        "tiny": np.full((5,), 1e-20, np.float32),
    }


@pytest.mark.parametrize("name", list(_quant_inputs()))
def test_int8_quantize_bitwise_jax(name):
    x = _quant_inputs()[name]
    q, s = collectives.int8_quantize(torch.from_numpy(x))
    jq, js = jax_coll.int8_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    deq = collectives.int8_dequantize(q, s).numpy()
    np.testing.assert_array_equal(deq, np.asarray(
        jax_coll.int8_dequantize(jq, js)))
    assert np.max(np.abs(deq - x)) <= float(s) * 0.51 + 1e-6


def test_int8_quantize_bf16_bitwise_jax():
    x = np.random.default_rng(1).normal(size=(256,)).astype(np.float32)
    q, s = collectives.int8_quantize(torch.from_numpy(x).to(torch.bfloat16))
    jq, js = jax_coll.int8_quantize(jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()


_RANKS = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

def run(rank, world, path, out):
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=world)
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.collectives import (compressed_pmean,
        compressed_psum, int8_dequantize, int8_quantize)
    from repro_torch.launch.mesh import make_host_mesh
    res = {}
    x = torch.arange(64.0).reshape(8, 8)
    g = shd.data_parallel(lambda a: a * 2.0 + 1.0)
    res["dp"] = [g(x).tolist(), g(x).tolist()]
    h = shd.data_parallel(
        lambda t: t[0] + t[1] if isinstance(t, tuple) else t["a"] - t["b"])
    res["dp_tuple"] = h((x, x)).tolist()
    res["dp_dict"] = h({"a": x, "b": x}).tolist()
    mesh = make_host_mesh()
    res["embed_1d"] = list(shd.spec_for_leaf("embed", (64,), mesh,
                                             shd.LM_RULES))
    res["embed_0d"] = list(shd.spec_for_leaf("embed", (), mesh,
                                             shd.LM_RULES))
    xs = np.random.default_rng(0).normal(size=(8, 64)).astype(np.float32)
    q, s = int8_quantize(torch.from_numpy(xs[0]))
    res["q_err"] = float(torch.max(torch.abs(int8_dequantize(q, s)
                                             - torch.from_numpy(xs[0]))))
    res["q_scale"] = float(s)
    got = compressed_psum(torch.from_numpy(xs[rank]))
    want = xs.sum(axis=0)
    res["rel"] = float(np.max(np.abs(got.numpy() - want))
                       / (np.max(np.abs(want)) + 1e-9))
    res["mean_rel"] = float(np.max(np.abs(
        compressed_pmean(torch.from_numpy(xs[rank])).numpy() - want / 8))
        / (np.max(np.abs(want / 8)) + 1e-9))
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()

if __name__ == "__main__":
    mp.spawn(run, args=(8, sys.argv[1], sys.argv[2]), nprocs=8)
"""


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    script = d / "ranks.py"
    script.write_text(_RANKS)
    out = d / "out.json"
    proc = subprocess.run(
        [sys.executable, str(script), str(d / "store"), str(out)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


def test_data_parallel_wrapper_over_8_ranks(eight_ranks):
    """``tests/test_dist.py::test_data_parallel_wrapper_and_cache``'s
    assertions over 8 gloo ranks."""
    x = np.arange(64.0).reshape(8, 8)
    for got in eight_ranks["dp"]:
        np.testing.assert_allclose(got, x * 2 + 1)
    # distinct tree STRUCTURES with identical leaves stay distinct
    np.testing.assert_allclose(eight_ranks["dp_tuple"], 2 * x)
    np.testing.assert_allclose(eight_ranks["dp_dict"], np.zeros_like(x))
    # a leaf with FEWER dims than its rule takes the rule's TRAILING
    # entries: rank-1 'embed' gets the 'embed' (fsdp->data) entry
    assert eight_ranks["embed_1d"] == ["data"]
    assert eight_ranks["embed_0d"] == []


def test_compressed_psum_error_bounded_over_8_ranks(eight_ranks):
    """``tests/test_dist.py::test_compressed_psum_error_bounded``'s
    assertions over 8 gloo ranks."""
    assert eight_ranks["q_err"] <= eight_ranks["q_scale"] * 0.51 + 1e-6
    assert eight_ranks["rel"] < 0.02, eight_ranks["rel"]
    assert eight_ranks["mean_rel"] < 0.02, eight_ranks["mean_rel"]


# ------------------------------------------------------------ annotate


def test_annotate_is_the_identity_without_a_mesh():
    annotate.clear_mesh()
    x = torch.randn(4, 8, 16)
    assert annotate.get_mesh() is None
    assert annotate.data_axes() == () and annotate.model_axes() == ()
    assert annotate.constrain(x, ("data",), "model", None) is x
    assert annotate.constrain(x, None) is x       # no rank check, as JAX
    assert annotate.constrain_batch(x) is x


def test_annotate_leaves_a_plain_tensor_alone_under_a_mesh():
    stand_in = port_stand_in(("data", "model"), (2, 4))
    annotate.set_mesh(stand_in)
    try:
        x = torch.randn(4, 8, 16)
        assert annotate.data_axes() == ("data",)
        assert annotate.model_axes() == ("model",)
        assert annotate.constrain(x, ("data",), "model", None) is x
        assert annotate.constrain_batch(x) is x
        with pytest.raises(ValueError):
            annotate.constrain(x, None)
    finally:
        annotate.clear_mesh()


def test_the_lm_step_is_unchanged_by_annotate_without_a_mesh():
    """The call sites (``transformer._layer_fn``, ``train_step``) are the
    identity without a mesh: one smoke step's loss is the same with
    ``annotate.constrain`` replaced by an identity."""
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    cfg = REGISTRY["internlm2-20b"].make_smoke_config()
    params = transformer.init_transformer(cfg, 0, device="cpu")
    opt_cfg = adamw.AdamWConfig()
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator(
    ).manual_seed(0))
    step = make_train_step(
        lambda p, t, l: transformer.loss_fn(p, t, l, cfg), opt_cfg)
    _, _, m1 = step(params, adamw.init(params, opt_cfg), toks, toks)
    orig = annotate.constrain
    annotate.constrain = lambda x, *a: x
    try:
        _, _, m2 = step(params, adamw.init(params, opt_cfg), toks, toks)
    finally:
        annotate.constrain = orig
    assert m1["loss"].item() == m2["loss"].item()


# ------------------------------------------------------------ roofline


def test_roofline_terms_on_hand_made_counts():
    cost = {"flops": port_mesh.PEAK_FLOPS_BF16 * 2.0,
            "bytes accessed": port_mesh.HBM_BW * 0.5}
    coll = {"all-reduce": int(port_mesh.ICI_BW * 0.25), "all-gather": 0}
    t = roofline.roofline_terms(cost, coll, 256)
    j = jax_roofline.roofline_terms(cost, coll, 256)
    assert set(t) == set(j)
    assert t["t_compute"] == pytest.approx(2.0)
    assert t["t_memory"] == pytest.approx(0.5)
    assert t["t_collective"] == pytest.approx(0.25)
    assert t["dominant"] == "compute" and t["n_chips"] == 256
    t = roofline.roofline_terms({"flops": 1.0, "bytes accessed": 1e12},
                                {"all-gather": 1e9}, 8)
    assert t["dominant"] == "memory"
    t = roofline.roofline_terms({}, {"all-to-all": 1e12}, 8)
    assert t["dominant"] == "collective" and t["flops"] == 0.0
    assert roofline.model_flops(10, 7) == jax_roofline.model_flops(10, 7)


def test_the_card_rates():
    """The H100 SXM 80GB's published rates, one copy for the port."""
    assert port_mesh.PEAK_FLOPS_BF16 == 989e12
    assert port_mesh.HBM_BW == 3.35e12
    assert port_mesh.ICI_BW == 450e9
