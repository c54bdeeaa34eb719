"""Quickstart: losslessly summarize a dynamic graph stream with MoSSo.

Port of ``examples/quickstart.py`` on the port's own Tier-A reference
(host Python, no device): the same stream, seeds and lines.

Run:  PYTHONPATH=src python -m repro_torch.launch.quickstart
"""
from __future__ import annotations

from repro_torch.core.reference import MoSSo
from repro_torch.graph.streams import edges_to_fully_dynamic_stream, sbm_edges


def main() -> None:
    # 1. a fully dynamic stream: insertions + deletions (Sect. 2.1)
    edges = sbm_edges(60, 4, 0.6, 0.02, seed=1)
    stream = edges_to_fully_dynamic_stream(edges, delete_prob=0.1, seed=2)
    print(f"stream: {len(stream)} changes "
          f"({sum(1 for c in stream if not c[2])} deletions)")

    # 2. incremental lossless summarization (Alg. 1)
    algo = MoSSo(seed=0, c=40, escape=0.2)
    algo.run(stream)

    print(f"phi = |P|+|C+|+|C-| = {algo.s.phi}  vs  |E| = "
          f"{algo.s.num_edges}")
    print(f"compression ratio (Eq. 3): {algo.s.compression_ratio():.3f}")
    print(f"trials: {algo.stats.trials}, accepted: {algo.stats.accepted}, "
          f"escapes: {algo.stats.escapes}")

    # 3. the summary is queryable (Lemma 1): neighborhoods straight from
    # (G*, C)
    some_node = next(iter(algo.s.n2s))
    print(f"N({some_node}) from the summary: "
          f"{sorted(algo.s.neighbors(some_node))}")

    # 4. and lossless: decoding recovers the exact current snapshot
    out = algo.s.materialize()
    decoded = out.decode_edges()
    truth = set()
    for (u, v, ins) in stream:
        e = (min(u, v), max(u, v))
        truth.add(e) if ins else truth.discard(e)
    if decoded != truth:
        raise SystemExit("lossless decoding failed!")
    print(f"decoded {len(decoded)} edges == ground truth: lossless ✓")
    print(f"summary graph: {len(out.supernodes)} supernodes, "
          f"{len(out.superedges)} superedges, |C+|={len(out.c_plus)}, "
          f"|C-|={len(out.c_minus)}")


if __name__ == "__main__":
    main()
