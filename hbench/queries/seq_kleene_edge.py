"""A ``seq_kleene_edge`` configuration as the system under test takes it:
the ``seq_kleene`` queries ``SEQ(H, K+)``, each with the same-type edge
predicates of its ``edge_preds`` on the Kleene type (the port's
``EdgePred``: ``predecessor.attr OP successor.attr`` between consecutive
Kleene events of one graphlet)."""

from __future__ import annotations

import dataclasses

from hbench.queries import seq_kleene


def workload(cfg: dict):
    from repro_torch.core.query import EdgePred, Workload

    wl = seq_kleene.workload(cfg)
    queries = []
    for q, spec in zip(wl.queries, cfg["queries"]):
        edge: dict = {}
        for p in spec.get("edge_preds", []):
            edge.setdefault(p["type"], []).append(EdgePred(p["attr"], p["op"]))
        queries.append(dataclasses.replace(q, edge_preds=edge or None))
    return Workload(wl.schema, queries)
