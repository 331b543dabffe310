"""A ``seq_kleene_tail`` configuration as the system under test takes it:
the ``seq_kleene`` queries with their patterns completed to
``SEQ(H, K+, T)`` (a query with a ``tail``) or ``SEQ(H, K+, NOT N)`` (a
query with ``not_after``), each over its own ``within`` and ``slide``,
grouped by the configuration's ``group_by``."""

from __future__ import annotations

import dataclasses

from hbench.queries import seq_kleene


def workload(cfg: dict):
    from repro_torch.core.pattern import EventType, Kleene, Not, Seq
    from repro_torch.core.query import Workload

    wl = seq_kleene.workload(cfg)
    queries = []
    for q, spec in zip(wl.queries, cfg["queries"]):
        last = (EventType(spec["tail"]) if "tail" in spec
                else Not(EventType(spec["not_after"])))
        pattern = Seq(EventType(spec["head"]),
                      Kleene(EventType(spec["kleene"])), last)
        queries.append(dataclasses.replace(
            q, pattern=pattern, within=int(spec["within"]),
            slide=int(spec["slide"]),
            group_by=tuple(cfg.get("group_by", ()))))
    return Workload(wl.schema, queries)
