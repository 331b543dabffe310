"""A ``seq_kleene`` configuration as the system under test takes it: the
port's ``Workload`` of queries ``SEQ(H, K+)`` with the configuration's
aggregates, per-event predicates and window."""

from __future__ import annotations


def workload(cfg: dict):
    from repro_torch.core.events import StreamSchema
    from repro_torch.core.pattern import EventType, Kleene, Seq
    from repro_torch.core.query import (Pred, Query, Workload, agg_avg,
                                        agg_sum, count_star, count_type)

    schema = StreamSchema(types=tuple(cfg["schema"]["types"]),
                          attrs=tuple(cfg["schema"]["attrs"]))

    def agg(text: str):
        if text == "COUNT(*)":
            return count_star()
        kind, arg = text[:-1].split("(", 1)
        if kind == "COUNT":
            return count_type(arg)
        type_name, attr = arg.split(".", 1)
        return {"SUM": agg_sum, "AVG": agg_avg}[kind](type_name, attr)

    queries = []
    for q in cfg["queries"]:
        preds: dict = {}
        for p in q.get("preds", []):
            preds.setdefault(p["type"], []).append(
                Pred(p["attr"], p["op"], float(p["value"])))
        pattern = Seq(EventType(q["head"]), Kleene(EventType(q["kleene"])))
        queries.append(Query(
            q["name"], pattern,
            aggs=tuple(agg(a) for a in q["aggs"]), preds=preds or None,
            within=int(cfg["within"]), slide=int(cfg["slide"])))
    return Workload(schema, queries)
