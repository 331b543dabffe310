"""The port's sharing optimizer against the JAX package's, on the CPU.

``DynamicPolicy.decide_patterns`` takes each v1 decision in bulk (one
pattern matrix, every move of the classification, the pair seed and each
local-search sweep at once) where the reference walks affine costs one
comparison at a time.  Held against ``repro.core.optimizer.DynamicPolicy``:

* random coverage-pattern multisets for m in {2, 3, 10, 25, 64} candidates
  (unsorted query ids, codes past 60 bits as Python ints), 0-12 patterns,
  random ``b``, ``n`` and ``t``, and hand-made ties (equal-cost pairs, flips
  that gain nothing): equal groups, ``last_interval``, ``last_benefit``
  (value and type), ``decisions`` / ``split_bursts`` increments and memo
  entries, then the same at ``lo - 1``, ``lo``, ``hi`` and ``hi + 1`` of
  each recorded interval and on a replay from the memo;
* end to end at the ridesharing shape (25 queries ``SEQ(head, Travel+)``,
  every third with a ``speed`` predicate) on the torch backend: the audit
  log's decided groups, the sharing counters and every window result
  bitwise, with ``decide_evals`` counting the fresh evaluations.
"""

import random

import pytest

from benchmarks.common import kleene_workload
from repro.core.engine import HamletRuntime as RefRuntime
from repro.core.optimizer import DynamicPolicy as RefPolicy
from repro.obs import Observability as RefObservability
from repro.streams import generator as RG
from repro_torch import interop
from repro_torch.core.engine import HamletRuntime, vals_equal
from repro_torch.core.optimizer import DynamicPolicy
from repro_torch.launch.fig9 import HEADS
from repro_torch.obs import Observability


class _Stats:
    def __init__(self):
        self.decisions = self.split_bursts = self.decide_evals = 0


def _random_case(rng: random.Random, m: int) -> dict:
    cands = rng.sample(range(3 * m + 7), m)
    density = rng.choice((0.08, 0.25, 0.5, 0.9))
    codes = set()
    for _ in range(rng.randint(0, 12)):
        code = sum(1 << i for i in range(m) if rng.random() < density)
        codes.add(code or 1 << rng.randrange(m))
    patterns = tuple((c, rng.randint(1, 9)) for c in sorted(codes))
    events = sum(c for _, c in patterns)
    b = rng.randint(max(1, events), events + 40)
    n = rng.choice((rng.randint(0, b), rng.randint(b, 50 * b),
                    rng.randint(b, 10 ** 7)))
    return dict(patterns=patterns, candidates=cands, b=b, n=n,
                t=rng.randint(1, 4))


def _tie_cases() -> list:
    # four candidates, one pattern each of the same weight: every pair
    # costs the same, so the seed is the first pair in enumeration order
    eq = tuple((1 << i, 3) for i in range(4))
    # equal-weight overlapping patterns: pairs tie, and the first one the
    # seed takes decides the interval (the last one gives another)
    overlap = [(((13, 3), (58, 3), (61, 3)), 1, 48, 1),
               (((10, 1), (28, 1)), 2, 53, 3),
               (((23, 3), (50, 3)), 5, 12, 2)]
    # a descent through a lone member (k < 2: the flips are priced as
    # plans that share nothing)
    lone = [(((2, 1),), [4, 8], 2, 57, 3),
            (((1, 3), (2, 4), (5, 6), (12, 4)), [0, 1, 2, 3, 4], 2, 53, 3)]
    # one pattern covering every candidate: each flip leaves the union
    # as it is, so a sweep meets moves that gain nothing
    whole = (((1 << 6) - 1, 5),)
    return [dict(patterns=eq, candidates=[7, 3, 9, 1], b=12, n=n, t=2)
            for n in (0, 11, 12, 40, 1000)] + [
        dict(patterns=whole, candidates=[5, 0, 4, 1, 3, 2], b=b, n=n, t=t)
        for b, n, t in ((5, 5, 1), (5, 4, 3), (9, 123, 2), (1, 10, 1))] + [
        dict(patterns=pats, candidates=list(range(6)), b=b, n=n, t=t)
        for pats, b, n, t in overlap] + [
        dict(patterns=pats, candidates=c, b=b, n=n, t=t)
        for pats, c, b, n, t in lone] + [
        dict(patterns=(), candidates=list(range(20)), b=30, n=n, t=2)
        for n in (3, 29, 30, 5000)]


def _decide(pol, stats, case, n=None):
    return pol.decide_patterns(**dict(case, n=case["n"] if n is None else n),
                               stats=stats)


def _assert_same(case, n, local_search=True):
    """One fresh decision on each side, then a replay from the memo at
    the same n; returns the recorded interval."""
    ref, pol = RefPolicy(local_search=local_search), \
        DynamicPolicy(local_search=local_search)
    rs, ps = _Stats(), _Stats()
    for evals in (1, 0):
        want = _decide(ref, rs, case, n)
        got = _decide(pol, ps, case, n)
        tag = (case, n, evals)
        assert got == want, tag
        assert pol.last_interval == ref.last_interval, tag
        assert type(pol.last_benefit) is type(ref.last_benefit), tag
        assert pol.last_benefit == ref.last_benefit, tag
        assert pol.last_patterns == ref.last_patterns, tag
        assert (ps.decisions, ps.split_bursts) == \
            (rs.decisions, rs.split_bursts), tag
        assert ps.decide_evals == 1, tag
        assert list(pol._memo.items()) == list(ref._memo.items()), tag
    return ref.last_interval


CASES = ([pytest.param(("random", m, seed), id=f"m{m}-s{seed}")
          for m in (2, 3, 10, 25, 64) for seed in range(4)]
         + [pytest.param(("ties", 0, 0), id="ties"),
            pytest.param(("random", 10, 99), id="m10-no-local-search")])


@pytest.mark.parametrize("spec", CASES)
def test_decide_patterns_matches_reference(spec):
    kind, m, seed = spec
    if kind == "ties":
        cases = _tie_cases()
    else:
        rng = random.Random(1000 * m + seed)
        cases = [_random_case(rng, m) for _ in range(12)]
    local_search = seed != 99
    for case in cases:
        lo, hi = _assert_same(case, None, local_search)
        for n in (lo - 1, lo, hi, hi + 1):
            if isinstance(n, int):
                _assert_same(case, n, local_search)


def test_decide_evals_counts_fresh_evaluations():
    """v1 counts a memo miss and not a replay; v2 (unmemoized, scalar)
    counts every call and records no interval."""
    case = _random_case(random.Random(5), 10)
    for model, want in (("v1", 1), ("v2", 3)):
        pol, st = DynamicPolicy(model=model), _Stats()
        for _ in range(3):
            _decide(pol, st, case)
        assert (st.decide_evals, st.decisions) == (want, 3), model
        assert (pol.last_interval is None) == (model == "v2")


def test_decide_patterns_refuses_costs_past_int64():
    case = dict(patterns=((3, 4),), candidates=[0, 1], b=8, n=2 ** 62, t=1)
    with pytest.raises(OverflowError):
        _decide(DynamicPolicy(), _Stats(), case)


# ------------------------------------------- end to end: ridesharing shape


def _ridesharing(n_queries=25, epm=400, minutes=2):
    wl = kleene_workload(RG.RIDESHARING_SCHEMA, n_queries,
                         kleene_type="Travel", head_types=HEADS, within=60,
                         slide=15, pred_attr="speed")
    stream = RG.NAMED_STREAMS["ridesharing"](events_per_minute=epm,
                                             minutes=minutes, seed=7)
    t_end = ((int(stream.time.max()) + 15) // 15) * 15
    c = interop.stream_columns(stream)
    pst = interop.batch_from(
        interop.schema_from(c["types"], c["attr_names"]), c["type_id"],
        c["time"], c["attrs"], c["group"], c["seq"])
    return (wl, stream), (interop.workload_from(interop.workload_spec(wl)),
                          pst), t_end


@pytest.mark.parametrize("K", [1, 8])
def test_ridesharing_decisions_match_reference(K):
    (wl, stream), (pwl, pst), t_end = _ridesharing()
    ref_obs, obs = RefObservability(), Observability()
    ref_rt = RefRuntime(wl, obs=ref_obs, micro_batch=K)
    want = ref_rt.run(stream, t_end)
    rt = HamletRuntime(pwl, obs=obs, micro_batch=K, backend="torch",
                       device="cpu")
    got = rt.run(pst, t_end)
    assert want.keys() == got.keys() and want
    for k in want:
        assert vals_equal(got[k], want[k]), k
    dec = [(e.pane, e.el, e.candidates, e.decided)
           for e in obs.audit.entries()]
    assert dec and dec == [(e.pane, e.el, e.candidates, e.decided)
                           for e in ref_obs.audit.entries()]
    for f in ("decisions", "shared_bursts", "split_bursts"):
        assert getattr(rt.stats, f) == getattr(ref_rt.stats, f), f
    assert 0 < rt.stats.decide_evals <= rt.stats.decisions
    assert rt.stats.shared_bursts > 0
