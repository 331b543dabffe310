"""The port's token serving engine and serve launcher, on the CPU.

* the twins of ``tests/test_serve.py`` on the port's ``ServeEngine``
  (h2o-danube's smoke config in float32): the queue drains, EOS stops a
  request early, and batched generation equals sequential runs;
* greedy tokens equal to the JAX ``ServeEngine``'s for the same prompts
  and weights (carried across with ``interop.lm_params_from``):
  h2o-danube's smoke config, and gemma2's (window 8) with prompts longer
  than the window, so that every local layer's ring wraps.  Tokens are
  held exactly: float32 logits over 256 entries agree to ~1e-6 here;
* temperature sampling from the engine's ``torch.Generator``: the same
  ``seed`` gives the same tokens, every token lies in the vocabulary;
* ``python -m repro_torch.launch.serve --smoke --device cpu`` for every
  architecture; the engine and the launcher default to the card.
"""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as jax_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models.lm import init_params
from repro.serve import ServeEngine as RefEngine
from repro_torch import interop
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch import serve as launch_serve
from repro_torch.models import LM
from repro_torch.serve import ServeEngine

CPU = torch.device("cpu")


def models(arch, seed=0):
    """The reference's (cfg, params) and the port's model, same weights."""
    jcfg = replace(jax_reduce(jax_config(arch)), dtype="float32")
    params = init_params(jcfg, jax.random.PRNGKey(seed))
    cfg = replace(reduce_for_smoke(get_config(arch)), dtype="float32")
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return jcfg, params, interop.lm_params_from(cfg, tree, device=CPU)


@pytest.fixture(scope="module")
def danube():
    return models("h2o-danube-1.8b")


@pytest.fixture(scope="module")
def setup(danube):
    return danube[2]


def test_serve_batch_drains_queue(setup):
    eng = ServeEngine(setup, max_batch=3, device="cpu")
    rng = np.random.default_rng(0)
    rids = [eng.submit(rng.integers(0, setup.cfg.vocab, rng.integers(3, 9)),
                       max_new=5) for _ in range(7)]
    stats = eng.run()
    assert stats["requests"] == 7 and stats["tokens"] == 35
    for rid in rids:
        assert len(eng.completed[rid].tokens) == 5
    assert stats["tok_per_s"] > 0 and stats["mean_ttft_s"] > 0


def test_serve_eos_stops_early(setup):
    eng = ServeEngine(setup, max_batch=2, device="cpu")
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, setup.cfg.vocab, 6)
    # discover the greedy first token, then use it as "EOS"
    rid0 = eng.submit(prompt, max_new=4)
    eng.run()
    first = eng.completed[rid0].tokens[0]
    eng2 = ServeEngine(setup, max_batch=2, device="cpu")
    rid = eng2.submit(prompt, max_new=8, eos_id=int(first))
    eng2.run()
    assert eng2.completed[rid].tokens[0] == first
    assert len(eng2.completed[rid].tokens) == 1  # stopped at EOS


def test_serve_batched_equals_sequential(setup):
    """Same-length prompts: batching must not change greedy outputs."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, setup.cfg.vocab, 7) for _ in range(3)]

    seq_out = []
    for p in prompts:
        eng = ServeEngine(setup, max_batch=1, device="cpu")
        rid = eng.submit(p, max_new=6)
        eng.run()
        seq_out.append(eng.completed[rid].tokens)

    eng = ServeEngine(setup, max_batch=3, device="cpu")
    rids = [eng.submit(p, max_new=6) for p in prompts]
    eng.run()
    for rid, want in zip(rids, seq_out):
        assert eng.completed[rid].tokens == want


@pytest.mark.parametrize("arch,lengths,max_new", [
    ("h2o-danube-1.8b", (3, 8, 5, 6, 4), (5, 3, 6, 5, 2)),
    ("gemma2-2b", (12, 20, 9, 15), (6, 4, 7, 5)),     # window 8: rings wrap
])
def test_greedy_tokens_equal_reference(arch, lengths, max_new, danube):
    jcfg, params, model = danube if arch == "h2o-danube-1.8b" else \
        models(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab, n) for n in lengths]
    ref = RefEngine(jcfg, params, max_batch=3)
    eng = ServeEngine(model, max_batch=3, device="cpu")
    for p, m in zip(prompts, max_new):
        ref.submit(p, max_new=m)
        eng.submit(p, max_new=m)
    ref.run()
    stats = eng.run()
    assert stats["requests"] == len(prompts)
    for rid in range(len(prompts)):
        assert eng.completed[rid].tokens == ref.completed[rid].tokens, rid
        assert len(eng.completed[rid].tokens) == max_new[rid]


def test_temperature_sampling_is_seeded(setup):
    def sample(seed):
        eng = ServeEngine(setup, max_batch=2, temperature=1.0, seed=seed,
                          device="cpu")
        rng = np.random.default_rng(4)
        for _ in range(3):
            eng.submit(rng.integers(0, setup.cfg.vocab, 6), max_new=8)
        eng.run()
        return [eng.completed[r].tokens for r in range(3)]

    a, b, c = sample(7), sample(7), sample(8)
    assert a == b and a != c
    assert all(0 <= t < setup.cfg.vocab for toks in a for t in toks)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_smoke_on_the_host(arch, capsys):
    res = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "32",
                             "--gen", "4"])
    out = capsys.readouterr().out
    assert f"arch={arch} device=cpu generated (2, 4)" in out
    assert res["tokens"].shape == (2, 4) and res["finite"]
    assert len(res["decode_s"]) == 3
    assert ((0 <= res["tokens"]) & (res["tokens"] < 256)).all()


def test_engine_and_launcher_default_to_the_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(setup)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--smoke"])
    assert launch_serve.parse_args([]).device == "cuda"
    with pytest.raises(ValueError, match="lies on"):
        ServeEngine(LM(setup.cfg, device="meta"), device="cpu")
