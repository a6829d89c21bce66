"""Paged-KV decode serving of the PyTorch port (``BertDecoder`` +
``DecodeEngine``) against the JAX package, on the CPU at the JAX decode
tests' small config (vocab 512, hidden 64, 2 heads, FFN 128, 2 layers,
block 4, max_seq_len 32): the weights of one JAX engine are carried into
every port engine by name (``DecodeEngine.set_params``), and the port's
tokens must equal the JAX engine's and the port's own
``greedy_reference``, token for token, for a lone sequence, co-batched
mixed lengths, churn with block reuse behind a full pool, an EOS stop
that frees blocks, prefix-cache hits and eviction, chunked prefill of a
long prompt and chain lengths (1, 4).  One JAX engine answers every
prompt once (its tokens do not depend on scheduling: that is its own
contract, held by tests/test_decode.py); each port scenario builds its
own engine.  Also: the programs are desc for desc the JAX package's,
sampling is deterministic across submission orders with greedy rows
unchanged, and what the port does not run is refused by name."""

import ast
import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu.framework.serialization import program_to_desc as jdesc
from paddle_tpu.models.bert import BertConfig as JConfig
from paddle_tpu.models.decoder import BertDecoder as JDecoder
from paddle_tpu.serving import DecodeConfig as JDecodeConfig
from paddle_tpu.serving import DecodeEngine as JDecodeEngine
from paddle_tpu.serving.decode import _PrefixIndex as JPrefixIndex

from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.framework.errors import (InvalidArgumentError,
                                               UnavailableError,
                                               UnimplementedError)
from paddle_tpu_torch.framework.serialization import program_to_desc as tdesc
from paddle_tpu_torch.models import BertDecoder
from paddle_tpu_torch.models.bert import BertConfig
from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine
from paddle_tpu_torch.serving.decode import _PrefixIndex

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=2, intermediate_size=128,
              max_position_embeddings=64, type_vocab_size=2,
              initializer_range=0.5)
SEED = 3
MAX_NEW = 16          # what the JAX engine generates for every prompt


def _config(**kw):
    base = dict(block_size=4, max_seq_len=32, max_batch_size=4,
                prefill_seq_buckets=(8, 16), prefill_batch_buckets=(1, 2),
                pack_max_segments=2, max_new_tokens=6)
    base.update(kw)
    return base


def _prompts(lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, (n,)).astype(np.int64) for n in lens]


# every prompt a scenario below submits, by name
PROMPTS = {
    "lone": _prompts([5], 42),
    "cobatch": _prompts([3, 7, 9, 12], 1),
    "churn": _prompts([6, 9, 5], 2),
    "eos": _prompts([6], 9),
    "prefix": _prompts([9], 11) + _prompts([16, 16], 9),
    "chunk": _prompts([20, 5, 18], 21),
    "chains": _prompts([5, 9, 3, 6, 11], 7),
}


@pytest.fixture(scope="module")
def reference():
    """The JAX engine's tokens for every prompt (up to MAX_NEW, or what
    max_seq_len leaves), and its parameters as numpy arrays."""
    engine = JDecodeEngine(JDecoder(JConfig(**WIDTHS), seed=SEED),
                           JDecodeConfig(**_config(chain_lengths=(1, 4),
                                                   chunk_tokens=8)))
    try:
        futs = {}
        for name, prompts in PROMPTS.items():
            for i, p in enumerate(prompts):
                futs[name, i] = engine.generate(
                    {"src_ids": p}, max_new_tokens=min(MAX_NEW,
                                                       32 - len(p)))
        tokens = {k: f.result(timeout=600).tokens for k, f in futs.items()}
        # the engine's host snapshot of its weights (its live scope's
        # buffers are donated to its prepared steps)
        params = {n: np.asarray(engine._ref_scope.find_var(n))
                  for n in engine._ref_scope.var_names()
                  if engine._programs.startup.global_block().has_var(n)}
    finally:
        engine.shutdown()
    return tokens, params


@pytest.fixture(autouse=True)
def _fresh_counts():
    registry.reset_route_counts()
    port_cuda.reset_launch_counts()
    yield
    assert not any(port_cuda.launch_counts().values())


def _engine(reference, **kw):
    engine = DecodeEngine(BertDecoder(BertConfig(**WIDTHS), seed=SEED),
                          DecodeConfig(**_config(**kw)), place=CPUPlace(),
                          auto_start=False)
    engine.set_params(reference[1])
    return engine.start()


def _check(engine, reference, name, i, result, max_new=None, eos=None):
    """The port engine's tokens against the JAX engine's (cut to max_new,
    or at the first eos) and the port's greedy_reference."""
    jax_tokens = reference[0][name, i][:max_new or len(result.tokens)]
    if eos is not None:
        cut = list(jax_tokens).index(eos) + 1
        jax_tokens = jax_tokens[:cut]
    ref = engine.greedy_reference({"src_ids": PROMPTS[name][i]},
                                  max_new_tokens=max_new or
                                  len(result.tokens), eos_token_id=eos)
    assert result.tokens.tolist() == jax_tokens.tolist()
    assert result.tokens.tolist() == ref.tokens.tolist()
    assert result.finish_reason == ref.finish_reason


def _run(engine, name, max_new, **kw):
    futs = [engine.generate({"src_ids": p}, max_new_tokens=max_new, **kw)
            for p in PROMPTS[name]]
    return [f.result(timeout=300) for f in futs]


def test_programs_are_desc_for_desc_the_jax_packages():
    build = dict(num_blocks=32, block_size=4, max_blocks_per_seq=8,
                 pack_max_segments=2, chain_lengths=(1, 4),
                 with_sampling=True, chunk_tokens=16)
    jp = JDecoder(JConfig(**WIDTHS), seed=SEED).build(**build)
    tp = BertDecoder(BertConfig(**WIDTHS), seed=SEED).build(**build)
    progs = ["prefill", "decode", "score", "chunk", "startup"]
    pairs = [(getattr(jp, n), getattr(tp, n)) for n in progs] + \
        [(jp.chains[n], tp.chains[n]) for n in (1, 4)]
    for a, b in pairs:
        assert json.dumps(jdesc(a), sort_keys=True, default=str) == \
            json.dumps(tdesc(b), sort_keys=True, default=str)
    assert tp.cache_vars == jp.cache_vars
    model = BertDecoder(BertConfig(**WIDTHS), seed=SEED)
    jmodel = JDecoder(JConfig(**WIDTHS), seed=SEED)
    assert model.cache_layout_key(4) == jmodel.cache_layout_key(4)
    assert model.cache_block_bytes(4) == jmodel.cache_block_bytes(4)


def test_lone_sequence(reference):
    engine = _engine(reference)
    try:
        (res,) = _run(engine, "lone", 6)
        _check(engine, reference, "lone", 0, res, 6)
        assert res.prompt_len == 5 and res.finish_reason == "length"
    finally:
        engine.shutdown()


def test_cobatched_mixed_lengths(reference):
    engine = _engine(reference)
    try:
        results = _run(engine, "cobatch", 6)
        for i, res in enumerate(results):
            _check(engine, reference, "cobatch", i, res, 6)
        # they shared decode chains
        assert any(k >= 2 for k in engine.stats()["decode_batch_hist"])
    finally:
        engine.shutdown()


def test_churn_block_reuse_behind_a_full_pool(reference):
    """A pool of ~1.5 sequences: later arrivals wait for retirements and
    decode into freed blocks, and still match token for token."""
    engine = _engine(reference, pool_blocks=10)
    try:
        results = _run(engine, "churn", 16)
        stats = engine.stats()
        for i, res in enumerate(results):
            _check(engine, reference, "churn", i, res, 16)
        assert stats["admission_waits"] >= 1
        assert stats["block_reuses"] >= 1
        assert stats["cache_blocks_used"] == 0
    finally:
        engine.shutdown()


def test_eos_early_stop_frees_blocks(reference):
    engine = _engine(reference)
    try:
        eos = int(reference[0]["eos", 0][1])     # stop at the second token
        (res,) = _run(engine, "eos", 8, eos_token_id=eos)
        _check(engine, reference, "eos", 0, res, 8, eos=eos)
        assert res.finish_reason == "eos" and res.tokens[-1] == eos
        assert len(res.tokens) == list(reference[0]["eos", 0]).index(eos) + 1
        engine.drain()
        assert engine.stats()["cache_blocks_used"] == 0
    finally:
        engine.shutdown()


def test_prefix_cache_hits_refcounts_and_eviction(reference):
    """A repeat prompt hits the indexed blocks and prefills only its
    suffix (through the chunk program); after an EOS retire the refcounts
    are back to 0; in a 6-block pool a different 16-token prompt evicts
    the refcount-0 blocks instead of waiting."""
    engine = _engine(reference, pool_blocks=6)
    try:
        p9 = PROMPTS["prefix"][0]
        eos = int(reference[0]["prefix", 0][0])
        first = engine.generate({"src_ids": p9}, max_new_tokens=4,
                                eos_token_id=eos).result(timeout=300)
        engine.drain()
        s0 = engine.stats()
        again = engine.generate({"src_ids": p9}, max_new_tokens=4,
                                eos_token_id=eos).result(timeout=300)
        engine.drain()
        s1 = engine.stats()
        _check(engine, reference, "prefix", 0, first, 4, eos=eos)
        assert again.tokens.tolist() == first.tokens.tolist()
        assert s0["prefix_indexed_blocks"] == 2           # (9 - 1) // 4
        assert s1["prefix_hits"] - s0["prefix_hits"] == 2
        assert s1["prefill_tokens"] - s0["prefill_tokens"] == 1
        assert s1["chunk_steps"] == 1
        assert s0["cache_blocks_used"] == s1["cache_blocks_used"] == 0
        a, b = (engine.generate({"src_ids": p}, max_new_tokens=4)
                .result(timeout=300) for p in PROMPTS["prefix"][1:])
        engine.drain()
        s2 = engine.stats()
        _check(engine, reference, "prefix", 1, a, 4)
        _check(engine, reference, "prefix", 2, b, 4)
        assert s2["prefix_evictions"] >= 3
        assert s2["admission_waits"] == 0
        assert s2["cache_blocks_used"] == 0
    finally:
        engine.shutdown()


def test_prefix_index_matches_the_jax_one():
    """Keys are the JAX package's (sha256 of the layout key and the exact
    prefix), and an index entry anybody references is never evicted."""
    layout = BertDecoder(BertConfig(**WIDTHS), seed=SEED).cache_layout_key(4)
    idx = _PrefixIndex(layout, 4, 128)
    jidx = JPrefixIndex(layout, 4, 128)
    p = PROMPTS["cobatch"][3]
    assert [idx._key(p, j) for j in range(3)] == \
        [jidx._key(p, j) for j in range(3)]
    assert idx.promote(p, 0, 5) and idx.promote(p, 1, 6)
    assert not idx.promote(p, 0, 7)       # a racing twin stays private
    idx.release_block(5)
    idx.release_block(6)
    assert idx.evictable() == 2
    assert idx.probe(p, 9) == [5, 6]
    assert idx.evict_one() is None        # both referenced again
    idx.release_block(6)
    assert idx.evict_one() == 6 and idx.contains_block(5)
    idx.release_block(5)
    assert idx.evict_one() == 5 and len(idx) == 0


def test_chunked_prefill_of_a_long_prompt(reference):
    """A prompt longer than the largest prefill bucket streams in 4-token
    chunks (one per round, interleaved with a live decode) and still
    matches; only the final chunk syncs a token to the host."""
    engine = _engine(reference, chunk_tokens=4)
    try:
        futs = [engine.generate({"src_ids": p}, max_new_tokens=n)
                for p, n in zip(PROMPTS["chunk"], (6, 8, 4))]
        results = [f.result(timeout=300) for f in futs]
        stats = engine.stats()
        for i, (res, n) in enumerate(zip(results, (6, 8, 4))):
            _check(engine, reference, "chunk", i, res, n)
        assert stats["chunk_steps"] == 5 + 5          # ceil(20/4), ceil(18/4)
        assert stats["prefill_tokens"] == 20 + 5 + 18
        assert stats["interleaved_rounds"] >= 1
    finally:
        engine.shutdown()


def test_chain_lengths_1_and_4(reference):
    """Chains of 1 and 4 steps: the same tokens, only configured lengths
    dispatched, one host fetch per chain."""
    engine = _engine(reference, chain_lengths=(1, 4))
    try:
        results = _run(engine, "chains", 9)
        stats = engine.stats()
        for i, res in enumerate(results):
            _check(engine, reference, "chains", i, res, 9)
        assert set(stats["chain_hist"]) <= {1, 4} and 4 in stats[
            "chain_hist"]
        assert stats["decode_steps"] == \
            sum(k * v for k, v in stats["chain_hist"].items())
        assert stats["chain_tokens"] == 5 * (9 - 1)
        assert stats["host_syncs"] == stats["chains_run"] + \
            stats["prefill_batches"]
        assert stats["host_syncs"] < stats["chain_tokens"]
    finally:
        engine.shutdown()


def test_sampling_is_deterministic_across_orders(reference):
    """Fixed-seed sampling requests draw the same tokens whichever order
    (and so batch rows) they are submitted in; a greedy request beside
    them keeps its greedy tokens; another seed draws another stream."""
    engine = _engine(reference, chain_lengths=(4,), sampling=True)
    try:
        (p,) = PROMPTS["lone"]
        kw = dict(max_new_tokens=9, temperature=0.9, top_k=8, top_p=0.9)
        reqs = [dict(), dict(seed=123, **kw), dict(seed=321, **kw),
                dict(seed=5, temperature=1.5, max_new_tokens=9)]

        def run(order):
            futs = {i: engine.generate(
                {"src_ids": p}, **dict({"max_new_tokens": 9}, **reqs[i]))
                for i in order}
            return {i: f.result(timeout=300).tokens.tolist()
                    for i, f in futs.items()}

        one, two = run([0, 1, 2, 3]), run([3, 2, 1, 0])
        assert one == two
        assert one[0] == reference[0]["lone", 0][:9].tolist()
        assert one[1] != one[2]
    finally:
        engine.shutdown()


def test_what_is_not_ported_is_refused_by_name(monkeypatch, reference):
    # the MoE decoder is ported (tests/test_torch_moe.py)
    # a memory budget sizes the pool (memory_analysis.plan_cache_pool)
    model = BertDecoder(BertConfig(**WIDTHS), seed=SEED)
    sized = DecodeEngine(model, DecodeConfig(**_config(hbm_budget_gb=0.5)),
                         place=CPUPlace(), auto_start=False)
    assert sized.pool_plan["blocks"] >= sized.config.max_blocks_per_seq
    sized.shutdown()
    engine = _engine(reference)
    try:
        with pytest.raises(InvalidArgumentError, match="sampling"):
            engine.generate({"src_ids": PROMPTS["lone"][0]}, temperature=0.7)
        with pytest.raises(InvalidArgumentError, match="already serving"):
            engine.set_params(reference[1])
        assert "compile_count" not in engine.stats()
    finally:
        engine.shutdown()
    # a request that can never fit the pool is rejected before it queues
    engine = _engine(reference, pool_blocks=4)
    try:
        with pytest.raises(InvalidArgumentError, match="8 cache blocks"):
            engine.generate({"src_ids": PROMPTS["prefix"][1]},
                            max_new_tokens=16)
        assert engine.stats()["rejected"] == 1
    finally:
        engine.shutdown()
    # the engine's default place is the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(UnavailableError, match="no CUDA device"):
        DecodeEngine(model, DecodeConfig(**_config()), auto_start=False)


def test_the_new_modules_import_neither_jax_nor_the_jax_package():
    new = ["ops/cache_ops.py", "ops/sampling_ops.py", "models/decoder.py",
           "serving/decode.py"]
    for rel in new:
        path = os.path.join(REPO, "paddle_tpu_torch", rel)
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = [a.name for a in node.names] if isinstance(
                node, ast.Import) else [node.module or ""] if isinstance(
                node, ast.ImportFrom) and node.level == 0 else []
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "paddle_tpu"), (rel, name)
